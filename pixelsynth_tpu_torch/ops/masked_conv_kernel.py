"""K3: the locally masked convolution as a hand-written CUDA kernel (port of
pixelsynth_tpu/ops/masked_conv_pallas.py).

  out[p] = sum_t m_t[p] * (x[p + o_t] @ W_t) + b

`locally_masked_conv2d_kernel` launches csrc/masked_conv.cu for CUDA
tensors (bf16 operands on the tensor cores, or the float32 kernel on the
CUDA cores) and takes `locally_masked_conv2d_plain` for CPU tensors.  The
bf16 kernel reads x as f32 and rounds it to bf16 itself, so a call is one
device kernel.  Its route is chosen by the shape alone (`k3_route`): the
resident route, which keeps a tile's rows and halo in shared memory, where
they fit (every grid the port runs), else the streamed per-tap body; each
route has its own count in LAUNCHES.  The
plain version is the TPU kernel's per-tap form (`_kernel`, :32-48): pad,
shift, one (B*HW, Cin) @ (Cin, Cout) product per tap with operands rounded
to the compute dtype, scaled by the mask, accumulated in f32, plus bias.

`locally_masked_conv2d_kernel_vjp` is the differentiable entry (a
`torch.autograd.Function`, as `locally_masked_conv2d_pallas_vjp`, :95-152):
the kernel forward, and the backward of `_lmconv_bwd` (:110-149) in plain
PyTorch ops -- the JAX package has no backward kernel either.

The kernel reads the mask as (B, HW, 9) rows and, in bf16, requires {0, 1}
entries (a tap with mask 0 is not read at all).  `prepare_mask` makes that
layout, checks the entries once and builds the table of (128-position
tile, tap) pairs that have any position on (the bf16 kernels skip the
others whole); a sampling loop prepares its masks outside the loop and
hands the `PreparedMask` to every call.  The bf16 kernels read the weights
as the packed image of ops/conv_pack.py: a caller that holds its weights
hands in `PackedTaps` (made once); plain weights are packed at the call.
A call with a `PreparedMask` and `PackedTaps` is checked once: the checked
launch is kept on the mask (`PreparedMask.launches`) for the weights, bias,
shape and dtype it was made for, and later calls with the same ones reuse
it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Union

import torch

from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.conv_pack import (
    TILE, PackedTaps, TapsArg, prepare_taps, raw_taps, resident_rows_fit,
    tile_tap_table,
)
from pixelsynth_tpu_torch.ops.masked_conv import mask_rows, shifted_taps, tap_offsets

# launches of the CUDA kernels (the resident route and the float32 kernel;
# the streamed route), and calls that took the plain version (CPU)
LAUNCHES = {"masked_conv": 0, "masked_conv_streamed": 0}
PLAIN_CALLS = {"masked_conv": 0}


class PreparedMask(NamedTuple):
    """A mask in the kernels' layout beside the one it came from."""

    rows: torch.Tensor   # (B, HW, k*k) f32, contiguous
    raw: torch.Tensor    # (B, k*k, HW)
    # (B, HW // 128, k*k) int32, 1 where any position of the tile has the
    # tap on; None when HW is no multiple of 128 (no bf16 kernel takes it)
    taps: Optional[torch.Tensor] = None
    # checked launches of this mask on the card (`_Launch`), by weights,
    # bias, shape and dtype
    launches: Optional[Dict] = None


MaskArg = Union[torch.Tensor, PreparedMask]


def prepare_mask(mask: MaskArg) -> PreparedMask:
    """(B, k*k, HW) -> PreparedMask.  On the card the entries must be 0 or
    1 (one device->host read): the bf16 kernels skip a masked tap instead
    of scaling by it."""
    if isinstance(mask, PreparedMask):
        return mask
    rows = mask.float().transpose(1, 2).contiguous()
    if rows.is_cuda and not bool(((rows == 0) | (rows == 1)).all()):
        raise ValueError("mask entries must be 0 or 1 for the CUDA kernels")
    taps = tile_tap_table(rows) if rows.shape[1] % TILE == 0 else None
    return PreparedMask(rows, mask, taps, {})


def raw_mask(mask: MaskArg) -> torch.Tensor:
    return mask.raw if isinstance(mask, PreparedMask) else mask


def _cdt(compute_dtype: str) -> torch.dtype:
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: bfloat16 or float32")
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def masked_conv_taps(h, m4, w, b, *, dilation, cdt):
    """The per-tap masked conv on h (B, H, W, Cin) f32 with m4 (B, H, W, k2):
    operands rounded to cdt, f32 accumulation.  -> (B, H, W, Cout) f32."""
    K2 = w.shape[0]
    k = int(round(K2 ** 0.5))
    wf = w.to(cdt).float()
    acc = None
    for t, xs in enumerate(shifted_taps(h.to(cdt).float(), k, dilation)):
        z = m4[..., t:t + 1] * (xs @ wf[t])
        acc = z if acc is None else acc + z
    return acc + b


def locally_masked_conv2d_plain(x, mask, weight, bias=None, *, dilation=1,
                                compute_dtype="bfloat16"):
    """x (B, H, W, Cin); mask (B, k*k, H*W); weight (k*k, Cin, Cout).
    Returns (B, H, W, Cout) f32."""
    B, H, W, _ = x.shape
    cdt = _cdt(compute_dtype)
    weight = raw_taps(weight)
    if bias is None:
        bias = torch.zeros(weight.shape[-1], device=x.device)
    m4 = mask_rows(raw_mask(mask), B, H, W).to(cdt).float()
    return masked_conv_taps(x.float(), m4, weight, bias.float(),
                            dilation=dilation, cdt=cdt)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _cuda.load("masked_conv")
    if not getattr(lib, "_typed", False):
        lib.masked_conv_bf16.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.masked_conv_f32.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        lib.masked_conv_cluster.argtypes = []
        for fn in (lib.masked_conv_bf16, lib.masked_conv_f32, lib.masked_conv_cluster):
            fn.restype = _I
        lib._typed = True
    return lib


def kernel_width(cin: int, cout: int) -> int:
    """The layer width F the bf16 kernel runs (Cin, Cout) at: each of them
    F or 2F, F a multiple of 16 up to 80; 0 when it takes neither."""
    def ok(f):
        return f % 16 == 0 and 16 <= f <= 80

    if ok(cin) and cout in (cin, 2 * cin):
        return cin
    if cin % 2 == 0 and ok(cin // 2) and cout in (cin, cin // 2):
        return cin // 2
    return 0


def k3_route(H: int, W: int, cin: int, dilation: int, cluster: int = 1) -> str:
    """The bf16 kernel's route for a shape: "resident" where a tile's rows
    and halo of x fit the resident region and the candidate's 128-position
    tiles pair into the build's clusters (`cluster`: 1, or 2 in a
    K3_CLUSTER=2 build), else "streamed".  csrc/masked_conv.cu refuses a
    call whose route is not its own rule's (`route_of`); nothing else
    picks a route."""
    tiles = H * W // TILE
    if resident_rows_fit(W, dilation, cin) and tiles % cluster == 0:
        return "resident"
    return "streamed"


class _Launch(NamedTuple):
    """A checked bf16 or float32 launch: what a call passes besides x and
    out, and the objects it was checked for."""

    lib: object
    fn: object
    args: tuple          # ctypes pointers: mask rows[, tile table], weights, bias
    ints: tuple          # B, H, W, Cin, Cout, dilation[, route]
    counter: str         # the LAUNCHES entry of its route
    weight: object       # the weight argument (a PackedTaps or a tensor)
    bias: object         # the bias argument (None or a tensor)
    keep: tuple          # tensors the pointers point into


def _check_launch(lib, x, pm: PreparedMask, weight: TapsArg, bias, dilation: int,
                  cdt) -> _Launch:
    """Every check of a kernel call, once: shapes, devices, dtypes, the
    route.  Raises on what the kernels do not take."""
    raw = raw_taps(weight)
    B, H, W, Cin = x.shape
    K2, _, Cout = raw.shape
    HW = H * W
    dev = x.device
    if K2 != 9:
        raise ValueError(f"K3 takes 3x3 taps, got k*k = {K2}")
    if raw.shape[1] != Cin or raw.device != dev:
        raise ValueError(f"weight: shape {tuple(raw.shape)} on {raw.device}, "
                         f"expected (9, {Cin}, {Cout}) on {dev}")
    _cuda.require(pm.rows, "mask", dtype=torch.float32, shape=(B, HW, 9),
                  device=dev)
    b = bias
    if b is None:
        b = torch.zeros(Cout, dtype=torch.float32, device=dev)
    _cuda.require(b, "bias", dtype=torch.float32, shape=(Cout,), device=dev)
    P = _cuda.ptr
    if cdt == torch.bfloat16:
        if not kernel_width(Cin, Cout) or HW % TILE:
            raise ValueError(
                f"the bf16 K3 kernel takes H*W % 128 == 0 and (Cin, Cout) each "
                f"F or 2F for one F % 16 == 0, F <= 80; got HW={HW}, "
                f"Cin={Cin}, Cout={Cout}")
        wk = prepare_taps(weight, kernel_width(Cin, Cout)).image
        _cuda.require(pm.taps, "mask table", dtype=torch.int32,
                      shape=(B, HW // TILE, 9), device=dev)
        resident = k3_route(H, W, Cin, dilation, lib.masked_conv_cluster()) == "resident"
        args = (P(pm.rows), P(pm.taps), P(wk), P(b))
        ints = (B, H, W, Cin, Cout, int(dilation), int(resident))
        fn = lib.masked_conv_bf16
        counter = "masked_conv" if resident else "masked_conv_streamed"
        keep = (pm.rows, pm.taps, wk, b)
    else:
        if HW % 8 or Cout > 512 or Cin > 1536:
            raise ValueError(
                f"the f32 K3 kernel takes H*W % 8 == 0, Cin <= 1536 and "
                f"Cout <= 512; got HW={HW}, Cin={Cin}, Cout={Cout}")
        wk = raw.to(cdt).contiguous()
        args = (P(pm.rows), P(wk), P(b))
        ints = (B, H, W, Cin, Cout, int(dilation))
        fn = lib.masked_conv_f32
        counter = "masked_conv"
        keep = (pm.rows, wk, b)
    _cuda.require(wk, "weight", dtype=cdt, device=dev)
    return _Launch(lib, fn, args, ints, counter, weight, bias, keep)


def locally_masked_conv2d_kernel(x, mask: MaskArg, weight: TapsArg, bias=None, *,
                                 dilation: int = 1,
                                 compute_dtype: str = "bfloat16"):
    """K3.  x (B, H, W, Cin) f32; mask (B, 9, H*W) or a PreparedMask;
    weight (9, Cin, Cout), or its PackedTaps for compute_dtype bfloat16;
    bias (Cout) or None.  Returns (B, H, W, Cout) f32.  Not
    differentiable: see `locally_masked_conv2d_kernel_vjp`.  On the card
    a call with a PreparedMask and PackedTaps it has seen before does no
    checks but the launch's own."""
    cdt = _cdt(compute_dtype)
    if not x.is_cuda:
        PLAIN_CALLS["masked_conv"] += 1
        return locally_masked_conv2d_plain(x, mask, weight, bias,
                                           dilation=dilation,
                                           compute_dtype=compute_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or raw_taps(weight).requires_grad):
        raise ValueError("locally_masked_conv2d_kernel has no gradient: use "
                         "locally_masked_conv2d_kernel_vjp")
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    pm = prepare_mask(mask)
    lib = _lib()
    key = (id(weight), id(bias), tuple(x.shape), x.device, int(dilation), cdt)
    cache = pm.launches if pm.launches is not None else {}
    rec = cache.get(key)
    if rec is None or rec.lib is not lib or rec.weight is not weight or rec.bias is not bias:
        rec = _check_launch(lib, x, pm, weight, bias, dilation, cdt)
        # packed weights are the same image call after call (plain bf16
        # weights are packed anew at every call)
        if isinstance(weight, PackedTaps):
            if len(cache) > 256:
                cache.clear()
            cache[key] = rec
    B, H, W = x.shape[:3]
    out = torch.empty((B, H, W, rec.ints[4]), dtype=torch.float32, device=x.device)
    P = _cuda.ptr
    rc = rec.fn(P(x), *rec.args, P(out), *rec.ints, _cuda.stream_of(x))
    _cuda.check(rc, "masked_conv")
    LAUNCHES[rec.counter] += 1
    return out


def k3_dtype(HW: int, cin: int, cout: int, compute_dtype: str) -> str:
    """Which K3 kernel serves a conv of a layer stack that runs through K3
    (the "k3" routes of K1 and K4), by dtype and shape alone:
    "bfloat16" (the tensor-core kernel, whose route `k3_route` picks) for
    bf16 compute where that kernel takes the shape (H*W % 128 == 0 and
    `kernel_width`), else "float32" (the CUDA-core kernel; for bf16 compute
    `k3_layer_conv` rounds x and the weights to bf16 first, so it sums the
    same products in f32)."""
    _cdt(compute_dtype)
    if compute_dtype == "bfloat16" and HW % TILE == 0 and kernel_width(cin, cout):
        return "bfloat16"
    return "float32"


def k3_layer_conv(x, mask: MaskArg, weight: TapsArg, bias, *, dilation: int = 1,
                  compute_dtype: str = "bfloat16"):
    """One masked conv of a layer stack through K3's kernel of `k3_dtype`
    (on the card; the plain version on the CPU).  x (B, H, W, Cin) f32;
    weight (9, Cin, Cout) or its PackedTaps.  -> (B, H, W, Cout) f32."""
    B, H, W, Cin = x.shape
    kd = k3_dtype(H * W, Cin, raw_taps(weight).shape[-1], compute_dtype)
    if kd != compute_dtype:
        x = x.to(torch.bfloat16).float()
        weight = raw_taps(weight).to(torch.bfloat16).float()
    return locally_masked_conv2d_kernel(x, mask, weight, bias, dilation=dilation,
                                        compute_dtype=kd)


CENTRE = 4   # the centre tap of a 3x3 conv


def centre_mask(B: int, HW: int, device) -> PreparedMask:
    """The mask of a 1x1 product run as a masked conv: the centre tap on at
    every position, every other tap off (no ring step, no FMA for them)."""
    rows = torch.zeros((B, HW, 9), dtype=torch.float32, device=device)
    rows[..., CENTRE] = 1.0
    taps = tile_tap_table(rows) if HW % TILE == 0 else None
    return PreparedMask(rows, rows.transpose(1, 2), taps, {})


def centre_taps(w: torch.Tensor) -> torch.Tensor:
    """(Cin, Cout) weights of a 1x1 product -> (9, Cin, Cout) taps with w
    at the centre and zeros elsewhere."""
    taps = torch.zeros((9,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    taps[CENTRE] = w
    return taps


def masked_conv_backward(g, x, mask, weight, dilation: int):
    """(dx, dW, db) of out[p] = sum_t m_t[p] * (x[p + o_t] @ W_t) + b for the
    cotangent g (B, H, W, Cout), in f32 (`_lmconv_bwd`):
      dx[q] = sum_t (m_t * g)[q - o_t] @ W_t^T   (flipped taps on the
              mask-scaled cotangent);
      dW_t  = x_shift_t^T @ (m_t * g)            (nine shifted correlations);
      db    = sum_p g[p]."""
    B, H, W, Cin = x.shape
    K2 = weight.shape[0]
    k = int(round(K2 ** 0.5))
    m4 = mask_rows(raw_mask(mask), B, H, W).float()
    g = g.float()
    wf = weight.float()
    pad = (k // 2) * dilation
    dx = torch.zeros((B, H, W, Cin), dtype=torch.float32, device=x.device)
    dW = []
    xs = shifted_taps(x.float(), k, dilation)
    for t, (dr, dc) in enumerate(tap_offsets(k, dilation)):
        mg = g * m4[..., t:t + 1]                                # (B,H,W,Cout)
        mgp = torch.nn.functional.pad(mg, (0, 0, pad, pad, pad, pad))
        sl = mgp[:, pad - dr:pad - dr + H, pad - dc:pad - dc + W]
        dx = dx + sl @ wf[t].T
        dW.append(torch.einsum("bhwc,bhwo->co", xs[t], mg))
    return dx, torch.stack(dW), g.sum((0, 1, 2))


class _MaskedConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, dilation, compute_dtype, packed):
        ctx.save_for_backward(x, weight)
        ctx.mask, ctx.dilation = mask, dilation
        with torch.no_grad():
            return locally_masked_conv2d_kernel(
                x, mask, weight if packed is None else packed, bias,
                dilation=dilation, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dW, db = masked_conv_backward(g, x, ctx.mask, weight, ctx.dilation)
        return dx.to(x.dtype), dW.to(weight.dtype), db, None, None, None, None


def locally_masked_conv2d_kernel_vjp(x, mask: MaskArg, weight: TapsArg,
                                     bias: Optional[torch.Tensor],
                                     dilation: int = 1,
                                     compute_dtype: str = "bfloat16"):
    """Differentiable K3: the kernel forward with the plain backward (which
    reads the plain weights of a PackedTaps)."""
    raw = raw_taps(weight)
    if bias is None:
        bias = torch.zeros(raw.shape[-1], dtype=torch.float32, device=x.device)
    packed = weight if isinstance(weight, PackedTaps) else None
    return _MaskedConvFn.apply(x, raw, bias, mask, dilation, compute_dtype, packed)
