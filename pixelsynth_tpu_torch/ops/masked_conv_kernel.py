"""K3: the locally masked convolution as a hand-written CUDA kernel (port of
pixelsynth_tpu/ops/masked_conv_pallas.py).

  out[p] = sum_t m_t[p] * (x[p + o_t] @ W_t) + b

`locally_masked_conv2d_kernel` launches csrc/masked_conv.cu for CUDA
tensors (bf16 operands on the tensor cores, or the float32 kernel on the
CUDA cores) and takes `locally_masked_conv2d_plain` for CPU tensors.  The
plain version is the TPU kernel's per-tap form (`_kernel`, :32-48): pad,
shift, one (B*HW, Cin) @ (Cin, Cout) product per tap with operands rounded
to the compute dtype, scaled by the mask, accumulated in f32, plus bias.

`locally_masked_conv2d_kernel_vjp` is the differentiable entry (a
`torch.autograd.Function`, as `locally_masked_conv2d_pallas_vjp`, :95-152):
the kernel forward, and the backward of `_lmconv_bwd` (:110-149) in plain
PyTorch ops -- the JAX package has no backward kernel either.

The kernel reads the mask as (B, HW, 9) rows and, in bf16, requires {0, 1}
entries (a tap with mask 0 is not read at all).  `prepare_mask` makes that
layout and checks the entries once; a sampling loop prepares its masks
outside the loop and hands the `PreparedMask` to every call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.masked_conv import mask_rows, shifted_taps, tap_offsets

# launches of the CUDA kernel, and calls that took the plain version (CPU)
LAUNCHES = {"masked_conv": 0}
PLAIN_CALLS = {"masked_conv": 0}


class PreparedMask(NamedTuple):
    """A mask in the kernels' layout beside the one it came from."""

    rows: torch.Tensor   # (B, HW, k*k) f32, contiguous
    raw: torch.Tensor    # (B, k*k, HW)


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
    return PreparedMask(rows, mask)


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
        for fn in (lib.masked_conv_bf16, lib.masked_conv_f32):
            fn.argtypes = [_P] * 5 + [_I] * 6 + [_P]
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


def locally_masked_conv2d_kernel(x, mask: MaskArg, weight, bias=None, *,
                                 dilation: int = 1,
                                 compute_dtype: str = "bfloat16"):
    """K3.  x (B, H, W, Cin) f32; mask (B, 9, H*W) or a PreparedMask;
    weight (9, Cin, Cout) f32 (or already bf16 for compute_dtype
    bfloat16); bias (Cout) or None.  Returns (B, H, W, Cout) f32.  Not
    differentiable: see `locally_masked_conv2d_kernel_vjp`."""
    cdt = _cdt(compute_dtype)
    if not x.is_cuda:
        PLAIN_CALLS["masked_conv"] += 1
        return locally_masked_conv2d_plain(x, mask, weight, bias,
                                           dilation=dilation,
                                           compute_dtype=compute_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise ValueError("locally_masked_conv2d_kernel has no gradient: use "
                         "locally_masked_conv2d_kernel_vjp")
    B, H, W, Cin = x.shape
    K2, _, Cout = weight.shape
    HW = H * W
    dev = x.device
    if K2 != 9:
        raise ValueError(f"K3 takes 3x3 taps, got k*k = {K2}")
    pm = prepare_mask(mask)
    _cuda.require(pm.rows, "mask", dtype=torch.float32, shape=(B, HW, 9),
                  device=dev)
    if bias is None:
        bias = torch.zeros(Cout, dtype=torch.float32, device=dev)
    _cuda.require(bias, "bias", dtype=torch.float32, shape=(Cout,), device=dev)
    lib = _lib()
    if cdt == torch.bfloat16:
        if not kernel_width(Cin, Cout) or HW % 128:
            raise ValueError(
                f"the bf16 K3 kernel takes H*W % 128 == 0 and (Cin, Cout) each "
                f"F or 2F for one F % 16 == 0, F <= 80; got HW={HW}, "
                f"Cin={Cin}, Cout={Cout}")
        fn = lib.masked_conv_bf16
    else:
        if HW % 8 or Cout > 512 or Cin > 1536:
            raise ValueError(
                f"the f32 K3 kernel takes H*W % 8 == 0, Cin <= 1536 and "
                f"Cout <= 512; got HW={HW}, Cin={Cin}, Cout={Cout}")
        fn = lib.masked_conv_f32
    xk = x.to(cdt).contiguous()
    wk = weight.to(cdt).contiguous()
    _cuda.require(xk, "x", dtype=cdt, shape=(B, H, W, Cin))
    _cuda.require(wk, "weight", dtype=cdt, shape=(9, Cin, Cout), device=dev)
    out = torch.empty((B, H, W, Cout), dtype=torch.float32, device=dev)
    P = _cuda.ptr
    rc = fn(P(xk), P(pm.rows), P(wk), P(bias), P(out), B, H, W, Cin, Cout,
            int(dilation), _cuda.stream_of(x))
    _cuda.check(rc, "masked_conv")
    LAUNCHES["masked_conv"] += 1
    return out


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
    def forward(ctx, x, weight, bias, mask, dilation, compute_dtype):
        ctx.save_for_backward(x, weight)
        ctx.mask, ctx.dilation = mask, dilation
        with torch.no_grad():
            return locally_masked_conv2d_kernel(
                x, mask, weight, bias, dilation=dilation,
                compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dW, db = masked_conv_backward(g, x, ctx.mask, weight, ctx.dilation)
        return dx.to(x.dtype), dW.to(weight.dtype), db, None, None, None


def locally_masked_conv2d_kernel_vjp(x, mask: MaskArg, weight,
                                     bias: Optional[torch.Tensor],
                                     dilation: int = 1,
                                     compute_dtype: str = "bfloat16"):
    """Differentiable K3: the kernel forward with the plain backward."""
    if bias is None:
        bias = torch.zeros(weight.shape[-1], dtype=torch.float32,
                           device=x.device)
    return _MaskedConvFn.apply(x, weight, bias, mask, dilation, compute_dtype)
