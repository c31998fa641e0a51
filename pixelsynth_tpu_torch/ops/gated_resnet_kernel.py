"""K4: one whole gated resnet block in one kernel launch (port of
pixelsynth_tpu/ops/gated_resnet_pallas.py).

    x = pono(masked_conv_in(concat_elu(og)))
    x += nin_skip(concat_elu(a))          # only when a is given
    y = masked_conv_out(concat_elu(x))
    a', b' = split(y);  out = og + pono(a') * sigmoid(b')

`gated_resnet_kernel` launches csrc/gated_resnet.cu for CUDA tensors (one
cooperative launch, a grid barrier between the two convs; bf16 matmul
operands on wgmma, f32 elsewhere; the weights as the packed images of
ops/conv_pack.py: `PackedTaps` made once by the caller, or plain weights
packed at the call) and
takes `gated_resnet_plain` for CPU tensors.  On the card a call the K4
kernel does not take (float32 compute, or a shape it cannot hold:
`k4_route`) runs as the plain version runs it with both masked convs and
the nin skip (a one-tap conv) launches of K3 (`gated_resnet_k3`).  The
plain version follows the
TPU kernel (`_kernel`, :71-89) step by step: `_elu` as
where(x > 0, x, exp(min(x, 0)) - 1), `_pono` in its two-pass form with
ddof 1 and eps 1e-5, elementwise maths in f32 with only the dot operands
rounded to the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.conv_pack import TILE, TapsArg, prepare_taps, raw_taps
from pixelsynth_tpu_torch.ops.masked_conv import mask_rows
from pixelsynth_tpu_torch.ops.masked_conv_kernel import (
    MaskArg, _cdt, centre_mask, centre_taps, k3_layer_conv, masked_conv_taps,
    prepare_mask, raw_mask,
)

# launches of the kernel, calls of the "k3" route on the card (each three
# or two K3 launches, which K3 counts), and calls that took the plain
# version (CPU)
LAUNCHES = {"gated_resnet": 0, "gated_resnet_k3": 0}
PLAIN_CALLS = {"gated_resnet": 0}


def _elu(x):
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _concat_elu(x):
    return _elu(torch.cat([x, -x], dim=-1))


def _pono(x, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    n = x.shape[-1]
    var = ((x - mean) ** 2).sum(-1, keepdim=True) / (n - 1)
    return (x - mean) / torch.sqrt(var + eps)


def gated_resnet_plain(og, a, mask, w1, b1, w_skip, b_skip, w2, b2, *,
                       compute_dtype="bfloat16"):
    """og/a (B, H, W, F) (a may be None); mask (B, 9, H*W); w1 (9, 2F, F);
    w_skip (2F, F) or None; w2 (9, 2F, 2F).  Returns (B, H, W, F) f32."""
    B, H, W, Fc = og.shape
    cdt = _cdt(compute_dtype)
    w1, w2 = raw_taps(w1), raw_taps(w2)
    if a is not None:
        w_skip = raw_taps(w_skip).reshape(2 * Fc, Fc)
    og = og.float()
    m4 = mask_rows(raw_mask(mask), B, H, W).float()
    x = masked_conv_taps(_concat_elu(og), m4, w1, b1.float(), dilation=1, cdt=cdt)
    x = _pono(x)
    if a is not None:
        sk = _concat_elu(a.float()).to(cdt).float() @ w_skip.to(cdt).float()
        x = x + (sk + b_skip.float())
    y = masked_conv_taps(_concat_elu(x), m4, w2, b2.float(), dilation=1, cdt=cdt)
    return og + _pono(y[..., :Fc]) * torch.sigmoid(y[..., Fc:])


def k4_route(H: int, W: int, Fc: int, compute_dtype: str) -> str:
    """The route of a call on the card, by dtype and shape alone (never by
    a failure): "fused", the K4 kernel, for bfloat16 compute with
    H*W % 128 == 0, F % 16 == 0 and F <= 80; else "k3",
    `gated_resnet_k3`."""
    _cdt(compute_dtype)
    if compute_dtype == "bfloat16" and (H * W) % TILE == 0 and Fc % 16 == 0 and Fc <= 80:
        return "fused"
    return "k3"


def gated_resnet_k3(og, a, mask: MaskArg, w1: TapsArg, b1, w_skip: TapsArg,
                    b_skip, w2: TapsArg, b2, *, compute_dtype="bfloat16"):
    """`gated_resnet_plain` with each masked conv, and the nin skip as a
    centre-tap conv, a K3 call (`k3_layer_conv`)."""
    B, H, W, Fc = og.shape
    pm = prepare_mask(mask)
    og = og.float()

    def conv(h, m, w, b):
        return k3_layer_conv(h.contiguous(), m, w, b.float(), compute_dtype=compute_dtype)

    x = _pono(conv(_concat_elu(og), pm, w1, b1))
    if a is not None:
        ws = centre_taps(raw_taps(w_skip).reshape(2 * Fc, Fc))
        x = x + conv(_concat_elu(a.float()), centre_mask(B, H * W, og.device), ws, b_skip)
    y = conv(_concat_elu(x), pm, w2, b2)
    return og + _pono(y[..., :Fc]) * torch.sigmoid(y[..., Fc:])


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _cuda.load("gated_resnet")
    if not getattr(lib, "_typed", False):
        lib.gated_resnet.argtypes = [_P] * 13 + [_I] * 4 + [_P]
        lib.gated_resnet.restype = _I
        lib._typed = True
    return lib


def gated_resnet_kernel(og, a, mask: MaskArg, w1: TapsArg, b1, w_skip: TapsArg,
                        b_skip, w2: TapsArg, b2, *,
                        compute_dtype: str = "bfloat16"):
    """K4.  og (B, H, W, F) f32; a the same or None (then w_skip/b_skip are
    not read and no skip term is added); mask (B, 9, H*W) or a
    PreparedMask; conv weights w1 (9, 2F, F), w_skip (2F, F), w2
    (9, 2F, 2F) in any float dtype, or their PackedTaps (w_skip packed as
    (1, 2F, F)); biases f32.  Returns (B, H, W, F) f32: one launch, or on
    the "k3" route (`k4_route`) K3 launches.  Inference only."""
    if not og.is_cuda:
        PLAIN_CALLS["gated_resnet"] += 1
        return gated_resnet_plain(og, a, mask, w1, b1, w_skip, b_skip, w2, b2,
                                  compute_dtype=compute_dtype)
    if torch.is_grad_enabled() and (og.requires_grad or raw_taps(w1).requires_grad):
        raise ValueError("K4 serves inference only: no gradient")
    B, H, W, Fc = og.shape
    HW = H * W
    dev = og.device
    if raw_taps(w1).shape[0] != 9:
        raise ValueError(f"K4 and K3 take 3x3 taps, got {raw_taps(w1).shape[0]}")
    if k4_route(H, W, Fc, compute_dtype) == "k3":
        out = gated_resnet_k3(og, a, mask, w1, b1, w_skip, b_skip, w2, b2,
                              compute_dtype=compute_dtype)
        LAUNCHES["gated_resnet_k3"] += 1
        return out
    pm = prepare_mask(mask)
    f32, bf = torch.float32, torch.bfloat16
    _cuda.require(og, "og", dtype=f32, shape=(B, H, W, Fc))
    _cuda.require(pm.rows, "mask", dtype=f32, shape=(B, HW, 9), device=dev)
    _cuda.require(pm.taps, "mask table", dtype=torch.int32,
                  shape=(B, HW // TILE, 9), device=dev)

    def image(w, name, shape):
        raw = raw_taps(w)
        if raw.dim() == 2:
            raw = w = raw[None]
        if tuple(raw.shape) != shape or raw.device != dev:
            raise ValueError(f"{name}: shape {tuple(raw.shape)} on {raw.device}, "
                             f"expected {shape} on {dev}")
        return prepare_taps(w, Fc).image

    w1k = image(w1, "w1", (9, 2 * Fc, Fc))
    w2k = image(w2, "w2", (9, 2 * Fc, 2 * Fc))
    _cuda.require(b1, "b1", dtype=f32, shape=(Fc,), device=dev)
    _cuda.require(b2, "b2", dtype=f32, shape=(2 * Fc,), device=dev)
    P = _cuda.ptr
    null = ctypes.c_void_p(None)
    if a is not None:
        wsk = image(w_skip, "w_skip", (1, 2 * Fc, Fc))
        _cuda.require(a, "a", dtype=f32, shape=(B, H, W, Fc), device=dev)
        _cuda.require(b_skip, "b_skip", dtype=f32, shape=(Fc,), device=dev)
        skip = (P(a), P(wsk), P(b_skip))
    else:
        skip = (null, null, null)
    out = torch.empty_like(og)
    ue, xe = torch.empty((2, B, HW, 2 * Fc), dtype=bf, device=dev)
    rc = _lib().gated_resnet(
        P(og), skip[0], P(pm.rows), P(pm.taps), P(w1k), P(b1), skip[1], skip[2], P(w2k),
        P(b2), P(out), P(ue), P(xe), B, H, W, Fc, _cuda.stream_of(og))
    _cuda.check(rc, "gated_resnet")
    LAUNCHES["gated_resnet"] += 1
    return out
