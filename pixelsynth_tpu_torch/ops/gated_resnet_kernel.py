"""K4: one whole gated resnet block in one kernel launch (port of
pixelsynth_tpu/ops/gated_resnet_pallas.py).

    x = pono(masked_conv_in(concat_elu(og)))
    x += nin_skip(concat_elu(a))          # only when a is given
    y = masked_conv_out(concat_elu(x))
    a', b' = split(y);  out = og + pono(a') * sigmoid(b')

`gated_resnet_kernel` launches csrc/gated_resnet.cu for CUDA tensors (one
cooperative launch, a grid barrier between the two convs; bf16 matmul
operands, f32 elsewhere) and
takes `gated_resnet_plain` for CPU tensors.  The plain version follows the
TPU kernel (`_kernel`, :71-89) step by step: `_elu` as
where(x > 0, x, exp(min(x, 0)) - 1), `_pono` in its two-pass form with
ddof 1 and eps 1e-5, elementwise maths in f32 with only the dot operands
rounded to the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.masked_conv import mask_rows
from pixelsynth_tpu_torch.ops.masked_conv_kernel import (
    MaskArg, _cdt, masked_conv_taps, prepare_mask, raw_mask,
)

LAUNCHES = {"gated_resnet": 0}
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
    og = og.float()
    m4 = mask_rows(raw_mask(mask), B, H, W).float()
    x = masked_conv_taps(_concat_elu(og), m4, w1, b1.float(), dilation=1, cdt=cdt)
    x = _pono(x)
    if a is not None:
        sk = _concat_elu(a.float()).to(cdt).float() @ w_skip.to(cdt).float()
        x = x + (sk + b_skip.float())
    y = masked_conv_taps(_concat_elu(x), m4, w2, b2.float(), dilation=1, cdt=cdt)
    return og + _pono(y[..., :Fc]) * torch.sigmoid(y[..., Fc:])


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _cuda.load("gated_resnet")
    if not getattr(lib, "_typed", False):
        lib.gated_resnet.argtypes = [_P] * 12 + [_I] * 4 + [_P]
        lib.gated_resnet.restype = _I
        lib._typed = True
    return lib


def gated_resnet_kernel(og, a, mask: MaskArg, w1, b1, w_skip, b_skip, w2, b2,
                        *, compute_dtype: str = "bfloat16"):
    """K4.  og (B, H, W, F) f32; a the same or None (then w_skip/b_skip are
    not read and no skip term is added); mask (B, 9, H*W) or a
    PreparedMask; conv weights f32 or already bf16; biases f32.  Returns
    (B, H, W, F) f32.  Inference only."""
    if not og.is_cuda:
        PLAIN_CALLS["gated_resnet"] += 1
        return gated_resnet_plain(og, a, mask, w1, b1, w_skip, b_skip, w2, b2,
                                  compute_dtype=compute_dtype)
    if compute_dtype != "bfloat16":
        raise ValueError("the CUDA K4 kernel computes in bfloat16 only")
    if torch.is_grad_enabled() and (og.requires_grad or w1.requires_grad):
        raise ValueError("K4 serves inference only: no gradient")
    B, H, W, Fc = og.shape
    HW = H * W
    dev = og.device
    if w1.shape[0] != 9 or HW % 128 or Fc % 16 or Fc > 80:
        raise ValueError(
            f"the K4 kernel takes 3x3 taps, H*W % 128 == 0, F % 16 == 0 and "
            f"F <= 80; got HW={HW}, F={Fc}")
    pm = prepare_mask(mask)
    f32, bf = torch.float32, torch.bfloat16
    _cuda.require(og, "og", dtype=f32, shape=(B, H, W, Fc))
    _cuda.require(pm.rows, "mask", dtype=f32, shape=(B, HW, 9), device=dev)
    w1k, w2k = w1.to(bf).contiguous(), w2.to(bf).contiguous()
    _cuda.require(w1k, "w1", dtype=bf, shape=(9, 2 * Fc, Fc), device=dev)
    _cuda.require(b1, "b1", dtype=f32, shape=(Fc,), device=dev)
    _cuda.require(w2k, "w2", dtype=bf, shape=(9, 2 * Fc, 2 * Fc), device=dev)
    _cuda.require(b2, "b2", dtype=f32, shape=(2 * Fc,), device=dev)
    P = _cuda.ptr
    null = ctypes.c_void_p(None)
    if a is not None:
        wsk = w_skip.to(bf).contiguous()
        _cuda.require(a, "a", dtype=f32, shape=(B, H, W, Fc), device=dev)
        _cuda.require(wsk, "w_skip", dtype=bf, shape=(2 * Fc, Fc), device=dev)
        _cuda.require(b_skip, "b_skip", dtype=f32, shape=(Fc,), device=dev)
        skip = (P(a), P(wsk), P(b_skip))
    else:
        skip = (null, null, null)
    out = torch.empty_like(og)
    ue, xe = (torch.empty((B, HW, 2 * Fc), dtype=bf, device=dev)
              for _ in range(2))
    rc = _lib().gated_resnet(
        P(og), skip[0], P(pm.rows), P(w1k), P(b1), skip[1], skip[2], P(w2k),
        P(b2), P(out), P(ue), P(xe), B, H, W, Fc, _cuda.stream_of(og))
    _cuda.check(rc, "gated_resnet")
    LAUNCHES["gated_resnet"] += 1
    return out
