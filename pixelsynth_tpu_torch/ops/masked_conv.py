"""The locally masked convolution in plain, differentiable PyTorch, and the
PixelCNN's embedding-gather first layer (port of
pixelsynth_tpu/ops/masked_conv.py: `unfold_patches`, :23-41,
`locally_masked_conv2d`, :44-88, `locally_masked_conv2d_fused`, :91-142,
and `locally_masked_embed`, :145-200).

`locally_masked_conv2d` is what `sample_backend="xla"` runs and what the
kernels' plain versions are tested against.  The restructured
`locally_masked_conv2d_fused` (one matmul, then k^2 shifted slices) is
selected by no path, as in the JAX package, which computes it in XLA
outside any Pallas kernel."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F


def tap_offsets(k: int, dilation: int):
    """(dr, dc) of the k*k taps, row-major."""
    half = k // 2
    return [((i - half) * dilation, (j - half) * dilation)
            for i in range(k) for j in range(k)]


def shifted_taps(x: torch.Tensor, k: int, dilation: int) -> List[torch.Tensor]:
    """x (B, H, W, C) -> k*k views, tap t's being x[p + o_t] with zeros
    outside the image ('SAME' padding, pad = dilation * (k - 1) // 2)."""
    B, H, W, _ = x.shape
    pad = (k // 2) * dilation
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return [xp[:, pad + dr:pad + dr + H, pad + dc:pad + dc + W]
            for dr, dc in tap_offsets(k, dilation)]


def unfold_patches(x: torch.Tensor, k: int, dilation: int = 1) -> torch.Tensor:
    """k x k patches: (B, H, W, C) -> (B, H, W, C, k*k), channel-major as
    `conv_general_dilated_patches` orders them (index c * k*k + tap, taps
    row-major), 'SAME' padding dilation * (k - 1) // 2."""
    B, H, W, C = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), k, dilation=dilation,
                    padding=dilation * (k - 1) // 2)       # (B, C*k*k, H*W)
    return cols.reshape(B, C, k * k, H, W).permute(0, 3, 4, 1, 2)


def mask_rows(mask: torch.Tensor, B: int, H: int, W: int) -> torch.Tensor:
    """(B, k*k, H*W) -> (B, H, W, k*k)."""
    return mask.reshape(B, mask.shape[1], H, W).permute(0, 2, 3, 1)


def locally_masked_conv2d(x: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask_weight: Optional[torch.Tensor] = None, *,
                          dilation: int = 1,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Convolution whose kernel support is masked per output location.

    x (B, H, W, Cin); mask (B, k*k, H*W), one entry per tap per output
    location, taps row-major; weight (k*k, Cin, Cout); bias (Cout);
    mask_weight (k*k, Cout), a learned term on the mask itself.  With
    compute_dtype the operands are rounded to it and the sum is taken in
    f32.  Returns (B, H, W, Cout) f32."""
    B, H, W, _ = x.shape
    K2 = weight.shape[0]
    k = int(round(K2 ** 0.5))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    m = mask_rows(mask, B, H, W).to(x.dtype)
    patches = torch.stack(shifted_taps(x, k, dilation), dim=3)  # (B,H,W,k2,Cin)
    masked = (patches * m[..., None]).float()
    out = torch.einsum("bhwpc,pco->bhwo", masked, weight.float())
    if mask_weight is not None:
        out = out + torch.einsum("bhwp,po->bhwo", m.float(),
                                 mask_weight.to(m.dtype).float())
    if bias is not None:
        out = out + bias
    return out.float()


def locally_masked_conv2d_fused(x: torch.Tensor, mask: torch.Tensor,
                                weight: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                mask_weight: Optional[torch.Tensor] = None, *,
                                dilation: int = 1,
                                compute_dtype: Optional[torch.dtype] = None
                                ) -> torch.Tensor:
    """The same op as `locally_masked_conv2d`, restructured:

      out[p] = sum_t mask_t[p] * (x W_t)[p + off_t]

    one (BHW, Cin) @ (Cin, k^2 * Cout) product gives every tap's term at
    every position, then k^2 shifted slices of it are mask-scaled and
    summed, with no (B, H, W, Cin, k^2) patch tensor.  With compute_dtype
    the operands are rounded to it and the products summed in f32.
    Returns (B, H, W, Cout) f32."""
    B, H, W, _ = x.shape
    K2, _, Cout = weight.shape
    k = int(round(K2 ** 0.5))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    z = torch.einsum("bhwc,tcf->bhwtf", x.float(), weight.float())
    pad = (k // 2) * dilation
    zp = F.pad(z, (0, 0, 0, 0, pad, pad, pad, pad))
    m = mask_rows(mask, B, H, W).float()
    out = torch.zeros((B, H, W, Cout), dtype=torch.float32, device=x.device)
    for t, (dr, dc) in enumerate(tap_offsets(k, dilation)):
        zt = zp[:, pad + dr:pad + dr + H, pad + dc:pad + dc + W, t]
        out = out + m[..., t, None] * zt
    if mask_weight is not None:
        out = out + torch.einsum("bhwp,po->bhwo", m, mask_weight.float())
    if bias is not None:
        out = out + bias
    return out


def locally_masked_embed(codes: torch.Tensor, filled: torch.Tensor,
                         mask: torch.Tensor, weight: torch.Tensor,
                         bias=None, *, num_classes: int) -> torch.Tensor:
    """First-layer locally masked conv for one-hot code input, as a per-tap
    table lookup:

      out[p] = bias + sum_tap mask[tap,p] * (W[tap, code[p+off]] * filled[p+off]
                                             + W[tap, ones])

    codes (B, H, W) int; filled (B, H, W); mask (B, k*k, H*W);
    weight (k*k, num_classes + 1, F) -- the trailing input channel is the
    ones padding channel.  Returns (B, H, W, F) f32.
    """
    B, H, W = codes.shape
    K2 = weight.shape[0]
    k = int(round(K2 ** 0.5))
    half = k // 2
    Fo = weight.shape[-1]
    m = mask.reshape(B, K2, H, W).permute(0, 2, 3, 1).to(weight.dtype)
    fil = filled.to(weight.dtype)
    pad_codes = F.pad(codes.long(), (half, half, half, half))
    pad_fil = F.pad(fil, (half, half, half, half))
    out = torch.zeros((B, H, W, Fo), dtype=weight.dtype, device=weight.device)
    ones_row = weight[:, num_classes, :]
    for i, dr in enumerate(range(-half, half + 1)):
        for j, dc in enumerate(range(-half, half + 1)):
            t = i * k + j
            c_t = pad_codes[:, half + dr:half + dr + H, half + dc:half + dc + W]
            f_t = pad_fil[:, half + dr:half + dr + H, half + dc:half + dc + W]
            contrib = weight[t][c_t] * f_t[..., None] + ones_row[t]
            out = out + m[..., t, None] * contrib
    if bias is not None:
        out = out + bias
    return out.float()
