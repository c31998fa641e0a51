"""The PixelCNN's embedding-gather first layer (port of
pixelsynth_tpu/ops/masked_conv.py `locally_masked_embed`, :145-200)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
