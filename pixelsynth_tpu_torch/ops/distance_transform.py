"""Batched distance transforms on the code grid (port of
pixelsynth_tpu/ops/distance_transform.py): exact L2 as one (HW x HW)
masked min per image, or the cv2 maskSize=5 chamfer approximation as
iterated min-plus relaxation; and the foreground's mean-of-mass point."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _pairwise_dist2_np(H: int, W: int) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.stack([ys.reshape(-1), xs.reshape(-1)], -1).astype(np.float32)
    d = coords[:, None, :] - coords[None, :, :]
    return (d * d).sum(-1)


def distance_to_zero(mask: torch.Tensor) -> torch.Tensor:
    """Exact distance from every pixel to the nearest zero pixel of `mask`
    (B, H, W); 0 where mask == 0, a large finite value if none is zero."""
    B, H, W = mask.shape
    d2 = torch.as_tensor(_pairwise_dist2_np(H, W), device=mask.device)
    inside = mask.reshape(B, -1) != 0
    masked = torch.where(~inside[:, None, :], d2[None], torch.tensor(
        1e9, dtype=torch.float32, device=mask.device))
    best = masked.min(dim=2).values
    out = torch.sqrt(torch.clamp(best, max=1e9)) * inside
    return out.reshape(B, H, W)


_CHAMFER5 = (1.0, 1.4, 2.1969)


def _chamfer_offsets():
    a, b, c = _CHAMFER5
    offs = []
    for dy, dx in ((0, 1), (1, 0)):
        offs += [((dy, dx), a), ((-dy, -dx), a)]
    for dy in (-1, 1):
        for dx in (-1, 1):
            offs.append(((dy, dx), b))
    for dy, dx in ((1, 2), (2, 1), (1, -2), (2, -1)):
        offs += [((dy, dx), c), ((-dy, -dx), c)]
    return offs


def chamfer_distance_to_zero(mask: torch.Tensor, iters=None) -> torch.Tensor:
    """cv2.distanceTransform(DIST_L2, maskSize=5)-compatible distance."""
    B, H, W = mask.shape
    d = torch.where(mask != 0, torch.tensor(1e9, device=mask.device),
                    torch.tensor(0.0, device=mask.device))
    iters = iters if iters is not None else H + W
    offs = _chamfer_offsets()

    def shift(x, dy, dx):
        padded = F.pad(x, (2, 2, 2, 2), value=1e9)
        return torch.roll(padded, (dy, dx), dims=(1, 2))[:, 2:-2, 2:-2]

    for _ in range(iters):
        for (dy, dx), w in offs:
            d = torch.minimum(d, shift(d, dy, dx) + w)
    return torch.where(mask != 0, d, torch.zeros_like(d))


def signed_distance_field(foreground: torch.Tensor, background=None, *,
                          mode: str = "exact") -> torch.Tensor:
    """int32 (fg-dist - bg-dist), truncated toward zero
    (z_buffermodel.py:666-675)."""
    fg = (foreground != 0).float()
    bg = 1.0 - fg if background is None else (background != 0).float()
    dist = distance_to_zero if mode == "exact" else chamfer_distance_to_zero
    return torch.trunc(dist(fg) - dist(bg)).to(torch.int32)


def foreground_mass_center(foreground: torch.Tensor) -> torch.Tensor:
    """(B, 2) int32 [x, y] mean-of-mass points (z_buffermodel.py:655-664):
    the mean over ALL pixels of coordinate * mask, as the reference takes
    it (not the mean over the foreground pixels)."""
    fg = (foreground != 0).float()
    B, H, W = fg.shape
    ys = torch.arange(H, dtype=torch.float32, device=fg.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=fg.device)[None, :].expand(H, W)
    mx = (fg * xs).reshape(B, -1).mean(1)
    my = (fg * ys).reshape(B, -1).mean(1)
    return torch.stack([mx, my], 1).to(torch.int32)
