"""Non-differentiable nearest-point z-buffer for the consistency eval
(port of pixelsynth_tpu/ops/depth_splat.py).

Mirrors models/projection/depth_manipulator.py:37-104 (project_zbuffer):
every point rounds to its pixel (round half to even, as jnp.round), the
pixel keeps the least depth (a scatter "amin", the JAX `.at[f].min`), and
a point is visible where its depth is within 1e-6 of its pixel's."""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e9


def project_zbuffer(points: torch.Tensor, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """points: (B, N, 3) finite (col, row, depth) pixel coordinates.

    Returns (depth map (B, W, W) float32, BIG where no point lands;
             visible (B, N) bool: the point wins its pixel's z-buffer)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    B = points.shape[0]
    col = torch.round(points[..., 0])
    row = torch.round(points[..., 1])
    depth = points[..., 2]
    ok = (col >= 0) & (col < W) & (row >= 0) & (row < W) & (depth > 0)
    # the index of a point off the image is never read (its depth is BIG
    # and it is not `ok`), so clamping before the cast changes nothing
    flat = (row.clamp(-1, W) * W + col.clamp(-1, W)).long().clamp(0, W * W - 1)
    d = torch.where(ok, depth, torch.full_like(depth, BIG))
    zbuf = torch.full((B, W * W), BIG, dtype=torch.float32, device=points.device)
    zbuf = zbuf.scatter_reduce(1, flat, d, reduce="amin", include_self=True)
    vis = d <= torch.gather(zbuf, 1, flat) + 1e-6
    return zbuf.reshape(B, W, W), vis & ok


def visibility_masks(points_v1: torch.Tensor, points_v2: torch.Tensor, W: int):
    """Per-pixel visibility of view-1 content in view 2 (the
    consistency_masks the homography metric reads): a view-1 pixel is
    visible in view 2 if its reprojected point wins view 2's z-buffer."""
    _, vis = project_zbuffer(points_v2, W)
    return vis.reshape(points_v1.shape[0], W, W)
