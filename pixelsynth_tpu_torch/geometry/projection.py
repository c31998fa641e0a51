"""Camera reprojection: depth map -> point cloud in a novel view (port of
pixelsynth_tpu/geometry/projection.py).

h = K @ RT_cam2 @ RTinv_cam1 @ Kinv @ (ndc_grid * depth) is the
reference's K-projected homogeneous cloud (z_buffer_manipulator.py:59-67);
`homogeneous_to_pixels` turns it into continuous (col, row, depth) pixel
coordinates for the splatter (PyTorch3D's NDC has +1 at the top-left):
  col = (1 - h_x/h_z) * (W-1)/2,  row = (1 + h_y/h_z) * (W-1)/2,
  depth = -h_z.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EPS = 1e-2  # z clamp of z_buffer_manipulator.py:8


@functools.lru_cache(maxsize=8)
def _ndc_grid_np(W: int, H: int) -> np.ndarray:
    xs = (np.arange(W, dtype=np.float32) / (W - 1)) * 2.0 - 1.0
    ys = (np.arange(H, dtype=np.float32) / (H - 1)) * 2.0 - 1.0
    gx = np.tile(xs[None, :], (H, 1)).reshape(-1)
    gy = np.tile(ys[:, None], (1, W)).reshape(-1)
    return np.stack([gx, -gy, -np.ones_like(gx), np.ones_like(gx)], axis=0)


def ndc_grid(W: int, H: int = None, device=None) -> torch.Tensor:
    """(4, H*W) homogeneous grid (z_buffer_manipulator.py:38-48)."""
    return torch.as_tensor(_ndc_grid_np(W, W if H is None else H), device=device)


def to44(M: torch.Tensor) -> torch.Tensor:
    """Promote [..., 3, 3] / [..., 3, 4] to [..., 4, 4]."""
    if M.shape[-2:] == (4, 4):
        return M
    out = torch.eye(4, dtype=M.dtype, device=M.device).expand(
        M.shape[:-2] + (4, 4)).clone()
    out[..., :M.shape[-2], :M.shape[-1]] = M
    return out


def homogeneous_to_pixels(h: torch.Tensor, W: int):
    """(B, 4, N) -> ((B, N, 3) [col, row, depth], valid (B, N)); points
    with |h_z| < EPS go far off-screen with huge depth."""
    hz = h[:, 2, :]
    valid = hz.abs() >= EPS
    hz_safe = torch.where(valid, hz, torch.full_like(hz, EPS))
    x_pt = h[:, 0, :] / hz_safe
    y_pt = -h[:, 1, :] / hz_safe
    depth = -hz
    col = (1.0 - x_pt) * (W - 1) / 2.0
    row = (1.0 - y_pt) * (W - 1) / 2.0
    col = torch.where(valid, col, torch.full_like(col, -1e6))
    row = torch.where(valid, row, torch.full_like(row, -1e6))
    depth = torch.where(valid, depth, torch.full_like(depth, 1e6))
    return torch.stack([col, row, depth], dim=-1), valid


def lift_to_cloud(depth, K, K_inv, RTinv_cam1, RT_cam2, W: int):
    """(B, H, W) depth -> K-projected homogeneous cloud in the cam2 frame,
    (B, 4, N) with last row 1."""
    B = depth.shape[0]
    d = depth.reshape(B, 1, -1)
    coors = ndc_grid(W, W, depth.device)[None] * d
    coors = torch.cat([coors[:, :3], torch.ones_like(coors[:, 3:])], dim=1)
    RT = to44(RT_cam2) @ to44(RTinv_cam1)
    return to44(K) @ (RT @ (to44(K_inv) @ coors))
