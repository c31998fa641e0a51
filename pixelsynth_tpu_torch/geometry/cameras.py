"""Camera matrix helpers (port of the parts of
pixelsynth_tpu/geometry/cameras.py the synthetic data uses): batched
torch functions, float32, the reference's conventions.

  * invert_RT: geometry/camera_transformations.py:7-20 of the reference;
  * euler_to_rotation_matrix: R = R_z @ R_y @ R_x
    (models/z_buffermodel.py:186-200).
"""

from __future__ import annotations

import torch


def invert_RT(RT: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 3 or 4, 4] extrinsic [R | t] with orthonormal R; a
    4x4 input gives a 4x4 output with bottom row [0, 0, 0, 1]."""
    RT = torch.as_tensor(RT)
    R, T = RT[..., 0:3, 0:3], RT[..., 0:3, 3:4]
    Rinv = R.transpose(-1, -2)
    top = torch.cat([Rinv, -Rinv @ T], -1)
    if RT.shape[-2] != 4:
        return top
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=RT.dtype,
                          device=RT.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def euler_to_rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """R = R_z @ R_y @ R_x for Euler angles theta [..., 3] (float32)."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    cx, sx = torch.cos(theta[..., 0]), torch.sin(theta[..., 0])
    cy, sy = torch.cos(theta[..., 1]), torch.sin(theta[..., 1])
    cz, sz = torch.cos(theta[..., 2]), torch.sin(theta[..., 2])
    zeros, ones = torch.zeros_like(cx), torch.ones_like(cx)
    shape = theta.shape[:-1] + (3, 3)
    Rx = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], -1).reshape(shape)
    Ry = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], -1).reshape(shape)
    Rz = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], -1).reshape(shape)
    return Rz @ (Ry @ Rx)
