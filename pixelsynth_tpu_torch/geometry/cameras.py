"""Camera matrix helpers (port of pixelsynth_tpu/geometry/cameras.py):
batched torch functions, the reference's conventions.  Each accepts one
matrix or a batch with leading dimensions.

  * invert_RT / invert_K / get_camera_matrices:
    geometry/camera_transformations.py:7-49 of the reference;
  * get_deltas (relative angle and translation of two extrinsics):
    utils/geometry.py:8-21;
  * jitter_quaternions (a random rotation of at most angle_deg):
    utils/jitter.py:6-17, with the draws from a torch.Generator;
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


def invert_K(K: torch.Tensor) -> torch.Tensor:
    """Invert an intrinsic [[fx 0 px], [0 fy py], [0 0 1]] (3x3 or 4x4,
    any leading dimensions) analytically (cameras.py:43-60)."""
    K = torch.as_tensor(K)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    px, py = K[..., 0, 2], K[..., 1, 2]
    Kinv = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand(K.shape).clone()
    Kinv[..., 0, 0] = 1.0 / fx
    Kinv[..., 0, 2] = -px / fx
    Kinv[..., 1, 1] = 1.0 / fy
    Kinv[..., 1, 2] = -py / fy
    return Kinv


def get_camera_matrices(position: torch.Tensor, rotation: torch.Tensor):
    """-> (P camera-from-world, Pinv world-from-camera), each [..., 4, 4],
    the inverse taken analytically from the orthonormal rotation
    (cameras.py:63-76)."""
    position = torch.as_tensor(position)
    rotation = torch.as_tensor(rotation)
    batch = position.shape[:-1]
    Pinv = torch.eye(4, dtype=rotation.dtype, device=rotation.device).expand(
        batch + (4, 4)).clone()
    Pinv[..., 0:3, 0:3] = rotation
    Pinv[..., 0:3, 3] = position
    return invert_RT(Pinv), Pinv


def get_deltas(mat1: torch.Tensor, mat2: torch.Tensor):
    """(angular distance in degrees, translation norm) between two 4x4
    extrinsics: the angle from the trace of R1^T R2, ||t2 - t1||
    (cameras.py:103-116)."""
    R1, t1 = mat1[..., 0:3, 0:3], mat1[..., 0:3, 3]
    R2, t2 = mat2[..., 0:3, 0:3], mat2[..., 0:3, 3]
    tr = torch.diagonal(R1.transpose(-1, -2) @ R2, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos)), torch.linalg.vector_norm(t2 - t1, dim=-1)


def jitter_quaternions(quat: torch.Tensor, gen: torch.Generator = None,
                       angle_deg: float = 10.0, *, axis=None, u=None) -> torch.Tensor:
    """Perturb a (w, x, y, z) quaternion by a rotation about a uniformly
    random axis through an angle uniform in [-angle_deg/2, angle_deg/2]
    (cameras.py:119-131).  The axis is a normal (3,) draw and u a uniform
    draw in [0, 1), both from `gen` unless given (the tests give JAX's)."""
    quat = torch.as_tensor(quat)
    if axis is None:
        axis = torch.randn(3, generator=gen, dtype=torch.float32)
    if u is None:
        u = torch.rand((), generator=gen, dtype=torch.float32)
    axis = torch.as_tensor(axis, dtype=quat.dtype, device=quat.device)
    u = torch.as_tensor(u, dtype=quat.dtype, device=quat.device)
    axis = axis / (torch.linalg.vector_norm(axis) + 1e-8)
    angle = u * angle_deg - angle_deg / 2
    half = torch.deg2rad(angle) / 2
    dq = torch.cat([torch.cos(half)[None], torch.sin(half) * axis])
    return _quat_mul(quat, dq)


def _quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions (cameras.py:134-145)."""
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)
