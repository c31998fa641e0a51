"""Camera-path construction for scene generation (a numpy copy of
pixelsynth_tpu/geometry/paths.py, so the port never imports the JAX
package).

Re-implements the reference's rotation-vector table and interpolated camera
paths (models/z_buffermodel.py:112-118, 202-242) as host-side numpy:

  - 8 rotation directions (R L U D UL UR DR DL) interpolated as
    ``rotvec * num / denom``
  - swirl path 'S' (translation circle, z_buffermodel.py:211-216)
  - circle path 'C' (rotation circle, z_buffermodel.py:217-225)
  - fixed-rotation mode for paired-image settings (z_buffermodel.py:229)
  - homography mode (rotation about the camera center, z_buffermodel.py:235-238)
"""

from __future__ import annotations

import numpy as np

# Full-angle rotation vectors; mirrors models/z_buffermodel.py:114-115.
ROTVECS = {
    "R": np.array([0.0, 0.6, 0.0]),
    "L": np.array([0.0, -0.6, 0.0]),
    "U": np.array([-0.3, 0.0, 0.0]),
    "D": np.array([0.3, 0.0, 0.0]),
    "UR": np.array([-0.15, 0.3, 0.0]),
    "UL": np.array([-0.15, -0.3, 0.0]),
    "DR": np.array([0.15, 0.3, 0.0]),
    "DL": np.array([0.15, -0.3, 0.0]),
}

# Consistency-direction index mapping; mirrors models/z_buffermodel.py:118.
DIRECTION_ORDER = ["R", "L", "U", "D", "UL", "UR", "DR", "DL"]


def _euler_np(theta: np.ndarray) -> np.ndarray:
    """R = R_z @ R_y @ R_x (the same composition as
    geometry.cameras.euler_to_rotation_matrix / z_buffermodel.py:186-200)."""
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return Rz @ Ry @ Rx


def _rt_from_rotvec(rotvec: np.ndarray, input_RT: np.ndarray,
                    homography: bool) -> np.ndarray:
    """4x4 output extrinsic from an euler rotvec applied before input_RT."""
    R = _euler_np(np.asarray(rotvec, np.float64))
    mtx = np.eye(4, dtype=np.float64)
    mtx[:3, :3] = R
    if homography:
        # rotate about the camera centre, keep translation column
        out = np.zeros((4, 4), np.float64)
        out[:, 3] = input_RT[:, 3]
        out[:3, :3] = mtx[:3, :3] @ input_RT[:3, :3]
    else:
        out = mtx @ input_RT
    return out


def get_rt_from_rot(
    direction: str,
    input_RT,
    num: float | None = None,
    denom: float | None = None,
    *,
    scene_mode: bool = True,
    rotation: float = 0.3,
    homography: bool = False,
):
    """Interpolated output camera for a path direction.

    Mirrors models/z_buffermodel.py:202-242.  Returns (output_RTinv,
    output_RT) as float32 numpy, both 4x4 (or batched matching input_RT).

    The inverse is EXACT (np.linalg.inv, matching the reference's
    torch.inverse at z_buffermodel.py:215,224,241) -- NOT the orthonormal
    transpose shortcut: demo/habitat extrinsics carry the habitat
    OFFSET@K fold (P[:3,:3] = R @ diag(2,-2,-1)), where the shortcut's
    inverse is wrong by diag(4,4,1) and compounds x4 per cumulative-walk
    hop (the r5 scene-drift root cause: the carried cloud collapsed
    16384 -> 1024 -> 64 -> 4 on-screen points after 1/2/3 hops).

    scene_mode=True corresponds to model_setting in {gen_scene, gen_two_imgs}
    (interpolated rotvec * num/denom); scene_mode=False is the fixed-rotation
    gen_img path, scaling the direction to total magnitude ``rotation``.
    """
    input_RT = np.asarray(input_RT, np.float64)
    if num is None:
        num = 0.0
    squeeze = input_RT.ndim == 2

    def fin(out_RT: np.ndarray):
        if not squeeze:
            out_RT = np.broadcast_to(out_RT, input_RT.shape)
        inv = np.linalg.inv(out_RT)
        return inv.astype(np.float32), out_RT.astype(np.float32)

    RT0 = input_RT if squeeze else input_RT[0]

    if scene_mode and direction == "S":
        # swirl: translate on a tilted circle, keep rotation
        # (z_buffermodel.py:211-216)
        t = 2.0 * np.pi * num / denom
        offs = 0.35 * np.array(
            [np.sin(t), np.cos(t), 0.4 * np.sin(2.0 * np.pi * (0.25 + num / denom))],
            np.float64,
        )
        out = np.zeros((4, 4), np.float64)
        out[:, :3] = RT0[:, :3]
        out[3, 3] = 1.0
        out[:3, 3] = RT0[:3, 3] + offs
        return fin(out)
    if scene_mode and direction == "C":
        # circle: rotate viewing direction on a small cone
        # (z_buffermodel.py:217-225)
        t = 2.0 * np.pi * num / denom
        rotvec = np.array([0.2 * np.cos(t), 0.2 * np.sin(t), 0.0], np.float64)
        return fin(_rt_from_rotvec(rotvec, RT0, homography=False))

    base = ROTVECS[direction]
    if scene_mode:
        rotvec = base * float(num) / float(denom)
    else:
        rotvec = base * rotation / np.linalg.norm(base)
    return fin(_rt_from_rotvec(rotvec, RT0, homography=homography))


def num_split_for_direction(direction: str, num_split: int, two_imgs: bool = False) -> int:
    """Per-direction split count (models/z_buffermodel.py:452-458)."""
    if two_imgs:
        return 2
    if direction in ("S", "C"):
        return num_split * 2
    if direction in ("U", "D", "UL", "UR", "DR", "DL"):
        return max(int(num_split / 2), 1)
    return num_split
