"""Synthetic paired-view batches (port of pixelsynth_tpu/data/synthetic.py):
a blocky random texture seen from the identity camera and from a camera
rotated by `rotation` radians about one of the R/L/U/D axes of the walk
paths.  numpy in and out, made from the caller's numpy generator (the same
draws as the JAX package's, so one seed gives one batch in both)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from pixelsynth_tpu_torch.geometry.cameras import euler_to_rotation_matrix, invert_RT
from pixelsynth_tpu_torch.geometry.paths import ROTVECS


def synthetic_pair_batch(rng: np.random.Generator, batch: int, W: int = 256,
                         rotation: float = 0.2) -> Dict[str, np.ndarray]:
    imgs = rng.uniform(-1, 1, (batch, W // 8, W // 8, 3)).astype(np.float32)
    imgs = np.repeat(np.repeat(imgs, 8, axis=1), 8, axis=2)  # blocky texture

    I = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
    direction = ["R", "L", "U", "D"][int(rng.integers(4))]
    rotvec = ROTVECS[direction] / np.linalg.norm(ROTVECS[direction]) * rotation
    R = euler_to_rotation_matrix(np.asarray(rotvec, np.float32)).numpy()
    P_out = np.eye(4, dtype=np.float32)
    P_out[:3, :3] = R
    P_out = np.broadcast_to(P_out, (batch, 4, 4)).copy()
    Pinv_out = invert_RT(P_out).numpy()
    return {
        "input_img": imgs,
        "output_img": imgs.copy(),
        "K": I,
        "Kinv": I,
        "P_in": I,
        "Pinv_in": I.copy(),
        "P_out": P_out,
        "Pinv_out": Pinv_out,
    }
