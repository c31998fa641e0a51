"""Camera paths for `PixelSynth.forward_angle` (port of
pixelsynth_tpu/utils/camera_paths.py; create_nerf_like_circles.py:6-14 of
the reference), in numpy as there."""

from __future__ import annotations

from typing import List

import numpy as np


def nerf_like_circle(n_frames: int = 30, radius: float = 0.35,
                     depth_amp: float = 0.4) -> List[np.ndarray]:
    """A translation circle in the camera plane with a sinusoidal depth bob:
    n_frames float32 4x4 extrinsics with identity rotation."""
    out = []
    for i in range(n_frames):
        t = 2.0 * np.pi * i / n_frames
        M = np.eye(4, dtype=np.float32)
        M[:3, 3] = radius * np.array(
            [np.sin(t), np.cos(t), depth_amp * np.sin(t + np.pi / 2)], np.float32)
        out.append(M)
    return out
