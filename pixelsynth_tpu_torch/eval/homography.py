"""Homography view-consistency under exact rotation homographies (port of
`exact_rotation_homography` and `consistency_exact` of
pixelsynth_tpu/eval/homography.py).

Two predictions of the same content from rotation-only cameras are related
by an exact pixel homography; each is warped into the other's frame and the
overlap is scored by masked PSNR, both warp directions averaged.  The warp
is an inverse-map bilinear warp with a zero border in float64 numpy (the
semantics of cv2.warpPerspective with INTER_LINEAR and BORDER_CONSTANT 0,
without its 1/32-pixel fixed-point coordinates), so no OpenCV is needed."""

from __future__ import annotations

from typing import Dict

import numpy as np

from pixelsynth_tpu_torch.eval.metrics import psnr_masked


def warp(img01: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Warp an (H, W, C) image by the homography h (source pixel -> output
    pixel, (col, row, 1) coordinates): output[y, x] samples the source at
    inv(h) @ (x, y, 1), bilinearly, with zeros outside the source."""
    H, W = img01.shape[:2]
    src = np.asarray(img01, np.float64)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    m = np.linalg.inv(np.asarray(h, np.float64))
    X = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    Y = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    Z = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = np.where(Z != 0, X / Z, -2.0)
        sy = np.where(Z != 0, Y / Z, -2.0)
    sx = np.clip(np.nan_to_num(sx, nan=-2.0), -2.0, W + 1.0)
    sy = np.clip(np.nan_to_num(sy, nan=-2.0), -2.0, H + 1.0)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    out = np.zeros((H, W) + src.shape[2:], np.float64)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            r, c = y0 + dy, x0 + dx
            ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
            v = src[np.clip(r, 0, H - 1), np.clip(c, 0, W - 1)]
            out += np.where(ok[..., None], v, 0.0) * (wy * wx)
    return out


def exact_rotation_homography(P1: np.ndarray, P2: np.ndarray, W: int,
                              atol: float = 1e-4) -> np.ndarray:
    """Exact pixel-space homography between two rotation-only cameras:
    H = A @ M3 @ A^-1 with M = P2 @ P1^-1 and A the clip-to-pixel map of
    geometry/projection.py homogeneous_to_pixels (col*hz = c*(hz - hx),
    row*hz = c*(hz + hy), c = (W-1)/2)."""
    M = P2.astype(np.float64) @ np.linalg.inv(P1.astype(np.float64))
    if np.abs(M[:3, 3]).max() > atol:
        raise ValueError(f"cameras are not rotation-only: t={M[:3, 3]}")
    c = (W - 1) / 2.0
    A = np.array([[-c, 0.0, c], [0.0, c, c], [0.0, 0.0, 1.0]])
    H = A @ M[:3, :3] @ np.linalg.inv(A)
    return H / H[2, 2]


def consistency_exact(img1: np.ndarray, img2: np.ndarray, P1: np.ndarray,
                      P2: np.ndarray) -> Dict[str, float]:
    """Masked overlap PSNR between two [0, 1] (H, W, 3) predictions of a
    rotation-only view pair under the exact homography, both warp
    directions averaged; and the mean share of each frame the other
    covers."""
    W = img1.shape[1]
    h12 = exact_rotation_homography(P1, P2, W)
    h21 = exact_rotation_homography(P2, P1, W)
    ones = np.ones(img1.shape[:2] + (1,), np.float64)
    m1 = (warp(ones, h21)[..., 0] > 0.999).astype(np.float32)
    m2 = (warp(ones, h12)[..., 0] > 0.999).astype(np.float32)
    w2in1 = warp(img2, h21).astype(np.float32)
    w1in2 = warp(img1, h12).astype(np.float32)
    a = psnr_masked((w2in1 * m1[..., None])[None], (img1 * m1[..., None])[None], m1[None])
    b = psnr_masked((w1in2 * m2[..., None])[None], (img2 * m2[..., None])[None], m2[None])
    return {"PSNR_vis": 0.5 * (float(a[0]) + float(b[0])),
            "overlap_frac": 0.5 * float(m1.mean() + m2.mean())}
