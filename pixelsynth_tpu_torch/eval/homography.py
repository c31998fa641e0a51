"""The homography view-consistency metric (port of
pixelsynth_tpu/eval/homography.py, calc_errors_consistency_homography.py
:41-105 of the reference).

Two predictions of the same content are related by a pixel homography:
fitted through saved reference reprojection points
(`homography_from_points`, the semantics of cv2.findHomography with method
0: a normalised DLT, then a least-squares refinement of the reprojection
error) or, for rotation-only cameras, exact (`exact_rotation_homography`).
Each image is warped into the other's frame and the overlap is scored by
masked PSNR (and PercSim), both warp directions averaged.  The warp
is an inverse-map bilinear warp with a zero border in float64 numpy (the
semantics of cv2.warpPerspective with INTER_LINEAR and BORDER_CONSTANT 0,
without its 1/32-pixel fixed-point coordinates), so no OpenCV is needed."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pixelsynth_tpu_torch.eval.metrics import PercSim, psnr_masked


def _normaliser(p: np.ndarray) -> np.ndarray:
    """Hartley's similarity: centroid to the origin, mean distance sqrt(2)."""
    c = p.mean(0)
    d = np.sqrt(((p - c) ** 2).sum(1)).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]])


def fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The homography h (h[2, 2] = 1) taking (N >= 4, 2) pixel points src
    to dst: a normalised DLT, then Levenberg-Marquardt on the reprojection
    error |h(src) - dst|^2 over the eight free entries, as
    cv2.findHomography(src, dst) with method 0 fits it."""
    from scipy.optimize import least_squares

    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    Ts, Td = _normaliser(src), _normaliser(dst)
    a = src @ Ts[:2, :2].T + Ts[:2, 2]
    b = dst @ Td[:2, :2].T + Td[:2, 2]
    n = len(a)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2], A[0::2, 2] = a, 1.0
    A[1::2, 3:5], A[1::2, 5] = a, 1.0
    A[0::2, 6:8], A[0::2, 8] = -b[:, :1] * a, -b[:, 0]
    A[1::2, 6:8], A[1::2, 8] = -b[:, 1:] * a, -b[:, 1]
    h = np.linalg.inv(Td) @ np.linalg.svd(A)[2][-1].reshape(3, 3) @ Ts
    h = h / h[2, 2]

    def residual(p):
        m = np.append(p, 1.0).reshape(3, 3)
        q = src @ m[:, :2].T + m[:, 2]
        return (q[:, :2] / q[:, 2:] - dst).ravel()

    if n > 4:
        h = np.append(least_squares(residual, h.ravel()[:8], method="lm").x,
                      1.0).reshape(3, 3)
    return h


def homography_from_points(pts_src: np.ndarray, pts_dst: np.ndarray) -> np.ndarray:
    """The homography between two views from their (N, >=2) reference
    reprojection points, stored in [-1, 1] coordinates with x flipped: the
    reference rescales them to [0, 255] and flips x back
    (calc_errors_consistency_homography.py:84-88) before
    cv2.findHomography."""
    src = (np.asarray(pts_src, np.float64)[:, :2] * 0.5 + 0.5) * 255
    dst = (np.asarray(pts_dst, np.float64)[:, :2] * 0.5 + 0.5) * 255
    src[:, 0] = 255 - src[:, 0]
    dst[:, 0] = 255 - dst[:, 0]
    return fit_homography(src, dst)


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


def consistency_pair_metrics(img1: np.ndarray, img2: np.ndarray, mask1: np.ndarray,
                             mask2: np.ndarray, pts1: np.ndarray, pts2: np.ndarray,
                             percsim: Optional[PercSim] = None) -> Dict[str, float]:
    """img1/img2 (H, W, 3) in [0, 1]; mask1/mask2 (H, W) in {0, 1}; pts
    (N, >=2) reference reprojection points of each view.  Returns
    PSNR_vis (and PercSim_vis with a PercSim) averaged over both warp
    directions."""
    h12 = homography_from_points(pts1, pts2)
    h21 = homography_from_points(pts2, pts1)
    w2in1 = warp(img2, h21).astype(np.float32)   # view 2 in view 1's frame
    w1in2 = warp(img1, h12).astype(np.float32)
    m1 = np.asarray(mask1, np.float32)[..., None]
    m2 = np.asarray(mask2, np.float32)[..., None]
    a = psnr_masked((w2in1 * m1)[None], (img1 * m1)[None], mask1[None])
    b = psnr_masked((w1in2 * m2)[None], (img2 * m2)[None], mask2[None])
    out = {"PSNR_vis": 0.5 * (float(a[0]) + float(b[0]))}
    if percsim is not None:
        pa = float(percsim((w2in1 * m1)[None], (img1 * m1)[None])[0])
        pb = float(percsim((w1in2 * m2)[None], (img2 * m2)[None])[0])
        out["PercSim_vis"] = 0.5 * (pa + pb)
    return out
