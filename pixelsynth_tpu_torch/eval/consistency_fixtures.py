"""Consistency-eval fixtures: visibility masks and reference reprojection
points (port of pixelsynth_tpu/eval/consistency_fixtures.py).

The reference scores view consistency against shipped fixtures,
data/consistency_masks/<i>/mask{1,2}.png and
data/consistency_reference_points/reproj{1,2}_<i>.npy
(calc_errors_consistency_homography.py:55-88).  These are made from the
model itself: the predicted depth lifts the input view to a cloud, which
is projected into the full- and the half-rotation camera; a sparse grid of
its points are the reference points (in [-1, 1] with the reference's x
flipped), and the cloud's z-buffer coverage is each view's mask.  The
U-Net is the only network this runs.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

from pixelsynth_tpu_torch.eval.harness import save_png
from pixelsynth_tpu_torch.geometry.paths import DIRECTION_ORDER, get_rt_from_rot
from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
from pixelsynth_tpu_torch.ops.depth_splat import project_zbuffer


def _pixels_to_ref_coords(pts: torch.Tensor, W: int) -> np.ndarray:
    """(N, 3) pixel coordinates -> the reference's stored convention:
    [-1, 1] with x flipped (the metric maps back by (p * .5 + .5) * 255 and
    flips x, calc_errors_consistency_homography.py:84-88)."""
    pts = pts.detach().cpu().numpy()
    x = 1.0 - 2.0 * pts[:, 0] / (W - 1)
    y = 2.0 * pts[:, 1] / (W - 1) - 1.0
    return np.stack([x, y], -1).astype(np.float32)


@torch.no_grad()
def make_fixtures_for_item(ps, img, K, Kinv, P_in, Pinv_in, direction: str, *,
                           grid: int = 16) -> Dict[str, np.ndarray]:
    """img (1, W, W, 3) in [-1, 1]; cameras (1, 4, 4).  -> {mask1, mask2
    (W, W) uint8, pts1, pts2 (grid^2, 2) float32} for the (full, half)
    rotation pair of `direction`."""
    W = ps.W

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(ps.device)

    depth = ps.regress_depth(dev(img))
    stride = W // grid
    sel = (np.arange(0, W, stride)[:, None] * W + np.arange(0, W, stride)[None, :]).reshape(-1)
    masks, pts = [], []
    for numerator in (2, 1):
        _, RT = get_rt_from_rot(direction, np.asarray(P_in), numerator, 2)
        cloud = lift_to_cloud(depth, dev(K), dev(Kinv), dev(Pinv_in), dev(RT), W)
        p, _ = homogeneous_to_pixels(cloud, W)
        zbuf, _ = project_zbuffer(p, W)
        masks.append((zbuf < 1e8)[0].cpu().numpy().astype(np.uint8))
        pts.append(_pixels_to_ref_coords(p[0, torch.as_tensor(sel, device=p.device)], W))
    return {"mask1": masks[0], "mask2": masks[1], "pts1": pts[0], "pts2": pts[1]}


def write_fixtures(ps, dataset: Sequence[Dict], out_dir: str, *, limit=None,
                   grid: int = 16) -> None:
    """The reference's fixture layout under out_dir for every item (items
    as eval/harness.py `eval_consistency` reads them)."""
    masks_dir = os.path.join(out_dir, "consistency_masks")
    pts_dir = os.path.join(out_dir, "consistency_reference_points")
    os.makedirs(pts_dir, exist_ok=True)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        item = dataset[i]
        fx = make_fixtures_for_item(
            ps, np.asarray(item["input_img"])[None], np.asarray(item["K"])[None],
            np.asarray(item["Kinv"])[None], np.asarray(item["P_in"])[None],
            np.asarray(item["Pinv_in"])[None],
            DIRECTION_ORDER[int(item["direction"])], grid=grid)
        for k in ("mask1", "mask2"):
            save_png(os.path.join(masks_dir, f"{i:04d}", f"{k}.png"),
                     np.repeat(fx[k][..., None], 3, -1).astype(np.float32))
        np.save(os.path.join(pts_dir, f"reproj1_{i}.npy"), fx["pts1"])
        np.save(os.path.join(pts_dir, f"reproj2_{i}.npy"), fx["pts2"])
