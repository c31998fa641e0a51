"""The consistency metric over eval_consistency's folders (port of
pixelsynth_tpu/eval/calc_errors_consistency.py, after
calc_errors_consistency_homography.py of the reference): per item, the two
predictions, the visibility masks and the reference reprojection points;
the homography-warped masked PSNR_vis and PercSim_vis, averaged.

  python3 -m pixelsynth_tpu_torch.eval.calc_errors_consistency PRED_DIR \
      --directions dirs.npy [--masks-dir D] [--points-dir D] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from pixelsynth_tpu_torch.eval.calc_errors import load01
from pixelsynth_tpu_torch.eval.harness import load_png
from pixelsynth_tpu_torch.eval.homography import consistency_pair_metrics
from pixelsynth_tpu_torch.eval.metrics import PercSim
from pixelsynth_tpu_torch.geometry.paths import DIRECTION_ORDER


def _load_mask(path: str, shape) -> np.ndarray:
    """A mask PNG -> (H, W) {0, 1} float32: its luminance (PIL's "L",
    (19595 R + 38470 G + 7471 B + 2^15) >> 16) over 127.5; all ones where
    the file is missing."""
    if not os.path.exists(path):
        return np.ones(shape, np.float32)
    rgb = load_png(path)[..., :3].astype(np.int64)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return (lum.astype(np.float32) / 255.0 > 0.5).astype(np.float32)


def calc_errors_consistency(pred_dir: str, directions: np.ndarray, *,
                            masks_dir: Optional[str] = None,
                            points_dir: Optional[str] = None,
                            limit: Optional[int] = None,
                            percsim: Optional[PercSim] = None,
                            device="cuda") -> Dict[str, float]:
    """pred_dir: eval_consistency's output (a %04d folder per item with
    output_image_<dir>_0001/0002.png).  masks_dir / points_dir: the
    reference's consistency_masks and consistency_reference_points layouts
    (eval/consistency_fixtures.py writes them); without them full masks and
    an 8x8 grid of identical points (smoke).  PercSim defaults to a
    random-init VGG16 on `device`."""
    percsim = percsim or PercSim(device=device)
    results = {"PSNR_vis": [], "PercSim_vis": []}
    items = sorted(d for d in os.listdir(pred_dir)
                   if os.path.isdir(os.path.join(pred_dir, d)))
    if limit:
        items = items[:limit]
    for name in items:
        i = int(name)
        direction = DIRECTION_ORDER[int(directions[i])]
        folder = os.path.join(pred_dir, name)
        img1 = load01(os.path.join(folder, f"output_image_{direction}_0001.png"))
        img2 = load01(os.path.join(folder, f"output_image_{direction}_0002.png"))
        H = img1.shape[0]
        if masks_dir:
            m1 = _load_mask(os.path.join(masks_dir, name, "mask1.png"), (H, H))
            m2 = _load_mask(os.path.join(masks_dir, name, "mask2.png"), (H, H))
        else:
            m1 = m2 = np.ones((H, H), np.float32)
        if points_dir:
            pts1 = np.load(os.path.join(points_dir, f"reproj1_{i}.npy"))
            pts2 = np.load(os.path.join(points_dir, f"reproj2_{i}.npy"))
        else:
            ys, xs = np.meshgrid(np.linspace(-0.9, 0.9, 8), np.linspace(-0.9, 0.9, 8),
                                 indexing="ij")
            pts1 = pts2 = np.stack([xs.ravel(), ys.ravel()], -1)
        for k, v in consistency_pair_metrics(img1, img2, m1, m2, pts1, pts2,
                                             percsim).items():
            results[k].append(v)
    return {k: float(np.mean(v)) for k, v in results.items() if v}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pred_dir")
    ap.add_argument("--directions", required=True,
                    help=".npy of the items' consistency directions")
    ap.add_argument("--masks-dir", default=None)
    ap.add_argument("--points-dir", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(calc_errors_consistency(
        args.pred_dir, np.load(args.directions), masks_dir=args.masks_dir,
        points_dir=args.points_dir, limit=args.limit, device=args.device), indent=2))


if __name__ == "__main__":
    main()
