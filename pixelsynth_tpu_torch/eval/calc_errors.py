"""The metric battery over saved prediction folders (port of
pixelsynth_tpu/eval/calc_errors.py).

Mirrors calc_errors_quality.py + utils/calc_errors.py:104-284 of the
reference: PSNR (clamped), SSIM and PercSim of tgt/ against pred/, FID over
activation statistics, and the tail rates.  Run after
eval/harness.py `eval_quality`:

  python3 -m pixelsynth_tpu_torch.eval.calc_errors OUT_DIR [--limit N]
      [--device cuda|cpu]

Without weights the PercSim and FID networks are random from a seed, so
the CLI's PercSim and FID are smoke numbers, not the paper's.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from pixelsynth_tpu_torch.eval.harness import load_png
from pixelsynth_tpu_torch.eval.metrics import (
    PercSim, feature_stats, fid_from_stats, psnr_clamped, ssim_metric, tail_rates,
)


def load01(path: str) -> np.ndarray:
    """A PNG -> (H, W, 3) float32 in [0, 1]."""
    return load_png(path)[..., :3].astype(np.float32) / 255.0


def _folder(dirname: str) -> List[str]:
    return sorted(os.path.join(dirname, f) for f in os.listdir(dirname)
                  if f.endswith(".png"))


def calc_errors_quality(out_dir: str, *, percsim: Optional[PercSim] = None,
                        feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                        batch: int = 16, limit: Optional[int] = None,
                        device="cuda") -> Dict[str, float]:
    """tgt/ against pred/ under out_dir -> {PSNR, SSIM, PercSim, the tail
    rates[, FID]}.  PercSim defaults to a random-init VGG16 on `device`;
    feature_fn: (B, H, W, 3) [0, 1] -> (B, D) activations for FID
    (eval/inception.py `make_fid_feature_fn`, or any embedding)."""
    tgt_paths = _folder(os.path.join(out_dir, "tgt"))
    pred_paths = _folder(os.path.join(out_dir, "pred"))
    if limit:
        tgt_paths, pred_paths = tgt_paths[:limit], pred_paths[:limit]
    percsim = percsim or PercSim(device=device)

    psnrs, ssims, percs = [], [], []
    feats_t, feats_p = [], []
    for i in range(0, len(tgt_paths), batch):
        tgt = np.stack([load01(p) for p in tgt_paths[i:i + batch]])
        pred = np.stack([load01(p) for p in pred_paths[i:i + batch]])
        psnrs.append(psnr_clamped(pred, tgt).numpy())
        ssims.append(float(ssim_metric(pred, tgt)))
        percs.append(percsim(pred, tgt))
        if feature_fn is not None:
            feats_t.append(np.asarray(feature_fn(tgt)))
            feats_p.append(np.asarray(feature_fn(pred)))

    psnrs = np.concatenate(psnrs)
    percs = np.concatenate(percs)
    out = {"PSNR": float(psnrs.mean()), "SSIM": float(np.mean(ssims)),
           "PercSim": float(percs.mean())}
    out.update(tail_rates(psnrs, percs, np.repeat(np.asarray(ssims), batch)[:len(psnrs)]))
    if feature_fn is not None:
        mu1, s1 = feature_stats(np.concatenate(feats_t))
        mu2, s2 = feature_stats(np.concatenate(feats_p))
        out["FID"] = fid_from_stats(mu1, s1, mu2, s2)
    return out


def main(argv=None):
    from pixelsynth_tpu_torch.eval.inception import make_fid_feature_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(calc_errors_quality(
        args.out_dir, limit=args.limit, device=args.device,
        feature_fn=make_fid_feature_fn(device=args.device)), indent=2))


if __name__ == "__main__":
    main()
