"""The spread of the relay gate's scene-walk metrics over walk seeds, on the
card.

  python3 -m pixelsynth_tpu_torch.tools.relay_walk_spread [--seeds 8] \
      [--ckpt evidence/relay/stitched.npz] [--out spread.json]

The relay gate (eval/relay_report.py) scores ONE demo-CLI walk of the
held-out world (seed 0): a single stochastic trajectory of 82 views whose
samples, candidates and carried cloud compound from view to view.  This
runs that walk (the checkpoint's settings: 8 samples, T = 0.7, fixed
decoder noise) at seeds 0..N-1 through the same demo CLI and prints, per
seed, the adjacent-view consistency, the PSNR against the world's renders
and its numerator-1 and last-numerator means, then their mean, spread
and range, beside the card's name and power limit.  --ckpt names the
stitched checkpoint (default the JAX package's artifact), --out a JSON
file for the record.  Writes the walks under build/relay/spread/.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def walk_spread(ckpt: str, seeds: int, out: str) -> Dict:
    """The demo CLI's walk of the held-out world on `ckpt` at seeds
    0..seeds-1, each scored as the relay gate scores it -> {"ckpt",
    "rows": [per seed], "summary": {metric: mean, sd, min, max}, "card"}.
    The walks go under `out`."""
    from pixelsynth_tpu_torch import demo
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics
    from pixelsynth_tpu_torch.weights import load_stitched_npz

    cfg, _, _ = load_stitched_npz(ckpt)
    world, img, _ = heldout_demo_world(cfg.model.W)
    inp = save_png(os.path.join(out, "demo_input.png"), img)
    rows = []
    for seed in range(seeds):
        scene_dir = os.path.join(out, f"seed{seed}")
        t0 = time.perf_counter()
        demo.main(["--img", inp, "--mode", "gen_scene", "--ckpt-dir", ckpt,
                   "--result-folder", scene_dir, "--seed", str(seed)])
        secs = time.perf_counter() - t0
        m = scene_walk_metrics(cfg, world, scene_dir)
        by_num = m["scene_gt_psnr_by_numerator"]
        nums = sorted(by_num, key=int)
        row = {"seed": seed, "adjacent": m["scene_adjacent_consistency_psnr"],
               "gt": m["scene_gt_psnr"], "num_first": by_num[nums[0]],
               "num_last": by_num[nums[-1]], "seconds": secs}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in ("adjacent", "gt", "num_first", "num_last"):
        v = np.array([r[k] for r in rows])
        summary[k] = {"mean": float(v.mean()),
                      "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
                      "min": float(v.min()), "max": float(v.max())}
        print(f"{k}: mean {v.mean():.4f}, sd {summary[k]['sd']:.4f}, "
              f"min {v.min():.4f}, max {v.max():.4f} over {len(v)} seeds")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    return {"ckpt": os.path.relpath(ckpt, REPO), "rows": rows, "summary": summary,
            "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(REPO, "evidence", "relay", "stitched.npz"),
                    help="a stitched checkpoint (default: the JAX package's artifact)")
    ap.add_argument("--out", default=None, help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("relay_walk_spread: no CUDA device")
    got = walk_spread(args.ckpt, args.seeds, os.path.join(REPO, "build", "relay", "spread"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=2)


if __name__ == "__main__":
    main()
