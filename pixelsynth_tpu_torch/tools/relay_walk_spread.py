"""The spread of the relay gate's scene-walk metrics over walk seeds, on the
card.

  python3 -m pixelsynth_tpu_torch.tools.relay_walk_spread [--seeds 8]

The relay gate (eval/relay_report.py) scores ONE demo-CLI walk of the
held-out world (seed 0): a single stochastic trajectory of 82 views whose
samples, candidates and carried cloud compound from view to view.  This
runs that walk (the checkpoint's settings: 8 samples, T = 0.7, fixed
decoder noise) at seeds 0..N-1 through the same demo CLI and prints, per
seed, the adjacent-view consistency, the PSNR against the world's renders
and its numerator-1 and last-numerator means, then their mean, spread
and range, beside the card's name and power limit.  Writes under
build/relay/spread/.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    from pixelsynth_tpu_torch import demo
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics
    from pixelsynth_tpu_torch.weights import load_stitched_npz

    if not torch.cuda.is_available():
        raise SystemExit("relay_walk_spread: no CUDA device")
    ckpt = os.path.join(REPO, "evidence", "relay", "stitched.npz")
    out = os.path.join(REPO, "build", "relay", "spread")
    cfg, _, _ = load_stitched_npz(ckpt)
    world, img, _ = heldout_demo_world(cfg.model.W)
    inp = save_png(os.path.join(out, "demo_input.png"), img)
    rows = []
    for seed in range(args.seeds):
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
    for k in ("adjacent", "gt", "num_first", "num_last"):
        v = np.array([r[k] for r in rows])
        print(f"{k}: mean {v.mean():.4f}, sd {v.std(ddof=1) if len(v) > 1 else 0.0:.4f}, "
              f"min {v.min():.4f}, max {v.max():.4f} over {len(v)} seeds")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")


if __name__ == "__main__":
    main()
