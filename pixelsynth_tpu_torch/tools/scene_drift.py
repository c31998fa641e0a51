"""Scene-walk drift: per-view GT PSNR along the walk (port of
pixelsynth_tpu/tools/scene_drift.py).

Runs the cumulative walk (`SceneGenerator.generate_scene`) on the relay's
held-out procedural world, where a ground-truth render exists for every
camera, and records the per-(direction, numerator) GT PSNR in walk order,
so that the decay attributes the loss: first-view extrapolation, the
sweep within a direction, or compounding across directions.  A matrix of
the generator's stability knobs (`CONFIGS`) is compared in one run.

  python -m pixelsynth_tpu_torch.tools.scene_drift --workdir build/relay_chain \\
      --npz evidence/relay/stitched.npz --out build/scene_drift.json \\
      --configs reference,fixed,composite,anchor,full

`--workdir` holds `demo_world.npz` (written by the relay chain's data
stage, tools/run_relay.py); the panels of `--dump-dir` are PNGs written by
eval/harness.save_png (no PIL).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

# named knob bundles (SceneGenerator's docstring)
CONFIGS = {
    # reference-faithful walk semantics
    "reference": dict(noise_mode="per_view", carry="decoder", anchor_input=False),
    # one per-scene decoder-noise draw
    "fixed": dict(noise_mode="fixed", carry="decoder", anchor_input=False),
    # deterministic decoder (noise_scale=0)
    "zero": dict(noise_mode="zero", carry="decoder", anchor_input=False),
    # carry the pre-refinement composite instead of the decoder output
    "composite": dict(noise_mode="fixed", carry="composite", anchor_input=False),
    # reset the carry to the true input at the input pose (numerator 0)
    "anchor": dict(noise_mode="fixed", carry="decoder", anchor_input=True),
    # all three levers together
    "full": dict(noise_mode="fixed", carry="composite", anchor_input=True),
    "full_zero": dict(noise_mode="zero", carry="composite", anchor_input=True),
}


def _psnr01(pred01: np.ndarray, gt01: np.ndarray) -> float:
    mse = float(np.mean((pred01 - gt01) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def _to01(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 0.5 + 0.5, 0, 1)


def load_world(path: str) -> Dict:
    """demo_world.npz -> the world dict of data/panorama.py."""
    wfile = np.load(path)
    return {"texture": wfile["texture"], "base_radius": float(wfile["base_radius"]),
            "waves": [tuple(w) for w in wfile["waves"]]}


def walk_and_score(gen, world: Dict, W: int, *, num_split: int,
                   directions, rng_seed: int = 0,
                   dump_dir: Optional[str] = None) -> Dict:
    """Run generate_scene on the held-out world's input view and score every
    rotation-direction view against a GT render at the same camera."""
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras
    from pixelsynth_tpu_torch.data.panorama import render_view
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.eval.homography import consistency_exact
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot, num_split_for_direction

    cams = demo_cameras(1.0)
    gt_in, _ = render_view(world, cams["P"][0], W)   # already [-1, 1]
    img = np.asarray(gt_in, np.float32)[None]

    t0 = time.time()
    outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"],
                                 directions=directions, num_split=num_split,
                                 seed=rng_seed)
    walk_seconds = time.time() - t0

    records: List[Dict] = []
    step = 0
    prev = {}
    for direction in directions:
        n = num_split_for_direction(direction, num_split)
        numerators = [n] + list(reversed(range(n)))
        for numerator in numerators:
            key = f"PredImg_{direction}_{numerator}"
            if key not in outputs:
                step += 1
                continue
            pred01 = _to01(outputs[key][0])
            rec = {"direction": direction, "numerator": int(numerator),
                   "walk_step": step}
            fkey = f"FeaturesImg_{direction}_{numerator}"
            if fkey in outputs:
                # splat coverage proxy: pixels with ~zero feature energy got
                # no point within radius (before bg dilation)
                fs = np.asarray(outputs[fkey][0])
                rec["fs_zero_frac"] = float((np.abs(fs).max(axis=-1) < 1e-6).mean())
            if direction not in ("S", "C"):
                _, P = get_rt_from_rot(direction, cams["P"][0], numerator, n)
                P = np.asarray(P)
                gt, _ = render_view(world, P, W)
                rec["gt_psnr"] = _psnr01(pred01, _to01(gt))
                if dump_dir is not None:
                    os.makedirs(dump_dir, exist_ok=True)
                    row = [_to01(gt), pred01]
                    if fkey in outputs:
                        row.append(_to01(outputs[fkey][0][..., :3]))
                    save_png(os.path.join(dump_dir, f"{step:03d}_{direction}_{numerator}.png"),
                             np.concatenate(row, axis=1))
                if direction in prev:
                    m = consistency_exact(prev[direction][0], pred01,
                                          prev[direction][1], P)
                    rec["adjacent_psnr_vis"] = m["PSNR_vis"]
                prev[direction] = (pred01, P)
            records.append(rec)
            step += 1

    gt_vals = [r["gt_psnr"] for r in records if "gt_psnr" in r]
    adj_vals = [r["adjacent_psnr_vis"] for r in records if "adjacent_psnr_vis" in r]
    by_num: Dict[int, List[float]] = {}
    by_dir: Dict[str, List[float]] = {}
    for r in records:
        if "gt_psnr" in r:
            by_num.setdefault(r["numerator"], []).append(r["gt_psnr"])
            by_dir.setdefault(r["direction"], []).append(r["gt_psnr"])
    first_dir = directions[0]
    return {
        "cloud_valid_count": (int(outputs["CloudValidCount"][0])
                              if "CloudValidCount" in outputs else None),
        "scene_gt_psnr": float(np.mean(gt_vals)) if gt_vals else None,
        "scene_adjacent_consistency_psnr": (
            float(np.mean(adj_vals)) if adj_vals else None),
        "gt_psnr_by_numerator": {
            str(k): float(np.mean(v)) for k, v in sorted(by_num.items())},
        "gt_psnr_by_direction": {k: float(np.mean(v)) for k, v in by_dir.items()},
        "gt_psnr_first_direction": (
            float(np.mean(by_dir[first_dir])) if first_dir in by_dir else None),
        "walk_seconds": walk_seconds,
        "n_views_scored": len(gt_vals),
        "records": records,
    }


def drift(ps, world: Dict, *, configs, num_samples: int = 8,
          num_split: Optional[int] = None, directions=None, seed: int = 0,
          dump_dir: Optional[str] = None, out: Optional[str] = None) -> Dict:
    """walk_and_score of `ps` under each knob bundle named in `configs`;
    results keyed by bundle, plus "meta" (written to `out` after each)."""
    from pixelsynth_tpu_torch.scene import SceneGenerator

    cfg = ps.cfg
    num_split = num_split or cfg.sample.num_split
    directions = list(directions or [d for d in cfg.sample.directions
                                     if d not in ("S", "C")])
    results: Dict[str, Dict] = {"meta": {
        "num_split": num_split, "directions": directions, "num_samples": num_samples,
        "seed": seed, "temperature": cfg.sample.temperature,
    }}
    for name in configs:
        knobs = CONFIGS[name]
        gen = SceneGenerator(ps, num_samples=num_samples, **knobs)
        r = walk_and_score(gen, world, cfg.model.W, num_split=num_split,
                           directions=directions, rng_seed=seed,
                           dump_dir=os.path.join(dump_dir, name) if dump_dir else None)
        r["knobs"] = knobs
        results[name] = r
        print(f"[{name}] gt_psnr={r['scene_gt_psnr']:.2f} "
              f"adj={r['scene_adjacent_consistency_psnr'] or float('nan'):.2f} "
              f"first_dir={r['gt_psnr_first_direction']:.2f} "
              f"({r['walk_seconds']:.0f}s)", flush=True)
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    return results


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workdir", default="build/relay_chain")
    ap.add_argument("--npz", default="evidence/relay/stitched.npz")
    ap.add_argument("--out", default="build/scene_drift.json")
    ap.add_argument("--configs", default="reference,fixed,composite,anchor,full")
    ap.add_argument("--num-samples", type=int, default=8)
    ap.add_argument("--num-split", type=int, default=None)
    ap.add_argument("--directions", default=None,
                    help="comma list; default: checkpoint config minus S/C")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump-dir", default=None,
                    help="save per-view [GT | pred | splat-features] panels")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pixelsynth_tpu_torch import demo as demo_cli

    world = load_world(os.path.join(args.workdir, "demo_world.npz"))
    ps = demo_cli.load_model(args.npz, device=args.device)
    results = drift(ps, world, configs=args.configs.split(","),
                    num_samples=args.num_samples, num_split=args.num_split,
                    directions=args.directions.split(",") if args.directions else None,
                    seed=args.seed, dump_dir=args.dump_dir, out=args.out)
    results["meta"]["npz"] = args.npz
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
