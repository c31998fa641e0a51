"""The spread of the relay gate's scene-walk metrics over walk seeds, on the
card.

  python3 -m pixelsynth_tpu_torch.tools.relay_walk_spread [--seeds 0-7] \
      [--ckpt evidence/relay/stitched.npz] [--out spread.json] \
      [--temperature T] [--noise-mode fixed|zero|per_view] [--num-samples S] \
      [--tf32]

The relay gate (eval/relay_report.py) scores ONE demo-CLI walk of the
held-out world (seed 0): a single stochastic trajectory of 82 views whose
samples, candidates and carried cloud compound from view to view.  This
runs that walk (the checkpoint's settings: 8 samples, T = 0.7, fixed
decoder noise, unless overridden) at each seed as the demo CLI's
`--mode gen_scene` does (its load_model, SceneGenerator, generate_scene
and save_scene; the model is loaded once) and prints, per seed, the
adjacent-view consistency, the PSNR against the world's renders and its
numerator-1 and last-numerator means, then their mean, spread and range,
beside the card's name and power limit.  Each seed's row also holds its 40
scored views (gt PSNR and adjacency, "views") and, for each of the 82
views, the candidates' D scores and entropies, the chosen candidate and
the cloud's valid count ("steps").  --ckpt names the stitched checkpoint
(default the JAX package's artifact), --out a JSON file for the record.
Writes the walks under build/relay/spread/.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
METRICS = ("adjacent", "gt", "num_first", "num_last")


def parse_seeds(text: str) -> List[int]:
    """"0-7" or "0,1,6" -> a list of seeds."""
    out: List[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def record_steps(gen, names: Sequence[str]) -> List[Dict]:
    """Wrap this generator's generate_view so that each view of one walk
    appends {"view", "chosen", "d_scores", "entropy", "cloud_valid"} to the
    list returned (B = 1); wrap a fresh generator for each walk."""
    from pixelsynth_tpu_torch.sampling import rank_candidates

    steps: List[Dict] = []
    inner = gen.generate_view

    def generate_view(*a, **kw):
        best, out = inner(*a, **kw)
        d, e = out["d_scores"], out["entropy"]
        steps.append({"view": names[len(steps)],
                      "chosen": int(rank_candidates(d, e)),
                      "d_scores": d.double().cpu().tolist(),
                      "entropy": e.double().cpu().tolist(),
                      "cloud_valid": int(out["cloud"].valid.sum())})
        return best, out

    gen.generate_view = generate_view
    return steps


def walk_names(sample_cfg) -> List[str]:
    """The views of a non-sequential walk in generate_scene's order."""
    from pixelsynth_tpu_torch.geometry.paths import num_split_for_direction

    names = []
    for d in sample_cfg.directions:
        n = num_split_for_direction(d, sample_cfg.num_split)
        names.extend(f"{d}_{i}" for i in [n] + list(reversed(range(n))))
    return names


def walk_row(seed: int, metrics: Dict, seconds: float, steps: List[Dict]) -> Dict:
    """One walk scored as the relay gate scores it (scene_walk_metrics with
    per_view): adjacency, gt PSNR, its first- and last-numerator means, the
    seconds, the 40 scored views ("views") and every view's candidates
    ("steps")."""
    by_num = metrics["scene_gt_psnr_by_numerator"]
    nums = sorted(by_num, key=int)
    return {"seed": seed, "adjacent": metrics["scene_adjacent_consistency_psnr"],
            "gt": metrics["scene_gt_psnr"], "num_first": by_num[nums[0]],
            "num_last": by_num[nums[-1]], "seconds": seconds,
            "views": metrics["scene_views"], "steps": steps}


def summarize(rows: Sequence[Dict]) -> Dict[str, Dict[str, float]]:
    """{metric: {"mean", "sd" (ddof 1), "min", "max", "n"}} over seeds."""
    summary = {}
    for k in METRICS:
        v = np.array([r[k] for r in rows])
        summary[k] = {"mean": float(v.mean()),
                      "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
                      "min": float(v.min()), "max": float(v.max()), "n": int(len(v))}
    return summary


def walk_spread(ckpt: str, seeds: Sequence[int], out: str, *,
                device="cuda", temperature: Optional[float] = None,
                noise_mode: Optional[str] = None,
                num_samples: Optional[int] = None) -> Dict:
    """The demo CLI's walk of the held-out world on `ckpt` at `seeds`,
    each scored as the relay gate scores it -> {"ckpt",
    "sha256", "settings", "rows": [per seed], "summary": {metric: mean,
    sd, min, max, n}, "card"}.  The walks go under `out`."""
    from pixelsynth_tpu_torch import demo
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras, load_demo_image
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.eval.harness import save_png
    from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics
    from pixelsynth_tpu_torch.scene import SceneGenerator

    ps = demo.load_model(ckpt, device=device)
    cfg = ps.cfg
    world, img, _ = heldout_demo_world(cfg.model.W)
    inp = save_png(os.path.join(out, "demo_input.png"), img)
    img, ratio = load_demo_image(inp, cfg.model.W)
    cams = demo_cameras(ratio)
    def make():
        return SceneGenerator(ps, num_samples=num_samples, temperature=temperature,
                              noise_mode=noise_mode)

    gen = make()
    names = walk_names(cfg.sample)
    rows = []
    for seed in seeds:
        scene_dir = os.path.join(out, f"seed{seed}")
        # a generator a seed: record_steps wraps its generate_view
        gen = make()
        steps = record_steps(gen, names)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"],
                                     cams["Pinv"], seed=seed)
        secs = time.perf_counter() - t0
        demo.save_scene(outputs, cfg, scene_dir)
        row = walk_row(seed, scene_walk_metrics(cfg, world, scene_dir, scene_dir,
                                                per_view=True), secs, steps)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k not in ("views", "steps")}),
              flush=True)
    summary = summarize(rows)
    for k, s in summary.items():
        print(f"{k}: mean {s['mean']:.4f}, sd {s['sd']:.4f}, min {s['min']:.4f}, "
              f"max {s['max']:.4f} over {s['n']} seeds")
    card = "cpu"
    if torch.device(device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    print(f"[card] {card}")
    ckpt_path = os.path.abspath(ckpt)
    return {"ckpt": os.path.relpath(ckpt_path, REPO), "sha256": file_sha256(ckpt_path),
            "settings": {"num_samples": gen.num_samples, "temperature": gen.temperature,
                         "noise_mode": gen.noise_mode, "carry": gen.carry,
                         "speculative": cfg.sample.speculative,
                         "cloud_capacity": gen.cloud_capacity},
            "tf32": (torch.backends.cudnn.allow_tf32
                     if torch.device(device).type == "cuda" else None),
            "rows": rows, "summary": summary, "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-7", help='"0-7" or "0,1,6"')
    ap.add_argument("--ckpt", default=os.path.join(REPO, "evidence", "relay", "stitched.npz"),
                    help="a stitched checkpoint (default: the JAX package's artifact)")
    ap.add_argument("--out", default=None, help="write the record as JSON here")
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--noise-mode", default=None, choices=["per_view", "fixed", "zero"])
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--tf32", action="store_true",
                    help="leave TF32 matmuls and convolutions at the library's "
                         "defaults (by default they are off, as in chip_smoke.py)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("relay_walk_spread: no CUDA device")
    if not args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    got = walk_spread(args.ckpt, parse_seeds(args.seeds),
                      os.path.join(REPO, "build", "relay", "spread"),
                      temperature=args.temperature, noise_mode=args.noise_mode,
                      num_samples=args.num_samples)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)


if __name__ == "__main__":
    main()
