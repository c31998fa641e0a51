"""Sweep the splat's tiling knobs (port of pixelsynth_tpu/tools/tune_splat.py).

The knobs, and which the port reads:
  - tile_size: pixels per tile edge (>= 2 * radius).  K2 takes multiples
    of 8 up to 32 and refuses any other;
  - max_points_per_tile: the binner's per-tile capacity M (the tables K2
    walks; too small drops points);
  - tile_group: tiles a group of the PLAIN blend and of the backward's
    recompute.  K2 does not read it (one launch covers every tile), so on
    the card a row that differs from the default only in tile_group
    measures noise.

Two protocols, each configuration timed as `reps` back-to-back splats
(depths nudged by 1e-3 * i, as the JAX tool's scan body) between two CUDA
events:

  bench: B=2 x 131072 points, W=256, C=64;
  walk:  the scene walk's cumulative splat (B=1, 16384 current +
         cloud-capacity carried points, W=128, C=64), for three carried
         capacities.

Correctness guard: every configuration's image and background mask are
compared with the default configuration's on the same inputs
(`max_abs_delta`, `bg_delta_frac`).  A configuration that K2 refuses or
that runs out of memory is recorded as "failed: ...".

Usage: python -m pixelsynth_tpu_torch.tools.tune_splat [--out FILE.json]
           [--reps 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List, Optional

import numpy as np
import torch


def _inputs(W: int, N: int, B: int, seed: int = 0, device: str = "cpu"):
    """The JAX tool's `_inputs(W, N, B, seed)` (the same numpy draws) as
    tensors: (pts (B, N, 3), fts (B, N, 64), vld (B, N))."""
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.uniform(-5, W + 5, (B, N)),
        rng.uniform(-5, W + 5, (B, N)),
        rng.uniform(0.5, 10.0, (B, N)),
    ], -1).astype(np.float32)
    fts = rng.normal(size=(B, N, 64)).astype(np.float32)
    vld = rng.random((B, N)) < 0.9
    return (torch.as_tensor(pts, device=device), torch.as_tensor(fts, device=device),
            torch.as_tensor(vld, device=device))


@torch.no_grad()
def time_cfg(W, pts, fts, vld, cfg, reps: int):
    """(ms a splat over `reps` back-to-back nudged calls, the image, the
    background mask) as numpy."""
    from pixelsynth_tpu_torch.ops.splat import splat
    from pixelsynth_tpu_torch.tools.profile_splat import nudged_splat
    from pixelsynth_tpu_torch.utils.profiling import time_compiled

    ms = time_compiled(nudged_splat(pts, fts, vld, W, cfg), reps=reps) * 1e3
    img, bg = splat(pts, fts, vld, W=W, cfg=cfg)
    return ms, img.cpu().numpy(), bg.cpu().numpy()


def sweep(W, N, B, grid, reps, base_cfg_kwargs=None, device: str = "cuda") -> List[Dict]:
    """The JAX tool's rows: the default configuration, then each (tile_size,
    max_points_per_tile, tile_group) of `grid` with its ms and its
    distance from the default's image and mask."""
    from pixelsynth_tpu_torch.config import SplatConfig

    pts, fts, vld = _inputs(W, N, B, device=device)
    base = SplatConfig(**(base_cfg_kwargs or {}))
    base_ms, base_img, base_bg = time_cfg(W, pts, fts, vld, base, reps)
    rows = [{"knobs": "default", "tile_size": base.tile_size,
             "max_points_per_tile": base.max_points_per_tile,
             "tile_group": base.tile_group, "ms": round(base_ms, 2),
             "max_abs_delta": 0.0, "bg_delta_frac": 0.0}]
    for ts, M, G in grid:
        if ts < 2 * base.radius:
            continue
        cfg = SplatConfig(**{**(base_cfg_kwargs or {}),
                             "tile_size": ts, "max_points_per_tile": M,
                             "tile_group": G})
        try:
            ms, img, bg = time_cfg(W, pts, fts, vld, cfg, reps)
        except (ValueError, RuntimeError) as e:   # refused by K2, out of memory
            rows.append({"tile_size": ts, "max_points_per_tile": M,
                         "tile_group": G, "ms": f"failed: {e}"[:120]})
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            continue
        rows.append({
            "tile_size": ts, "max_points_per_tile": M, "tile_group": G,
            "ms": round(ms, 2),
            "max_abs_delta": round(float(np.max(np.abs(img - base_img))), 5),
            "bg_delta_frac": round(float(np.mean(bg != base_bg)), 5),
        })
        print(rows[-1], flush=True)
    return rows


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    grid = list(itertools.product((16, 32), (512, 1024, 2048, 4096),
                                  (8, 16, 32, 64)))

    print("== bench protocol (B=2 x 131072, W=256) ==", flush=True)
    bench_rows = sweep(256, 65536 * 2, 2, grid, args.reps, device=args.device)

    print("== walk protocol (B=1, 16384 + capacity, W=128) ==", flush=True)
    walk = {}
    for cap in (262144, 131072, 65536):
        print(f"-- capacity {cap} --", flush=True)
        walk[str(cap)] = sweep(128, 16384 + cap, 1,
                               [(16, 2048, 32), (16, 1024, 32),
                                (32, 2048, 16), (16, 2048, 64)],
                               args.reps, device=args.device)

    out = {"bench": bench_rows, "walk_by_capacity": walk}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
