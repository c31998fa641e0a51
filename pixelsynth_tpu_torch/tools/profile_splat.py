"""Time the splat's blend dtype (port of pixelsynth_tpu/tools/profile_splat.py).

The whole splat (binning, K2, background mask) at the bench protocol
(B=2 x 131072 points, W=256, C=64), with `blend_dtype` "float32" (K2's f32
entry) and "bfloat16" (its bf16 entry), on the JAX tool's inputs (the same
numpy draws, bit for bit):
  * `splat_<dt>_dispatch_ms`: one call synchronised at its end, the mean
    of `reps` (CUDA events around each call);
  * `splat_<dt>_ingraph_ms`: `reps` calls back to back between two CUDA
    events, each with its depths nudged by 1e-3 * i (the JAX tool's scan
    body), so that no call repeats another;
then `bf16_max_abs_diff` (the largest |f32 - bf16| of the image),
`bf16_scale` (the f32 image's largest |value|) and `bf16_bg_diff_frac`
(the share of background-mask pixels that differ: 0, since the mask never
sees a bf16 value).

Usage: python -m pixelsynth_tpu_torch.tools.profile_splat [--out FILE.json]
           [--reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, Optional

import numpy as np
import torch

from pixelsynth_tpu_torch.utils.profiling import time_compiled

DTYPES = ("float32", "bfloat16")


def _inputs(device: str = "cpu"):
    """The JAX tool's `_inputs()`: W=256, 2 images x 131072 points, C=64,
    from np.random.default_rng(0). -> (W, pts, fts, vld) tensors."""
    W, N, B = 256, 65536 * 2, 2
    rng = np.random.default_rng(0)
    pts = np.stack([
        rng.uniform(-5, W + 5, (B, N)),
        rng.uniform(-5, W + 5, (B, N)),
        rng.uniform(0.5, 10.0, (B, N)),
    ], -1).astype(np.float32)
    fts = rng.normal(size=(B, N, 64)).astype(np.float32)
    vld = rng.random((B, N)) < 0.9
    return (W, torch.as_tensor(pts, device=device), torch.as_tensor(fts, device=device),
            torch.as_tensor(vld, device=device))


def nudged_splat(pts, fts, vld, W, cfg):
    """fn() -> the splat with its depths nudged by 1e-3 more at each call
    (the JAX tool's scan body), so that no call repeats another."""
    from pixelsynth_tpu_torch.ops.splat import splat

    calls = itertools.count()

    def fn():
        p = pts.clone()
        p[..., 2] += 1e-3 * next(calls)
        return splat(p, fts, vld, W=W, cfg=cfg)
    return fn


@torch.no_grad()
def time_splat(blend_dtype: str, reps: int = 10, *, inputs=None, device: str = "cuda"):
    """(dispatch_ms, ingraph_ms, image, background) of the splat at
    `blend_dtype` on `inputs` (default `_inputs(device)`)."""
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops.splat import splat

    W, pts, fts, vld = inputs or _inputs(device)
    cfg = SplatConfig(blend_dtype=blend_dtype)
    dispatch = time_compiled(lambda: splat(pts, fts, vld, W=W, cfg=cfg), reps=reps,
                             sync_each=True)
    ingraph = time_compiled(nudged_splat(pts, fts, vld, W, cfg), reps=reps)
    img, bg = splat(pts, fts, vld, W=W, cfg=cfg)
    return round(dispatch * 1e3, 2), round(ingraph * 1e3, 2), img, bg


def profile_splat(reps: int = 10, *, inputs=None, device: str = "cuda") -> Dict:
    inputs = inputs or _inputs(device)
    result: Dict = {
        "protocol": (f"B=2 x 131072 pts, W=256, C=64, argsort binning, reps={reps}; "
                     "dispatch = CUDA events around each synchronised call, in-graph "
                     "= CUDA events around reps back-to-back calls (depths nudged)"),
    }
    images = {}
    for dt in DTYPES:
        disp, ingraph, img, bg = time_splat(dt, reps, inputs=inputs, device=device)
        result[f"splat_{dt}_dispatch_ms"] = disp
        result[f"splat_{dt}_ingraph_ms"] = ingraph
        images[dt] = (img, bg)
    (i32, b32), (ib, bb) = images["float32"], images["bfloat16"]
    result["bf16_max_abs_diff"] = float((i32 - ib).abs().max())
    result["bf16_scale"] = float(i32.abs().max())
    result["bf16_bg_diff_frac"] = float((b32 != bb).float().mean())
    return result


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = profile_splat(args.reps, device=args.device)
    out = json.dumps(result, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return result


if __name__ == "__main__":
    main()
