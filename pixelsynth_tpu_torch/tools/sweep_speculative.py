"""Sweep the speculative-decoding depth against the cost of a cell (port of
pixelsynth_tpu/tools/sweep_speculative.py).

`ar_sample_speculative` (sampling.py) commits 1..spec+1 cells per PixelCNN
forward from the exact joint distribution; deeper drafts amortise more
cells per forward but lengthen the accept chain and the per-forward row
gather.  This sweeps `spec` with the Config() PixelCNN (seeded random
weights) at population 16, the right half of the code grid as background
in the order of `ops/orders.custom_order`, through the fused forward (K1):
one JSON line a depth with `spec`, `fill_s` (the mean seconds of a fill,
CUDA events around back-to-back fills), `cell_ms` (fill_s over the
background cells) and `cells_per_fwd`.

Usage: python -m pixelsynth_tpu_torch.tools.sweep_speculative
           [--specs 2,3,4,5,6,8] [--pop 16] [--reps 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pixelsynth_tpu_torch.utils.profiling import time_compiled


@torch.no_grad()
def sweep_speculative(specs: Sequence[int] = (2, 3, 4, 5, 6, 8), pop: int = 16,
                      reps: int = 3, *, cfg=None, device: str = "cuda") -> List[Dict]:
    """One row a depth of `specs` (see the module's docstring); `cfg`
    (default Config()) gives the PixelCNN's sizes."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.models.lmconv import flax_named_params
    from pixelsynth_tpu_torch.ops.lmconv_fused import make_fused_logits_fn, pack_lmconv_params
    from pixelsynth_tpu_torch.ops.orders import custom_order, masks_for_orders_batch
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn, random_pixelcnn_params
    from pixelsynth_tpu_torch.sampling import ar_sample_speculative
    from pixelsynth_tpu_torch.weights import unflatten_tree

    cfg = cfg or Config()
    l = cfg.model.lmconv
    H = Wd = l.obs[1]
    NC = l.num_classes
    model = build_pixelcnn(cfg)
    model.load_flax(unflatten_tree(random_pixelcnn_params(cfg, torch.Generator().manual_seed(0))))
    packed = pack_lmconv_params(flax_named_params(model), nr_resnet=l.nr_resnet,
                                compute_dtype=l.compute_dtype, device=device)
    rng = np.random.default_rng(0)
    bg = np.zeros((1, H, Wd), np.float32)
    bg[:, :, Wd // 2:] = 1.0
    n_bg = int(bg.sum())
    dist = ((1 - bg) * 3 - bg * 2).astype(np.int32)[0]
    order = custom_order(dist)[None]
    a, b, d = masks_for_orders_batch([order[0]], H, Wd, l.kernel_size, l.max_dilation)
    masks1 = torch.as_tensor(np.stack([a, b, d], 1), dtype=torch.float32, device=device)
    codes = torch.as_tensor(rng.integers(0, NC, (1, H, Wd)), dtype=torch.int32, device=device)
    codes_p = codes.repeat(pop, 1, 1)
    order_p = torch.as_tensor(order, device=device).repeat(pop, 1, 1)
    bg_p = torch.as_tensor(bg, device=device).repeat(pop, 1, 1)
    masks_p = masks1.repeat(pop, 1, 1, 1)
    lf = make_fused_logits_fn(packed, masks_p, nr_resnet=l.nr_resnet,
                              max_dilation=l.max_dilation, num_classes=NC,
                              compute_dtype=l.compute_dtype)
    rows = []
    for spec in specs:
        g = torch.Generator(device=device).manual_seed(100)

        def fill(s=spec, **kw):
            return ar_sample_speculative(lf, codes_p, order_p, bg_p, g, num_classes=NC,
                                         temperature=0.7, spec=s, **kw)

        t = time_compiled(fill, reps=reps, warmup=1)
        _, st = fill(return_stats=True)
        rows.append({
            "spec": int(spec), "fill_s": round(t, 3),
            "cell_ms": round(t / n_bg * 1e3, 3),
            "cells_per_fwd": round(float(st["max_n_bg"]) / float(st["n_forwards"]), 2),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: Optional[list] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--specs", default="2,3,4,5,6,8")
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return sweep_speculative([int(s) for s in args.specs.split(",")], args.pop,
                             args.reps, device=args.device)


if __name__ == "__main__":
    main()
