"""Which draw carries a walk seed that collapses?  The port only, on the
card (or `--device cpu`).

On one stitched checkpoint, walks the held-out demo world at each of
`--seeds` (the relay walk: the checkpoint's settings, the scene's fixed
decoder noise) and then the two walks of `--swap A,B` in which each seed
keeps its own view draws (the sampler's seed of every view) and takes the
other seed's scene noise (the one decoder-noise seed the walk reuses at
every view).  The swap wraps the generator's generate_view and replaces
the noise seed that generate_scene hands it; generate_scene itself is
unchanged (the JAX package's has no such argument).  Per walk: the relay
gate's scores and 40 scored views, the PSNR against the world's render of
every view of the eight directions (numerator 0 too) in walk order, each
view's candidates (D scores, entropies, the chosen one), and a strip
(`strip_<walk>.png`: a row a direction, numerators 2, 4, 6, 8 of 8 and
the render at 8, each at half size).  The first walk is also rerun through
generate_scene unwrapped, to show that the wrapper alone changes nothing.

  python3 scripts/walk_parity/collapse.py --ckpt build/relay_chain_fast/evidence/stitched.npz \\
      --seeds 0,1,6 --swap 0,1 --out build/walk_parity/card/collapse

Writes <out>/collapse.json and the strips; the walks' PNGs go under
build/walk_parity/collapse/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402

from pixelsynth_tpu_torch import demo  # noqa: E402
from pixelsynth_tpu_torch.data.demo_data import demo_cameras, load_demo_image  # noqa: E402
from pixelsynth_tpu_torch.data.panorama import render_view  # noqa: E402
from pixelsynth_tpu_torch.eval.harness import save_png  # noqa: E402
from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics  # noqa: E402
from pixelsynth_tpu_torch.geometry.paths import (  # noqa: E402
    get_rt_from_rot, num_split_for_direction,
)
from pixelsynth_tpu_torch.scene import SceneGenerator  # noqa: E402
from pixelsynth_tpu_torch.tools.relay_walk_spread import record_steps, walk_names  # noqa: E402


def scene_noise_of(seed: int) -> int:
    """The decoder-noise seed generate_scene draws first from its seed."""
    return int(torch.randint(1 << 62, (1,), generator=torch.Generator().manual_seed(seed)))


def with_noise(gen, noise_seed):
    """Wrap gen.generate_view so that every view takes `noise_seed` for its
    decoder noise (None: as generate_scene hands it)."""
    inner = gen.generate_view

    def generate_view(img, cams, cloud, last_bg, RTinv_last, seed=0, noise_seed_=None):
        return inner(img, cams, cloud, last_bg, RTinv_last, seed,
                     noise_seed if noise_seed is not None else noise_seed_)

    gen.generate_view = generate_view


def psnr01(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def strip(outputs, world, cfg, P_in):
    """A row a direction: numerators 2, 4, 6, 8 and the render at 8, each
    2x2-box downsampled."""
    W = cfg.model.W
    half = lambda x: x.reshape(W // 2, 2, W // 2, 2, 3).mean((1, 3))  # noqa: E731
    rows = []
    for d in cfg.sample.directions:
        if d in ("S", "C"):
            continue
        n = num_split_for_direction(d, cfg.sample.num_split)
        tiles = [outputs[f"PredImg_{d}_{i}"][0] * 0.5 + 0.5
                 for i in (n // 4, n // 2, 3 * n // 4, n)]
        gt, _ = render_view(world, get_rt_from_rot(d, P_in, n, n)[1], W)
        tiles.append(gt * 0.5 + 0.5)
        rows.append(np.concatenate([half(np.clip(t, 0, 1)) for t in tiles], 1))
    return np.concatenate(rows, 0)


def view_gt(outputs, world, cfg, P_in):
    """PSNR against the world's render of every view of the eight
    directions, in walk order."""
    out = []
    for d in cfg.sample.directions:
        if d in ("S", "C"):
            continue
        n = num_split_for_direction(d, cfg.sample.num_split)
        for i in [n] + list(reversed(range(n))):
            gt, _ = render_view(world, get_rt_from_rot(d, P_in, i, n)[1], cfg.model.W)
            out.append({"view": f"{d}_{i}", "gt": psnr01(
                outputs[f"PredImg_{d}_{i}"][0] * 0.5 + 0.5, gt * 0.5 + 0.5)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--seeds", default="0,1,6")
    ap.add_argument("--swap", default="0,1")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rehearse", action="store_true",
                    help="walk R and L at num_split 4 only (a CPU rehearsal)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    work = os.path.join(common.WORK, "collapse")
    ps = demo.load_model(args.ckpt, device=args.device)
    cfg = ps.cfg
    if args.rehearse:
        cfg.sample.directions, cfg.sample.num_split = ["R", "L"], 4
    world, inp = common.demo_input(work, cfg.model.W)
    img, ratio = load_demo_image(inp, cfg.model.W)
    cams = demo_cameras(ratio)
    P_in = cams["P"][0]
    names = walk_names(cfg.sample)
    a, b = common.parse_seeds(args.swap)
    walks = [(f"seed{s}", s, None) for s in common.parse_seeds(args.seeds)]
    walks += [(f"views{a}_noise{b}", a, b), (f"views{b}_noise{a}", b, a)]
    record = {"ckpt": os.path.relpath(os.path.abspath(args.ckpt), common.REPO),
              "sha256": common.file_sha256(args.ckpt), "card": common.card_line(),
              "noise_mode": SceneGenerator(ps).noise_mode, "walks": {}}
    first_outputs = None
    for name, seed, noise_from in walks:
        gen = SceneGenerator(ps)
        assert gen.noise_mode == "fixed", gen.noise_mode
        if noise_from is not None:
            with_noise(gen, scene_noise_of(noise_from))
        steps = record_steps(gen, names)
        t0 = time.perf_counter()
        outputs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"],
                                     seed=seed)
        secs = time.perf_counter() - t0
        if first_outputs is None:
            first_outputs = outputs
        scene_dir = os.path.join(work, name)
        demo.save_scene(outputs, cfg, scene_dir)
        m = scene_walk_metrics(cfg, world, scene_dir, per_view=True)
        save_png(os.path.join(args.out, f"strip_{name}.png"), strip(outputs, world, cfg, P_in))
        record["walks"][name] = {
            "view_seed": seed, "noise_seed_from": seed if noise_from is None else noise_from,
            "gt": m["scene_gt_psnr"], "adjacent": m["scene_adjacent_consistency_psnr"],
            "by_numerator": m["scene_gt_psnr_by_numerator"], "views": m["scene_views"],
            "view_gt": view_gt(outputs, world, cfg, P_in), "steps": steps, "seconds": secs}
        print(f"[collapse] {name}: gt {m['scene_gt_psnr']:.4f} adjacent "
              f"{m['scene_adjacent_consistency_psnr']:.4f} ({secs:.1f} s)", flush=True)
    # the wrapper alone (the first walk's own noise through it) changes nothing
    name, seed, _ = walks[0]
    gen = SceneGenerator(ps)
    with_noise(gen, scene_noise_of(seed))
    again = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"], seed=seed)
    record["wrapper_max_abs_diff"] = max(
        float(np.abs(again[k] - first_outputs[k]).max()) for k in again
        if k.startswith("PredImg_"))
    print(f"[collapse] wrapper alone: max |diff| {record['wrapper_max_abs_diff']:.3g}")
    with open(os.path.join(args.out, "collapse.json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
