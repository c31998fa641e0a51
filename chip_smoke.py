#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero and never
prints the final ok line):
  1. build the CUDA kernels (all nvcc processes started together) and
     print the toolchain and the card;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (K1: pop 16, 32x32 codes, F=80, bf16; K2: W=256, 2 images x
     131072 points, each accumulation), timed with CUDA events;
  3. the main path at full width: one `generate_view` at the Config()
     defaults (W=256, 32x32 codes, nr_filters 80, speculative 12) with
     seeded random weights and 16 candidates; the kernels' launch counts
     are zeroed just before the timed view and read just after;
  4. the trained relay checkpoint (evidence/relay/stitched.npz, W=128)
     through the weight bridge, walking directions R and L.
It ends with a `kernels` JSON line, the card's name and power limit, and
the result line {"ok": true, "device": {...}}.

TF32 is off for both matmuls and convolutions (set below), so float32
references are full float32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, reps=10, rounds=5):
    """Device time of one fn() call, after warm-up: CUDA events around
    `reps` back-to-back calls (so the host's launch work overlaps the
    device's), divided by `reps`; the median of `rounds` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    times.sort()
    return times[len(times) // 2]


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_build():
    import torch
    from pixelsynth_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    logs = _cuda.build(["lmconv_fused", "splat_blend"], verbose=True)
    log(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    log(f"[card] {card_line()}")


def _k1_inputs(B=16, side=32, Fc=80, seed=0):
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
    from pixelsynth_tpu_torch.ops.lmconv_fused import (
        embed_input, fold_boundary_masks, pack_lmconv_params)
    from pixelsynth_tpu_torch.ops.orders import orders_and_masks
    from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params

    cfg = Config()
    cfg.model.lmconv.nr_filters = Fc
    gen = torch.Generator().manual_seed(seed)
    packed = pack_lmconv_params(random_pixelcnn_params(cfg, gen), nr_resnet=2,
                                device=DEVICE)
    rng = np.random.default_rng(seed)
    bg = np.zeros((1, side, side), np.float32)
    bg[:, :, side // 2:] = 1.0          # right half to outpaint
    fg_t = torch.as_tensor(1.0 - bg, device=DEVICE)
    dist = signed_distance_field(fg_t, torch.as_tensor(bg, device=DEVICE))
    _, masks = orders_and_masks(dist)
    masks = masks.repeat(B, 1, 1, 1)
    codes = torch.as_tensor(rng.integers(0, 512, (B, side, side)), device=DEVICE)
    filled = torch.as_tensor(rng.random((B, side, side)) < 0.6, device=DEVICE).float()
    u0 = embed_input(packed, codes, filled, masks[:, 0], num_classes=512)
    mu = fold_boundary_masks(masks[:, 1], side, side, 3, 1)
    md = fold_boundary_masks(masks[:, 2], side, side, 3, 2)
    return packed, u0, mu, md, codes, filled, masks


def _k1_flops(mu, md, Fc, nr=2):
    """Multiply-adds the masked convs need on these masks (taps whose mask
    is 0 need none), x2 -> FLOP; split into (up, down)."""
    B, HW, _ = mu.shape
    on_u = float(mu.sum())      # active (position, tap) pairs, all candidates
    on_d = float(md.sum())
    gated = on_u * (2 * Fc * Fc + 2 * Fc * 2 * Fc) * 2
    dil = on_d * Fc * Fc * 2
    nin = B * HW * 2 * Fc * Fc * 2
    up = 3 * nr * gated + 2 * dil
    down = (3 * nr + 2) * (gated + nin) + 2 * dil
    return up, down


def phase_k1(report, B=16, side=32, Fc=80):
    import torch
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1

    packed, u0, mu, md, codes, filled, masks = _k1_inputs(B, side, Fc)
    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16")
    stack_k = K1.up(u0, mu, md, packed, **kw)
    stack_p = K1.up_plain(u0, mu, md, packed, W=side, nr=2, dilation=2,
                          compute_dtype="bfloat16")
    out_k = K1.down(stack_p, mu, md, packed, **kw)
    out_p = K1.down_plain(stack_p, mu, md, packed, W=side, nr=2, dilation=2,
                          compute_dtype="bfloat16")
    torch.cuda.synchronize()
    err_up = float((stack_k.float() - stack_p.float()).abs().max())
    err_dn = float((out_k - out_p).abs().max())
    ref_up = float(stack_p.float().abs().max())
    ref_dn = float(out_p.abs().max())
    # whole forward, kernels vs plain: logits argmax agreement
    lk = torch.nn.functional.elu(K1.down(stack_k, mu, md, packed, **kw)) @ packed["nin_w"]
    lp = torch.nn.functional.elu(out_p) @ packed["nin_w"]
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    # bf16 operands and a bf16 skip stack: where the f32 sums of the two
    # versions (different summation orders) straddle a bf16 rounding
    # boundary they differ by one bf16 ulp, which later layers carry; the
    # tolerance is 2% of the activations' range, as the JAX package's
    # bf16 fused-vs-module test holds logits to argmax agreement >= 0.97
    tol_up, tol_dn = 0.02 * max(1.0, ref_up), 0.02 * max(1.0, ref_dn)
    log(f"[K1] up   max|kernel-plain| {err_up:.3e} (max|ref| {ref_up:.2f}, tol {tol_up:.3e})")
    log(f"[K1] down max|kernel-plain| {err_dn:.3e} (max|ref| {ref_dn:.2f}, tol {tol_dn:.3e})")
    log(f"[K1] logits argmax agreement {agree:.4f} (tol >= 0.97)")
    if not (err_up <= tol_up and err_dn <= tol_dn and agree >= 0.97):
        raise AssertionError("K1 disagrees with its plain version")

    up_ms = time_ms(lambda: K1.up(u0, mu, md, packed, **kw))
    dn_ms = time_ms(lambda: K1.down(stack_p, mu, md, packed, **kw))
    up_plain_ms = time_ms(lambda: K1.up_plain(u0, mu, md, packed, W=side, nr=2,
                                              dilation=2, compute_dtype="bfloat16"))
    dn_plain_ms = time_ms(lambda: K1.down_plain(stack_p, mu, md, packed, W=side,
                                                nr=2, dilation=2,
                                                compute_dtype="bfloat16"))
    f_up, f_dn = _k1_flops(mu, md, Fc)
    def wbytes(names):
        return sum(packed[k].numel() * packed[k].element_size() for k in names)

    masks_b = (mu.numel() + md.numel()) * 4
    by_up = (u0.numel() * 4 + masks_b + stack_k.numel() * 2
             + wbytes(("uw1", "ub1", "uw2", "ub2", "udw", "udb")))
    by_dn = (stack_k.numel() * 2 + masks_b + out_k.numel() * 4
             + wbytes(("dw1", "db1", "dws", "dbs", "dw2", "db2", "ddw", "ddb")))
    for name, ms, pms, fl, by, err, line in (
            ("lmconv_up", up_ms, up_plain_ms, f_up, by_up, err_up, 151),
            ("lmconv_down", dn_ms, dn_plain_ms, f_dn, by_dn, err_dn, 178)):
        t_ops, t_bytes = fl / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "pixelsynth_tpu_torch/csrc/lmconv_fused.cu",
            "replaces": f"pixelsynth_tpu/ops/lmconv_fused.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
        log(f"[K1] {name}: {ms:.3f} ms kernel, {pms:.3f} ms plain, "
            f"{fl / 1e9:.2f} GFLOP needed, bound {max(t_ops, t_bytes):.4f} ms")


def _k2_inputs(seed=0, C=3, W=256, N=65536 * 2):
    """The bench.py splat protocol (bench.py:33-45): W=256, 2 images x
    131072 points, with C=3 RGB features as on the main path."""
    import numpy as np
    import torch

    B = 2
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, W + 5, (B, N)), rng.uniform(-5, W + 5, (B, N)),
                    rng.uniform(0.5, 10.0, (B, N))], -1).astype(np.float32)
    fts = rng.normal(size=(B, N, C)).astype(np.float32)
    vld = rng.random((B, N)) < 0.9
    return (W, torch.as_tensor(pts, device=DEVICE), torch.as_tensor(fts, device=DEVICE),
            torch.as_tensor(vld, device=DEVICE))


def phase_k2(report, W=256, N=65536 * 2):
    import dataclasses
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import splat as K2

    W, pts, fts, vld = _k2_inputs(W=W, N=N)
    cfg = SplatConfig()
    B = pts.shape[0]
    slot_idx, slot_valid, counts = K2._bin_points_batched(pts, vld, W, cfg,
                                                          return_counts=True)
    over = torch.clamp(counts - cfg.max_points_per_tile, min=0)
    log(f"[K2] binning: max entries per tile {int(counts.max())}, "
        f"M={cfg.max_points_per_tile}, tiles over capacity {int((over > 0).sum())}, "
        f"entries dropped {int(over.sum())}")
    spts, sfts, svld = K2.gather_slots(pts, fts, slot_idx, slot_valid)
    org = K2.tile_origins(W, cfg.tile_size, pts.device).repeat(B, 1)
    errs = {}
    for acc in ("alphacomposite", "wsum", "wsumnorm"):
        c = dataclasses.replace(cfg, accumulation=acc)
        ok, ck = K2.blend_tiles(spts, sfts, svld, org, W, c)
        op, cp = K2.blend_tiles_plain(spts, sfts, svld, org, W, c)
        torch.cuda.synchronize()
        err = float((ok - op).abs().max())
        # fp32 both sides; the kernel folds the NDC scale into one multiply
        # and sums front to back where cumprod/matmul sum in other orders
        close = bool(torch.allclose(ok, op, atol=5e-4, rtol=1e-3))
        same_cov = bool(torch.equal(ck, cp))
        errs[acc] = err
        log(f"[K2] {acc}: max|kernel-plain| {err:.3e} (atol 5e-4, rtol 1e-3) "
            f"allclose={close} coverage identical={same_cov}")
        if not (close and same_cov):
            raise AssertionError(f"K2 disagrees with its plain version ({acc})")
    ms = time_ms(lambda: K2.blend_tiles(spts, sfts, svld, org, W, cfg))
    pms = time_ms(lambda: K2.blend_tiles_plain(spts, sfts, svld, org, W, cfg))
    P = cfg.tile_size ** 2
    pairs = float(svld.sum()) * P          # pixel x valid-slot pairs
    flops = pairs * 6                      # 2 sub, 2 mul-add, compare, count
    T, M = svld.shape
    by = T * M * (3 * 4 + 3 * 4 + 1) + T * P * (3 * 4 + 1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, by / PEAK_BYTES * 1e3
    report["splat_blend"] = {
        "name": "splat_blend", "route": "cuda",
        "source": "pixelsynth_tpu_torch/csrc/splat_blend.cu",
        "replaces": "pixelsynth_tpu/ops/splat_pallas.py:40",
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": pms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}
    log(f"[K2] splat_blend: {ms:.3f} ms kernel, {pms:.3f} ms plain, "
        f"{pairs / 1e6:.1f} M pixel x slot pairs, bound {max(t_ops, t_bytes):.4f} ms")


def _view_inputs(W, seed=0):
    """A structured input image from a seed (smooth colour gradients plus
    noise, in [-1, 1]) and the demo cameras."""
    import numpy as np
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, W), indexing="ij")
    img = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1)
    img = np.clip(0.8 * img + 0.1 * rng.normal(size=img.shape), -1, 1)
    return img[None].astype(np.float32), demo_cameras(1.0)


def phase_view(report, cfg=None):
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.ops import lmconv_fused, splat
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator, StageTimer

    cfg = cfg or Config()
    # every stage of the view step, re-ranking by classifier entropy included
    ps = PixelSynth(cfg, device=DEVICE, seed=0, with_classifier=True)
    gen = SceneGenerator(ps, num_samples=16)
    W = cfg.model.W
    img, cams = _view_inputs(W)
    _, RT = get_rt_from_rot("R", cams["P"], scene_mode=False, rotation=0.3)
    view_cams = {"K": cams["K"], "Kinv": cams["Kinv"], "P_in": cams["P"],
                 "Pinv_in": cams["Pinv"], "P_out": RT}

    def run(seed):
        cloud = CloudState.empty(1, W * W, 3, DEVICE)
        return gen.generate_view(img, view_cams, cloud, None, cams["Pinv"], seed)

    run(1)                                   # warm-up
    torch.cuda.synchronize()
    for counts in (lmconv_fused.LAUNCHES, splat.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    gen.timer = StageTimer(DEVICE)
    t0 = time.perf_counter()
    best, out = run(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = gen.timer.times_ms()
    launches = {**lmconv_fused.LAUNCHES, **splat.LAUNCHES}
    st = out["ar_stats"]
    n_bg = int((out["bg_ds"] >= 1 - 1e-6).sum())
    log(f"[view] W={W} codes {cfg.model.lmconv.obs[1]}x{cfg.model.lmconv.obs[2]} "
        f"F={cfg.model.lmconv.nr_filters} spec={cfg.sample.speculative} pop 16: "
        f"{wall * 1e3:.1f} ms wall (second call)")
    log("[view] stage ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log(f"[view] background cells {n_bg}, AR forwards {st['n_forwards']}, "
        f"cells committed per forward {n_bg / max(1, st['n_forwards']):.2f}")
    log(f"[view] launches in the timed view: {json.dumps(launches)}")
    bi = best.float()
    if not (bool(torch.isfinite(bi).all()) and tuple(bi.shape) == (1, W, W, 3)
            and float(bi.abs().max()) <= 1.0):
        raise AssertionError("view output is not a finite image in [-1, 1]")
    if n_bg == 0 or st["n_forwards"] == 0:
        raise AssertionError("the view had nothing to outpaint")
    for name in report:
        report[name]["launches"] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    # capacity truncation of this view's splat (the view's own points)
    from pixelsynth_tpu_torch.geometry.projection import (
        homogeneous_to_pixels, lift_to_cloud)
    c = gen._cams(view_cams)
    cloud = lift_to_cloud(out["depth"], c["K"], c["Kinv"], c["Pinv_in"], c["P_out"], W)
    pts, valid = homogeneous_to_pixels(cloud, W)
    _, _, counts = splat._bin_points_batched(pts, valid, W, cfg.model.splat,
                                             return_counts=True)
    over = torch.clamp(counts - cfg.model.splat.max_points_per_tile, min=0)
    log(f"[view] splat: max entries per tile {int(counts.max())}, entries over "
        f"max_points_per_tile={cfg.model.splat.max_points_per_tile}: {int(over.sum())}")


def phase_walk(directions=("R", "L"), num_split=2):
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator

    t0 = time.perf_counter()
    ps = PixelSynth.from_stitched(os.path.join(REPO, "evidence/relay/stitched.npz"),
                                  device=DEVICE)
    log(f"[walk] stitched checkpoint loaded in {time.perf_counter() - t0:.1f} s: "
        f"W={ps.W}, num_samples {ps.cfg.sample.num_samples}, "
        f"classifier {'yes' if ps.classifier is not None else 'no'}")
    gen = SceneGenerator(ps)
    img, cams = _view_inputs(ps.W, seed=3)
    gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"],
                       directions=["R"], num_split=1, seed=0)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = gen.generate_scene(img, cams["K"], cams["Kinv"], cams["P"], cams["Pinv"],
                              directions=list(directions), num_split=num_split,
                              seed=0)
    secs = time.perf_counter() - t0
    views = [k for k in outs if k.startswith("PredImg_")]
    for k in views:
        v = outs[k]
        if not (np.isfinite(v).all() and v.shape == (1, ps.W, ps.W, 3)
                and np.abs(v).max() <= 1.0):
            raise AssertionError(f"{k} is not a finite image in [-1, 1]")
    log(f"[walk] {len(views)} views in {secs:.2f} s; CloudValidCount "
        f"{outs['CloudValidCount'].tolist()}")


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "pixelsynth_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only_kernels = "--kernels-only" in argv
    t0 = time.perf_counter()
    phase_build()
    report = {}
    phase_k1(report)
    phase_k2(report)
    if not only_kernels:
        phase_view(report)
        phase_walk()
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in report.values()]}))
    print(card_line())
    if only_kernels:
        return 1   # a partial run prints no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
