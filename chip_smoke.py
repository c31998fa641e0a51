#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero and never
prints the final ok line):
  1. build the CUDA kernels (all nvcc processes started together) and
     print the toolchain and the card;
  2. each kernel against its plain PyTorch version at the main path's
     shapes, timed with CUDA events (K1: pop 16, 32x32 codes, F=80, bf16,
     also 33 candidates (rounds) and 16x16 codes, 20 repeated calls
     bit-identical, one device kernel a pass; and its "k3" route (every
     masked conv a K3 launch) in f32 at that size and in bf16 at shapes
     the kernel cannot hold: 2 x 48x48, 4 x 12x12, F=96;
     K2: W=256, 2 images x 131072 points, from the binner's tables, each
     accumulation, coverage on points at the radius from the edges of the
     warps' rectangles, and no slot gather in `splat()` by the profiler;
     its bf16 entry (`phase_k2_bf16`: blend_dtype "bfloat16") at C = 3, 9
     and 64 in each accumulation, its coverage bit-equal to the f32
     entry's, 20 repeated calls bit-identical, one kernel a call;
     K3: pop 16, 32x32, (Cin, Cout) = (160, 80), (160, 160) and, dilation
     2, (80, 80), bf16 (the resident route; 20 repeated calls
     bit-identical, one device kernel a call by the profiler; the build
     with the other cluster size too, built in the phase) and float32, and
     the streamed route at 48x48; K4: pop 16, 32x32, F=80, with and without the skip,
     and 4 images of 16x16 and 17 of 32x32 (two rounds of one launch),
     and its "k3" route in f32 and at 12x12 and F=96;
     K1, K3 and K4 also on masks with every tap on and on masks that are 0
     on whole 128-position tiles, the two edges of the (tile, tap) skip;
     K5: the binning keys of 131072 points, (1, 2^19), and (2, 2^17), and
     three hard rows of 2^14 (all keys equal, negative keys with both int32
     extremes, descending keys), exact against torch.sort(stable=True),
     which is also its library yardstick, and against both plain versions).
     A one-kernel-a-call check counts exactly N launches by the wrapper
     and at most N under one name by the profiler; the order kernel
     (csrc/custom_order.cu, `phase_orders`) bit for bit against its plain
     version and the host heap on the default view's 32x32 distance grid,
     the relay checkpoint's 16x16 grids and random grids with ties (B = 1
     and 64; 48x48, 40x48, 64x64, 99x99; a wide span of distances), one
     launch a call, timed beside
     both and beside the floor of a step's links (`order_chain_floor`);
  3. the default path at full width: one `generate_view` at the Config()
     defaults (W=256, 32x32 codes, nr_filters 80, speculative 12) with
     seeded random weights and 16 candidates (K1, K2, the order kernel),
     then the same view in 12 alternating pairs of `lmconv.masks_backend`
     ("jax": the order kernel; "host": the heap), the `orders_masks`
     stage's ms and the view's of each, their orders, masks and sampled
     codes equal;
     then the same view with lmconv.compute_dtype="float32" (K1's "k3"
     route: K3, K2);
  4. the per-layer engines: the AR fill (`ar_sample` over every background
     cell, pop 16) through the module path (32 K3 launches a forward) and
     through the per-layer kernel engine (14 K4 + 4 K3), each held to the
     K1 path by argmax agreement;
  5. the same view with sample_backend="pallas" and sort_backend="pallas"
     (K3, K5, K2), its binning tables held to the library-sort binner's;
  6. the trained relay checkpoint (evidence/relay/stitched.npz, W=128)
     through the weight bridge, walking directions R and L;
  7. the relay gate on that checkpoint (eval/relay_report.py at the
     report's sizes, K1, K2), held to the floors of
     tests/test_relay_artifact.py beside the JAX report's numbers; then
     the paper's evaluation protocol on it (`phase_eval`: eval_quality on
     16 held-out pairs, eval_consistency and the fixtures on 8, the metric
     batteries with seeded random PercSim / LPIPS / InceptionV3 networks
     on the card; K1, K2), its PSNR held to the in-memory views' and its
     networks to the same modules on the CPU; then `phase_angle`: K2 at
     C = 9, 24, 64 and 72 (64 and 72 also with tiles of 8 and 32) against
     its plain version (a view's own points and points on the radius, one
     launch a call) and one backward at C = 64,
     `forward_angle` on that checkpoint over nerf_like_circle(8) (one K2
     launch a view, the views against the CPU run), the encoder
     composition at the Config() widths (64-wide features through K2 into
     a decoder on 64 + 1 channels: forward_angle, render_no_outpaint, one
     view through K5), and depth_warp_forward, both baselines and the
     two-level VQ-VAE at W=256 against the CPU;
  8. each trainer the relay chain runs (stage 1, stage 2 G+D, stage 3,
     the scene classifier; `phase_card_vs_cpu`, train/card_vs_cpu.py):
     three float64 steps at small widths on the card beside the CPU from
     one seeded state, each step from the CPU's carried state, every
     gradient, parameter, Adam moment and buffer to 1e-9 of the leaf's
     largest value; then the stage-2 trainer at the Config() widths
     (W=256, batch 12, train_backend "pallas", a random-init VGG19): 6
     G+D steps from the
     seeded initialiser, one K2 launch and 33 K3 launches a G step; one
     step's K2 and K3 work held to their plain versions
     (`plain_kernels`); and 300 steps of the evidence protocol (W=64,
     batch 8, 48 items), which must quarter the total loss;
  9. the stage-1 trainer at the VQVAEConfig defaults (W=256, batch 12): 6
     steps from the data-dependent codebook init (no kernel); the
     stage-3 trainer at the LMConvConfig defaults (32x32 codes, F=80,
     batch 12) on K3: 6 steps, 33 K3 launches each, one step held to the
     plain versions, then the inpainting preview through K1; and the
     evidence curves of stages 1 and 3 (W=128), held to the bars of
     tests/test_training_evidence.py beside the JAX package's curves;
 10. the relay chain (tools/run_relay.py) with --smoke settings at W=128
     and the Config() widths into build/relay_chain/: all ten stages
     (shards, VQ-VAE, codes, DPR pretrain, orders through the order
     kernel, PixelCNN, DPR, classifier, stitch, report), each stage's
     seconds and kernel launches; the stitched npz loaded by
     weights.load_stitched_npz renders a finite view in [-1, 1], the
     report has every key of evidence/relay/relay_report.json, and
     evidence/relay/stitched.npz is unchanged (sha256);
 11. the other datasets (`phase_datasets`, build/datasets/): stage-2 steps
     at the Config() widths (batch 12, K3 under the gradient) on a
     synthetic RealEstate10K tree through make_batch_source("realestate")
     with the curriculum's set_max_rotation, then on the batches of a
     5-worker VectorGeneratorBridge over the panorama worlds, and the
     extract chain (extract_vqvae_dataset -> Custom -> extract_code ->
     extract_pixcnn_orders: K2, the order kernel) on 24 images;
 12. data parallelism (`phase_parallel`): an NCCL group of one process,
     one stage-2 step through the mesh path held to the step without a
     group (losses within 1e-5), and a sharded-population view (K1) held
     to the ungrouped view (codes equal);
 13. the tools (`phase_tools`, build/tools/): profile_view,
     profile_hotspots, profile_splat (the f32 and bf16 splat: background
     unmoved, within 0.02 of scale), tune_splat.sweep, sweep_speculative,
     scene_drift on the stitched checkpoint, import_reference_ckpt on
     reference-layout files at the Config() widths (a default view through
     K1 and K2, forward_angle with the bf16 blend against f32) and
     export_torch_weights' npz read back by the VGG19 loader.
Each path's launch counts (and the wrappers' counts of plain-version
calls) are zeroed just before it is driven and read just after.  The
script ends with a `kernels` JSON line, the card's name
and power limit, and the result line {"ok": true, "device": {...}}.

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
SOURCES = ["lmconv_fused", "splat_blend", "masked_conv", "gated_resnet", "sort_kv",
           "custom_order"]


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
    logs = _cuda.build(SOURCES, verbose=True)
    log(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    log(f"[card] {card_line()}")


def _entry(name, source, replaces, err, ms, pms, t_ops, t_bytes, library_ms=None):
    return {"name": name, "route": "cuda",
            "source": f"pixelsynth_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _half_grid(side=32):
    """A code grid whose right half is to be outpainted: (order (1, HW, 2),
    masks (1, 3, 9, HW), bg_ds (1, side, side))."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
    from pixelsynth_tpu_torch.ops.orders import orders_and_masks

    bg = np.zeros((1, side, side), np.float32)
    bg[:, :, side // 2:] = 1.0
    bg_t = torch.as_tensor(bg, device=DEVICE)
    order, masks = orders_and_masks(signed_distance_field(1.0 - bg_t, bg_t))
    return order, masks, bg_t


def _mask_cases(masks):
    """masks (B, 3, 9, HW) of an order -> {case: masks}: the order's own;
    every tap of the two conv masks on; the conv masks 0 on the second and
    the last 128-position tile (the two edges of the (tile, tap) skip)."""
    all_on = masks.clone()
    all_on[:, 1:] = 1.0
    tiles_off = masks.clone()
    tiles_off[:, 1:, :, 128:256] = 0.0
    tiles_off[:, 1:, :, -128:] = 0.0
    return {"order": masks, "all on": all_on, "tiles off": tiles_off}


def _pixelcnn_params(Fc=80, seed=0):
    """Flax-named PixelCNN arrays at width Fc from a seed (CPU tensors)."""
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params

    cfg = Config()
    cfg.model.lmconv.nr_filters = Fc
    return cfg, random_pixelcnn_params(cfg, torch.Generator().manual_seed(seed))


def _k1_inputs(B=16, side=32, Fc=80, seed=0, case="order", compute_dtype="bfloat16"):
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.ops.lmconv_fused import (
        embed_input, fold_boundary_masks, pack_lmconv_params)

    _, params = _pixelcnn_params(Fc, seed)
    packed = pack_lmconv_params(params, nr_resnet=2, compute_dtype=compute_dtype,
                                device=DEVICE)
    rng = np.random.default_rng(seed)
    _, masks, _ = _half_grid(side)
    masks = _mask_cases(masks.repeat(B, 1, 1, 1))[case]
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


def _k1_check(tag, B, side, Fc, case="order"):
    """K1 up and down at (B, side, Fc) on masks `case` against the plain
    versions (down from the plain stack, so each pass is held alone)."""
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1
    from pixelsynth_tpu_torch.ops.conv_pack import skipped_share

    packed, u0, mu, md, *_ = _k1_inputs(B, side, Fc, case=case)
    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16")
    stack_p = K1.up_plain(u0, mu, md, packed, W=side, nr=2, dilation=2,
                          compute_dtype="bfloat16")
    out_p = K1.down_plain(stack_p, mu, md, packed, W=side, nr=2, dilation=2,
                          compute_dtype="bfloat16")
    e_up = float((K1.up(u0, mu, md, packed, **kw).float() - stack_p.float()).abs().max())
    e_dn = float((K1.down(stack_p, mu, md, packed, **kw) - out_p).abs().max())
    # the tolerance of the main case below: 2% of the activations' range
    t_up = 0.02 * max(1.0, float(stack_p.float().abs().max()))
    t_dn = 0.02 * max(1.0, float(out_p.abs().max()))
    tu, td = K1.tile_tables(mu, md)
    log(f"[K1] {tag}, masks {case!r} (steps skipped {skipped_share(tu):.3f} / "
        f"{skipped_share(td):.3f}): up {e_up:.3e} (tol {t_up:.3e}), "
        f"down {e_dn:.3e} (tol {t_dn:.3e})")
    if not (e_up <= t_up and e_dn <= t_dn):
        raise AssertionError(f"K1 disagrees with its plain version ({tag}, masks {case!r})")
    return max(e_up, e_dn)


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp at |want| (bf16 keeps 8
    significant bits: an ulp at [2^e, 2^(e+1)) is 2^(e-7))."""
    import torch

    a = want.float().abs().clamp(min=2.0 ** -126)
    return (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(a)) - 7)


# the "k3" route's K3 launches a pass at nr 2: up 6 gated resnets x 2 convs
# + 2 dilated convs; down 8 x (2 convs + the nin skip) + 2 dilated
K3_A_PASS = {"lmconv_up": 14, "lmconv_down": 26}


def _k1_route_check(tag, B, side, Fc, compute_dtype, timed=False):
    """K1's "k3" route (`k1_route`: f32 compute, or a shape the K1 kernel
    cannot hold) on the card against the plain versions, through the
    wrappers `up` / `down`: each pass counted once under its route's name,
    with 14 / 26 K3 launches and no plain version.  float32: down (from
    the plain stack) within atol 1e-4; the up stack is bf16 even at f32
    compute, so where the two f32 sums straddle a bf16 rounding boundary an
    entry differs by one bf16 ulp: every entry within atol 1e-4 or one
    bf16 ulp of its value, and the logits of the whole forward (the k3
    stack through the k3 down) agree in argmax >= 0.99.  bfloat16: K1's
    own tolerance (2% of the range, argmax >= 0.97).  Returns (max error,
    {pass: ms} when timed)."""
    import torch
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1

    packed, u0, mu, md, *_ = _k1_inputs(B, side, Fc, compute_dtype=compute_dtype)
    route = K1.k1_route(side, side, Fc, 2, 2, compute_dtype)
    if route != "k3":
        raise AssertionError(f"K1 {tag}: route {route}, expected k3")
    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype=compute_dtype)
    pkw = dict(W=side, nr=2, dilation=2, compute_dtype=compute_dtype)
    stack_p = K1.up_plain(u0, mu, md, packed, **pkw)
    out_p = K1.down_plain(stack_p, mu, md, packed, **pkw)
    tables = K1.k3_masks(mu, md)      # made once, as the sampler makes them
    torch.cuda.synchronize()
    zero_launches()
    stack_k = K1.up(u0, mu, md, packed, tables=tables, **kw)
    out_k = K1.down(stack_p, mu, md, packed, tables=tables, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    check_no_plain(f"K1's k3 route ({tag})")
    n_k3 = launches.get("masked_conv", 0) + launches.get("masked_conv_streamed", 0)
    if (launches.get("lmconv_up_k3") != 1 or launches.get("lmconv_down_k3") != 1
            or "lmconv_up" in launches or "lmconv_down" in launches
            or n_k3 != sum(K3_A_PASS.values())):
        raise AssertionError(f"K1 {tag}: launches {json.dumps(launches)}")
    out_kk = K1.down(stack_k, mu, md, packed, tables=tables, **kw)
    lk = torch.nn.functional.elu(out_kk) @ packed["nin_w"]
    lp = torch.nn.functional.elu(out_p) @ packed["nin_w"]
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    e_up = float((stack_k.float() - stack_p.float()).abs().max())
    e_dn = float((out_k - out_p).abs().max())
    if compute_dtype == "float32":
        d_up = (stack_k.float() - stack_p.float()).abs()
        straddles = d_up > 1e-4
        worst_ulps = float(_bf16_ulps(stack_k, stack_p)[straddles].max()) \
            if bool(straddles.any()) else 0.0
        ok = worst_ulps <= 1.0 and e_dn <= 1e-4 and agree >= 0.99
        what = (f"up max {e_up:.3e}, entries beyond atol 1e-4 "
                f"{float(straddles.float().mean()):.2e} (each within {worst_ulps:.0f} bf16 "
                f"ulp, tol 1), down {e_dn:.3e} (atol 1e-4), logits argmax {agree:.4f} "
                f"(tol >= 0.99)")
    else:
        t_up = 0.02 * max(1.0, float(stack_p.float().abs().max()))
        t_dn = 0.02 * max(1.0, float(out_p.abs().max()))
        ok = e_up <= t_up and e_dn <= t_dn and agree >= 0.97
        what = (f"up {e_up:.3e} (tol {t_up:.3e}), down {e_dn:.3e} (tol {t_dn:.3e}), "
                f"logits argmax {agree:.4f} (tol >= 0.97)")
    log(f"[K1] k3 route {tag} {compute_dtype}: K3 launches {json.dumps(launches)}; {what}")
    if not ok:
        raise AssertionError(f"K1's k3 route disagrees with the plain version ({tag})")
    times = {}
    if timed:
        times["lmconv_up"] = time_ms(lambda: K1.up(u0, mu, md, packed, tables=tables, **kw),
                                     reps=3, rounds=3)
        times["lmconv_down"] = time_ms(
            lambda: K1.down(stack_p, mu, md, packed, tables=tables, **kw), reps=3, rounds=3)
    return max(e_up, e_dn), times


def device_kernels(fn, reps=10):
    """The device kernels of `reps` calls of fn, from torch.profiler:
    ({kernel name: launches}, device us per call: their time over the
    launches seen, times launches per call, {wrapper count: launches} the
    wrappers counted in the same `reps` calls).  The profiler drops some of
    a window's kernel records (2 of 10 seen is common) and has once
    recorded none at all of ten launches whose outputs were checked: a
    window that records no device kernel is profiled again, up to three
    windows, and the wrappers' counts are those of the window returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        before = read_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
        hits = [e for e in prof.key_averages() if e.device_time_total > 0]
        if hits:
            break
        log(f"[profiler] no device kernel recorded in {reps} calls "
            f"(wrapper launches {json.dumps(counted)}): profiling another window")
    n = sum(e.count for e in hits)
    per_call = max(1, round(n / reps))
    return ({e.key: e.count for e in hits},
            sum(e.device_time_total for e in hits) / max(1, n) * per_call, counted)


def check_one_kernel_a_call(tag, name, kernels, counted, reps=10):
    """The one-kernel-a-call check of `reps` calls: exactly `reps` launches
    by the wrapper's count `name` and no other count, and one kernel name
    with at most `reps` launches by the profiler (which may miss short
    launches at the start of its window, never add one; a cast or a second
    launch a call would be a second name or another count)."""
    n = sum(kernels.values())
    log(f"{tag}: {reps} calls: wrapper launches {json.dumps(counted)}, device "
        f"kernels by the profiler {json.dumps(kernels)}")
    if counted != {name: reps} or len(kernels) != 1 or not 1 <= n <= reps:
        raise AssertionError(f"{tag}: {reps} calls counted {json.dumps(counted)} and ran "
                             f"{json.dumps(kernels)}, expected one {name} kernel a call")


def host_us(fn, reps=20):
    """Host time of one fn() call (no synchronisation inside the timed
    calls: what the caller's thread spends to issue it), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def phase_k1(report, B=16, side=32, Fc=80, others=((33, 32), (8, 16)), repeats=20):
    """K1 at (B, side, Fc) on the three mask cases and at the `others`
    sizes (33 candidates: more than the card runs at once, so rounds; 16x16:
    two tiles, the stitched walk's grid); `repeats` back-to-back calls of
    each pass bit-identical; one pass is one device kernel; timed."""
    import torch
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1
    from pixelsynth_tpu_torch.ops.conv_pack import skipped_share

    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16")
    groups, cluster = K1.resident_candidates(Fc, side * side)
    log(f"[K1] the card runs {groups} candidates of {side}x{side} at once "
        f"(clusters of {cluster} blocks, {side * side // 128} blocks a candidate)")
    # the two edges of the (tile, tap) skip, and the other sizes
    worst = max([_k1_check(f"({B}, {side})", B, side, Fc, case)
                 for case in ("all on", "tiles off")]
                + [_k1_check(f"({b_}, {s_})", b_, s_, Fc) for b_, s_ in others])
    packed, u0, mu, md, codes, filled, masks = _k1_inputs(B, side, Fc)
    tu, td = K1.tile_tables(mu, md)
    log(f"[K1] masks of the half-empty grid: (tile, tap) steps skipped "
        f"{skipped_share(tu):.3f} (dilation 1), {skipped_share(td):.3f} (dilation 2)")
    kw["tables"] = (tu, td)     # made once, as the sampler makes them
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
    # back-to-back calls: a race between neighbours' counters would show
    ups = [K1.up(u0, mu, md, packed, **kw) for _ in range(repeats)]
    downs = [K1.down(stack_p, mu, md, packed, **kw) for _ in range(repeats)]
    torch.cuda.synchronize()
    same = (all(torch.equal(x, stack_k) for x in ups),
            all(torch.equal(x, out_k) for x in downs))
    log(f"[K1] {repeats} back-to-back calls bit-identical: up {same[0]}, down {same[1]}")
    if not all(same):
        raise AssertionError("K1 calls on the same inputs differ")

    runs = {"lmconv_up": lambda: K1.up(u0, mu, md, packed, **kw),
            "lmconv_down": lambda: K1.down(stack_p, mu, md, packed, **kw)}
    dev = {}
    for name, fn in runs.items():
        kernels, dev[name], counted = device_kernels(fn)
        check_one_kernel_a_call(f"[K1] {name}", name, kernels, counted)
    up_ms = time_ms(runs["lmconv_up"])
    dn_ms = time_ms(runs["lmconv_down"])
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
    # the "k3" route: f32 compute at this size (timed beside the kernel),
    # and the shapes the K1 kernel cannot hold, in bf16: rows beyond the
    # resident rows (K3's streamed route), HW % 128 != 0 and F > 80 (K3's
    # f32 kernel on bf16-rounded operands)
    _, route_ms = _k1_route_check(f"({B}, {side}) F={Fc}", B, side, Fc, "float32",
                                  timed=True)
    for b_, s_, f_ in ((2, 48, 80), (4, 12, 80), (4, 16, 96)):
        _k1_route_check(f"({b_}, {s_}) F={f_}", b_, s_, f_, "bfloat16")
    for name, ms in (("lmconv_up", up_ms), ("lmconv_down", dn_ms)):
        log(f"[K1] {name} at ({B}, {side}) F={Fc}: f32 k3 route {route_ms[name]:.3f} ms "
            f"a pass ({K3_A_PASS[name]} K3 launches), bf16 K1 kernel {ms:.3f} ms")
    for name, ms, pms, fl, by, err, line in (
            ("lmconv_up", up_ms, up_plain_ms, f_up, by_up, err_up, 151),
            ("lmconv_down", dn_ms, dn_plain_ms, f_dn, by_dn, err_dn, 178)):
        t_ops, t_bytes = fl / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
        report[name] = _entry(name, "lmconv_fused.cu",
                              f"pixelsynth_tpu/ops/lmconv_fused.py:{line}",
                              max(err, worst), ms, pms, t_ops, t_bytes)
        log(f"[K1] {name}: {ms:.3f} ms a call, device {dev[name]:.1f} us, host "
            f"{host_us(runs[name]):.1f} us a call; {pms:.3f} ms plain, "
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


def covered_pairs(points, slot_idx, slot_valid, W, cfg, group=64):
    """Pixel x slot pairs whose slot covers the pixel (distance < radius),
    counted on the binner's tables: the pairs the blend's function must
    compute (every other pair changes nothing)."""
    import torch
    from pixelsynth_tpu_torch.ops.splat import gather_slots, tile_origins

    B = points.shape[0]
    TS = cfg.tile_size
    spts, _, svld = gather_slots(points, points[..., :1].contiguous(), slot_idx,
                                 slot_valid)
    org = tile_origins(W, TS, points.device).repeat(B, 1)
    pix = torch.arange(TS * TS, device=points.device)
    py, px = (pix // TS).float(), (pix % TS).float()
    n = 0
    for g0 in range(0, spts.shape[0], group):
        p, v, o = spts[g0:g0 + group], svld[g0:g0 + group], org[g0:g0 + group]
        dx = (px[None] + o[:, 1:2])[:, :, None] - p[:, None, :, 0]
        dy = (py[None] + o[:, 0:1])[:, :, None] - p[:, None, :, 1]
        n += int(((dx * dx + dy * dy < cfg.radius ** 2) & v[:, None, :]).sum())
    return n


def _radius_edge_points(W=512, seed=7):
    """Points at distance r, r - 1 ulp and r + 1 ulp (of the coordinate)
    from a pixel centre on an edge of a warp's 4 x 8 rectangle of K2's
    16x16 tiles, straight out from the edge (so the distance is one exact
    difference, whichever way a product is rounded): one point in every
    other tile of every other tile row, so no other point reaches its
    pixel, cycling through the 8 rectangles, the 4 sides and the 3
    distances.  -> (1, N, 3) on the card, for a W x W image."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig

    cfg = SplatConfig()
    r, TS = np.float32(cfg.radius), cfg.tile_size
    rng = np.random.default_rng(seed)
    pts = []
    for k, (ty, tx) in enumerate((ty, tx) for ty in range(0, W // TS, 2)
                                 for tx in range(0, W // TS, 2)):
        rect, side, step = k % 8, (k // 8) % 4, (k // 32) % 3 - 1
        r_lo, c_lo = ty * TS + (rect // 2) * 4, tx * TS + (rect % 2) * 8
        row = np.float32(rng.integers(r_lo, r_lo + 4))
        col = np.float32(rng.integers(c_lo, c_lo + 8))
        x, y = [(np.float32(c_lo) - r, row), (np.float32(c_lo + 7) + r, row),
                (col, np.float32(r_lo) - r), (col, np.float32(r_lo + 3) + r)][side]
        # step +1 moves the point one ulp towards the rectangle, -1 away
        if step:
            toward = np.float32(np.inf if (side in (0, 2)) == (step > 0) else -np.inf)
            if side < 2:
                x = np.nextafter(x, toward)
            else:
                y = np.nextafter(y, toward)
        pts.append((x, y, rng.uniform(0.5, 10.0)))
    return torch.as_tensor(np.asarray(pts, np.float32)[None], device=DEVICE)


def phase_k2(report, W=256, N=65536 * 2):
    """K2 from the binner's tables (the gather inside the kernel) against
    its plain version (`gather_slots` + `blend_tiles_plain`) in every
    accumulation; coverage on points at the radius from the edges of the
    warps' rectangles; `splat()` gathers no slots outside the kernel."""
    import dataclasses
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import splat as K2

    W, pts, fts, vld = _k2_inputs(W=W, N=N)
    cfg = SplatConfig()
    slot_idx, slot_valid, counts = K2._bin_points_batched(pts, vld, W, cfg,
                                                          return_counts=True)
    over = torch.clamp(counts - cfg.max_points_per_tile, min=0)
    log(f"[K2] binning: max entries per tile {int(counts.max())}, "
        f"M={cfg.max_points_per_tile}, tiles over capacity {int((over > 0).sum())}, "
        f"entries dropped {int(over.sum())}")
    errs = {}
    for acc in ("alphacomposite", "wsum", "wsumnorm"):
        c = dataclasses.replace(cfg, accumulation=acc)
        ok, ck = K2.blend_slots(pts, fts, slot_idx, slot_valid, W, c)
        op, cp = K2.blend_slots_plain(pts, fts, slot_idx, slot_valid, W, c)
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
    # on the radius: the culling test must keep every slot that covers
    ep = _radius_edge_points()
    ef = torch.randn((1, ep.shape[1], 3), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(8))
    ei, ev = K2._bin_points_batched(ep, torch.ones(ep.shape[:2], dtype=torch.bool,
                                                   device=DEVICE), 512, cfg)
    eo, ec = K2.blend_slots(ep, ef, ei, ev, 512, cfg)
    po, pc = K2.blend_slots_plain(ep, ef, ei, ev, 512, cfg)
    torch.cuda.synchronize()
    same = bool(torch.equal(ec, pc))
    close = bool(torch.allclose(eo, po, atol=5e-4, rtol=1e-3))
    log(f"[K2] {ep.shape[1]} points at r and r +- 1 ulp from the warp rectangles' "
        f"edges: coverage identical to the plain version's {same} ({int(pc.sum())} "
        f"of {pc.numel()} pixels covered), allclose={close}")
    if not (same and close):
        raise AssertionError("K2 disagrees with its plain version on the radius")
    # the splat on the card: no slot gather outside the kernel
    kernels, _, _ = device_kernels(lambda: K2.splat(pts, fts, vld, W=W, cfg=cfg), reps=3)
    gathers = {k: v for k, v in kernels.items() if "gather" in k.lower()}
    log(f"[K2] splat(): {sum(kernels.values()) / 3:.1f} device kernels a call, "
        f"gather kernels {json.dumps(gathers)}")
    if gathers:
        raise AssertionError(f"splat() still gathers slots outside K2: {gathers}")
    ms = time_ms(lambda: K2.blend_slots(pts, fts, slot_idx, slot_valid, W, cfg))
    pms = time_ms(lambda: K2.blend_slots_plain(pts, fts, slot_idx, slot_valid, W, cfg),
                  reps=3, rounds=3)
    # the function's own work: the valid flags, each valid slot's index, the
    # points and features each read once, the image and coverage written
    # once; ~20 fp32 flops a covered pixel x slot pair (distance 5, alpha 7,
    # 2 a feature, transmittance and mass 3; an uncovered pair changes
    # nothing)
    B, nT, M = slot_valid.shape
    C = fts.shape[-1]
    n_valid = int(slot_valid.sum())
    pairs = covered_pairs(pts, slot_idx, slot_valid, W, cfg)
    flops = pairs * (15 + 2 * C)
    by = (B * nT * M + n_valid * 8 + (pts.numel() + fts.numel()) * 4
          + B * W * W * (4 * C + 1))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, by / PEAK_BYTES * 1e3
    report["splat_blend"] = _entry(
        "splat_blend", "splat_blend.cu", "pixelsynth_tpu/ops/splat_pallas.py:40",
        max(errs.values()), ms, pms, t_ops, t_bytes)
    log(f"[K2] splat_blend: {ms:.4f} ms kernel, {pms:.3f} ms plain; {n_valid} valid "
        f"slots, {pairs / 1e6:.2f} M covered pixel x slot pairs of "
        f"{n_valid * cfg.tile_size ** 2 / 1e6:.1f} M, {flops / 1e9:.3f} GFLOP, "
        f"{by / 1e6:.1f} MB, bound {max(t_ops, t_bytes):.4f} ms")


def phase_k2_bf16(report, W=256, N=65536 * 2, repeats=20):
    """K2's bf16 entry (`splat.blend_dtype="bfloat16"`: bf16 feature rows,
    each weight rounded to bf16, f32 sums) against its plain version
    (`blend_slots_plain`, the same rounding in PyTorch) on the bench
    protocol's points (W=256, 2 images x 131072) at C = 3, 9 and 64, in
    every accumulation, from the binner's tables, the features given in
    bf16 (the wrapper's one cast is the caller's).  The two sides round the
    same weights, but a weight within an f32 ulp of a bf16 boundary (the
    plain version's cumprod takes another order) may round the other way:
    the max difference is held to 1e-2 of the image's scale and the share
    of values off by more than 1e-5 of it to 1e-3.  Under wsumnorm both
    round alpha / max(sum alpha, 1e-4) as the JAX package does (the kernel
    walks the slots twice; the sum in f64 on both sides), so the same two
    bars hold.  The coverage is bit-equal to the f32 kernel's and the plain
    version's; 20 repeated calls are bit-identical; one device kernel a
    call by the profiler.  Timed at each C: ms a call, device us, the f32
    entry's ms on the same points, plain ms, the bound (bytes with 2 a
    feature at 3.35 TB/s; the weights' f32 flops at 67 TFLOP/s, the bf16
    products at 989 TFLOP/s); the report's entry is C = 64
    (profile_splat's protocol).  At C = 3 (the stage-2 step's RGB) and 64
    one backward under a gradient (`k2_wide_backward`)."""
    import dataclasses

    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import splat as K2

    cfg32 = SplatConfig()
    cfg = dataclasses.replace(cfg32, blend_dtype="bfloat16")
    errs, timed = [], {}
    for C in (3, 9, 64):
        _, pts, fts, vld = _k2_inputs(C=C, W=W, N=N)
        fb = fts.to(torch.bfloat16)
        slot_idx, slot_valid = K2._bin_points_batched(pts, vld, W, cfg)
        for acc in ("alphacomposite", "wsum", "wsumnorm"):
            c = dataclasses.replace(cfg, accumulation=acc)
            ok, ck = K2.blend_slots(pts, fb, slot_idx, slot_valid, W, c)
            op, cp = K2.blend_slots_plain(pts, fb, slot_idx, slot_valid, W, c)
            _, c32 = K2.blend_slots(pts, fts, slot_idx, slot_valid, W,
                                    dataclasses.replace(cfg32, accumulation=acc))
            torch.cuda.synchronize()
            d = (ok - op).abs()
            scale = float(op.abs().max())
            err = float(d.max())
            off = float((d > 1e-5 * scale).float().mean())
            same_cov = bool(torch.equal(ck, c32) and torch.equal(ck, cp))
            errs.append(err)
            log(f"[K2 bf16 C={C}] {acc}: max|kernel-plain| {err:.3e} = {err / scale:.2e} of "
                f"scale {scale:.3f} (bound 1e-2), share off by > 1e-5 of scale {off:.2e} "
                f"(bound 1e-3); coverage bit-equal to the f32 kernel's and the plain "
                f"version's {same_cov}")
            if not (err <= 1e-2 * scale and off <= 1e-3 and same_cov):
                raise AssertionError(f"K2 bf16 disagrees with its plain version (C={C}, {acc})")
        run = lambda: K2.blend_slots(pts, fb, slot_idx, slot_valid, W, cfg)  # noqa: E731
        first = run()
        same = all(torch.equal(run()[0], first[0]) for _ in range(repeats - 1))
        torch.cuda.synchronize()
        log(f"[K2 bf16 C={C}] {repeats} repeated calls bit-identical: {same}")
        if not same:
            raise AssertionError(f"K2 bf16 at C={C} is not deterministic")
        kernels, dev_us, counted = device_kernels(run, reps=10)
        check_one_kernel_a_call(f"[K2 bf16 C={C}]", "splat_blend_bf16", kernels, counted)
        run32 = lambda: K2.blend_slots(pts, fts, slot_idx, slot_valid, W, cfg32)  # noqa: E731
        ms32a, ms, ms32b = time_ms(run32), time_ms(run), time_ms(run32)
        pms = time_ms(lambda: K2.blend_slots_plain(pts, fb, slot_idx, slot_valid, W, cfg),
                      reps=3, rounds=3)
        # the function's own work as phase_k2 counts it, the features read
        # as bf16 (2 bytes a value); of the flops a covered pair, the 15 of
        # its weight are f32 (67 TFLOP/s) and the 2 a channel bf16 x bf16
        # products summed in f32, the bf16 tensor cores' type (989
        # TFLOP/s); the two run on different units, so the least time of
        # the operations is the larger of the two
        B, nT, M = slot_valid.shape
        n_valid = int(slot_valid.sum())
        pairs = covered_pairs(pts, slot_idx, slot_valid, W, cfg)
        f32_flops, bf16_flops = pairs * 15, pairs * 2 * C
        by = (B * nT * M + n_valid * 8 + pts.numel() * 4 + fb.numel() * 2
              + B * W * W * (4 * C + 1))
        t_f32, t_bf16 = f32_flops / PEAK_F32_FLOPS * 1e3, bf16_flops / PEAK_BF16_FLOPS * 1e3
        t_ops, t_bytes = max(t_f32, t_bf16), by / PEAK_BYTES * 1e3
        timed[C] = (ms, pms, t_ops, t_bytes)
        log(f"[K2 bf16 C={C}] {ms:.4f} ms a call (the f32 entry on the same points "
            f"{ms32a:.4f}, {ms32b:.4f} ms before and after), device {dev_us:.1f} us, "
            f"plain {pms:.3f} ms; {f32_flops / 1e9:.3f} GFLOP f32 ({t_f32 * 1e3:.1f} us "
            f"at 67 TFLOP/s), {bf16_flops / 1e9:.3f} GFLOP bf16 ({t_bf16 * 1e3:.1f} us at "
            f"989 TFLOP/s), {by / 1e6:.1f} MB ({t_bytes * 1e3:.1f} us at 3.35 TB/s): "
            f"bound {max(t_ops, t_bytes):.4f} ms by "
            f"{'operations' if t_ops >= t_bytes else 'bytes'}; on {card_line()}")
        if C in (3, 64):
            k2_wide_backward(C, W, blend_dtype="bfloat16")
    ms, pms, t_ops, t_bytes = timed[64]
    report["splat_blend_bf16"] = _entry(
        "splat_blend_bf16", "splat_blend.cu", "pixelsynth_tpu/ops/splat_pallas.py:40",
        max(errs), ms, pms, t_ops, t_bytes)


def _view_points(W=256, B=2, seed=11, frame=1):
    """A view's own splat input: B smooth depth maps at W (one point a
    pixel, W*W an image) lifted into camera `frame` of nerf_like_circle(8)
    -> (points (B, W*W, 3), valid (B, W*W)) on the card."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
    from pixelsynth_tpu_torch.utils.camera_paths import nerf_like_circle

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, W), indexing="ij")
    depth = np.stack([2.0 + np.sin(2 * xx + b) * np.cos(3 * yy)
                      + 0.05 * rng.normal(size=xx.shape) for b in range(B)])
    eye = torch.eye(4, device=DEVICE).expand(B, 4, 4)
    RT = torch.as_tensor(nerf_like_circle(8)[frame], device=DEVICE).expand(B, 4, 4)
    cloud = lift_to_cloud(torch.as_tensor(depth, dtype=torch.float32, device=DEVICE),
                          eye, eye, eye, RT, W)
    return homogeneous_to_pixels(cloud, W)


def k2_wide_check(C, W=256, reps=10, timed=False, tile=16):
    """K2 at C feature channels (C > 8: the wide body, one walk a tile and
    the product on the tensor cores; above 64 channels each block takes 64
    of them) and tiles of `tile` pixels (8: a block of two warps; 32: a
    tile's rectangles split over four blocks) against its plain version,
    alphacomposite: on a view's own points (W=256, 2 images x 65536) and on
    points at the radius from the edges of the warps' rectangles
    (`_radius_edge_points`, which lie on rectangle edges at every tile
    size), to 1e-5 of the output's scale with the coverage identical;
    exactly `reps` launches in `reps` calls by the wrapper and at most
    `reps` by the profiler.  With `timed`, -> {err, ms, plain_ms,
    device_us, t_ops, t_bytes} of the view's points."""
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import splat as K2

    cfg = SplatConfig(tile_size=tile)
    at = f"[K2 C={C}" + ("]" if tile == 16 else f" tile {tile}]")
    pts, vld = _view_points(W)
    B, N, _ = pts.shape
    fts = torch.randn((B, N, C), device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(C))
    slot_idx, slot_valid = K2._bin_points_batched(pts, vld, W, cfg)
    ep = _radius_edge_points()
    ef = torch.randn((1, ep.shape[1], C), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(C + 1))
    ei, ev = K2._bin_points_batched(ep, torch.ones(ep.shape[:2], dtype=torch.bool,
                                                   device=DEVICE), 512, cfg)
    errs = []
    for tag, args in (("view points", (pts, fts, slot_idx, slot_valid, W)),
                      ("points on the radius", (ep, ef, ei, ev, 512))):
        ok, ck = K2.blend_slots(*args, cfg)
        op, cp = K2.blend_slots_plain(*args, cfg)
        torch.cuda.synchronize()
        err, scale = float((ok - op).abs().max()), float(op.abs().max())
        same = bool(torch.equal(ck, cp))
        errs.append(err)
        log(f"{at} {tag}: max|kernel-plain| {err:.3e} (tolerance 1e-5 x scale "
            f"{scale:.3f}), coverage identical {same} ({int(cp.sum())} of {cp.numel()} "
            "pixels covered)")
        if not (err <= 1e-5 * scale and same):
            raise AssertionError(f"{at} disagrees with its plain version ({tag})")
    run = lambda: K2.blend_slots(pts, fts, slot_idx, slot_valid, W, cfg)  # noqa: E731
    kernels, dev_us, counted = device_kernels(run, reps=reps)
    check_one_kernel_a_call(at, "splat_blend", kernels, counted, reps)
    if not timed:
        return None
    ms = time_ms(run)
    pms = time_ms(lambda: K2.blend_slots_plain(pts, fts, slot_idx, slot_valid, W, cfg),
                  reps=3, rounds=3)
    # the function's own work, as phase_k2 counts it: the valid flags, each
    # valid slot's index, the points and C features each read once, the
    # image and coverage written once; 15 fp32 flops a covered pixel x slot
    # pair for its weight (distance 5, alpha 7, transmittance and mass 3)
    # and 2 a channel for the accumulation
    M = slot_valid.shape[-1]
    nT = slot_valid.shape[1]
    n_valid = int(slot_valid.sum())
    pairs = covered_pairs(pts, slot_idx, slot_valid, W, cfg)
    flops = pairs * (15 + 2 * C)
    by = (B * nT * M + n_valid * 8 + (pts.numel() + fts.numel()) * 4
          + B * W * W * (4 * C + 1))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, by / PEAK_BYTES * 1e3
    log(f"{at} {ms:.4f} ms a call, device {dev_us:.1f} us, plain {pms:.3f} ms; "
        f"{n_valid} valid slots, {pairs / 1e6:.2f} M covered pixel x slot pairs, "
        f"{flops / 1e9:.3f} GFLOP ({t_ops * 1e3:.1f} us at 67 TFLOP/s), {by / 1e6:.1f} MB "
        f"({t_bytes * 1e3:.1f} us at 3.35 TB/s): bound {max(t_ops, t_bytes):.4f} ms; "
        f"on {card_line()}")
    return dict(err=max(errs), ms=ms, plain_ms=pms, device_us=dev_us, t_ops=t_ops,
                t_bytes=t_bytes)


def k2_wide_backward(C=64, W=256, blend_dtype="float32"):
    """One backward of the splat at C channels under a gradient
    (`_SplatBlendFn`: K2's forward, the plain recomputed VJP, as the JAX
    package's `splat_pallas`) on a view's own points, the features f32 as
    a step gives them, held to autograd through the plain blend on the
    same inputs.  In f32 to 1e-4 of each gradient's scale.  With
    blend_dtype "bfloat16" (K2's bf16 entry forward, the cast to bf16 and
    the weights' rounding inside the recompute) the gradients carry bf16
    roundings, and an f32 ulp between the recompute's tile groups and the
    whole plain blend may round a term the other way: the max difference
    to 1e-2 of the scale and the share of values off by more than 1e-5 of
    it to 1e-3, the forward's bars.  -> the backward's ms (host clock
    around a synchronised call)."""
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import splat as K2

    cfg = SplatConfig(blend_dtype=blend_dtype)
    bf16 = blend_dtype == "bfloat16"
    name = "splat_blend_bf16" if bf16 else "splat_blend"
    tag = f"[K2{' bf16' if bf16 else ''} C={C}]"
    pts, vld = _view_points(W)
    B, N, _ = pts.shape
    g = torch.Generator(device=DEVICE).manual_seed(C + 2)
    fts = torch.randn((B, N, C), device=DEVICE, generator=g)
    cot = torch.randn((B, W, W, C), device=DEVICE, generator=g)
    slot_idx, slot_valid = K2._bin_points_batched(pts, vld, W, cfg)
    got, want, secs = [], [], []
    for blend, into in ((K2.blend_slots, got), (K2.blend_slots_plain, want)):
        p = pts.clone().requires_grad_(True)
        f = fts.clone().requires_grad_(True)
        count = lambda: K2.LAUNCHES[name] + K2.PLAIN_CALLS["splat_blend"]  # noqa: E731
        before = count()
        out, _ = blend(p, f, slot_idx, slot_valid, W, cfg)
        launched = count() - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        into.extend(torch.autograd.grad(out, (p, f), cot))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if launched != (1 if blend is K2.blend_slots else 0):
            raise AssertionError(f"the splat under a gradient launched {name} {launched} times")
        del out
    errs, offs = [], []
    for a, b in zip(got, want):
        d, scale = (a - b).abs(), float(b.abs().max())
        errs.append(float(d.max()) / scale)
        offs.append(float((d > 1e-5 * scale).float().mean()))
    bars = "max 1e-2 of scale, share off by > 1e-5 of it 1e-3" if bf16 else "1e-4 of scale"
    log(f"{tag} backward under a gradient: {secs[0] * 1e3:.2f} ms (autograd through "
        f"the plain blend {secs[1] * 1e3:.2f} ms), 1 launch of {name}; d points, d feats "
        f"against the plain blend's: {errs[0]:.2e}, {errs[1]:.2e} of their scale, shares "
        f"off by > 1e-5 of it {offs[0]:.2e}, {offs[1]:.2e} (tolerance {bars})")
    ok = (max(errs) <= 1e-2 and max(offs) <= 1e-3) if bf16 else max(errs) <= 1e-4
    if not ok:
        raise AssertionError(f"the splat's gradient at C={C} ({blend_dtype}) differs from "
                             "the plain blend's")
    del got, want
    torch.cuda.empty_cache()
    return secs[0] * 1e3


def _uniform(gen, shape, bound):
    import torch

    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(DEVICE)


def _k3_check(tag, x, pm, w, b, dil, tol=1e-4):
    """One bf16 K3 call against the plain version: max |kernel - plain|.
    Both sides round the operands to bf16 and sum in f32: only the
    summation order differs.  So 1e-4 holds the indexing itself, far inside
    the 2% of the output's range that K1 and K4 (which round activations
    between layers) are given."""
    import torch
    from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
    from pixelsynth_tpu_torch.ops.conv_pack import skipped_share

    out_k = K3.locally_masked_conv2d_kernel(x, pm, w, b, dilation=dil)
    out_p = K3.locally_masked_conv2d_plain(x, pm, w, b, dilation=dil)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    log(f"[K3] {tag} (steps skipped {skipped_share(pm.taps):.3f}): bf16 "
        f"max|kernel-plain| {err:.3e} (max|ref| {float(out_p.abs().max()):.2f}, "
        f"atol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"K3 disagrees with its plain version ({tag})")
    return err


def _k3_shapes(Fc):
    """(Cin, Cout, dilation, which mask, launches per module-path forward)
    of the trunk's three masked convs."""
    return [(2 * Fc, Fc, 1, 1, 14), (2 * Fc, 2 * Fc, 1, 1, 14), (Fc, Fc, 2, 2, 4)]


def phase_k3(report, B=16, side=32, Fc=80, repeats=20):
    """K3 at the trunk's three conv shapes, on the masks of `_half_grid`
    and on the all-on and tiles-off cases: the bf16 kernel (the resident
    route) and the float32 kernel against the plain version; `repeats`
    back-to-back calls bit-identical; one device kernel a call (no cast);
    the streamed route on a grid whose rows exceed the resident region;
    the build with the other cluster size.  Timed."""
    import torch
    from pixelsynth_tpu_torch.ops import _cuda
    from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
    from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks

    cluster = K3._lib().masked_conv_cluster()
    _, masks, _ = _half_grid(side)
    masks = masks.repeat(B, 1, 1, 1)
    cases = _mask_cases(masks)
    gen = torch.Generator().manual_seed(3)
    tot = {"ms": 0.0, "pms": 0.0, "ops": 0.0, "bytes": 0.0, "n": 0}
    worst = 0.0
    timed = []
    for cin, cout, dil, mi, n_fwd in _k3_shapes(Fc):
        x = torch.randn((B, side, side, cin), generator=gen).to(DEVICE)
        bound = 1.0 / (9 * cin) ** 0.5
        w = _uniform(gen, (9, cin, cout), bound)
        b = _uniform(gen, (cout,), bound)
        pm = K3.prepare_mask(masks[:, mi])
        kw = dict(dilation=dil)
        route = K3.k3_route(side, side, cin, dil, cluster)
        tag = f"({cin},{cout}) d{dil} {route}"
        if route != "resident":
            raise AssertionError(f"K3 {tag}: the main path's shape left the resident route")
        worst = max(worst, _k3_check(f"{tag}, masks 'order'", x, pm, w, b, dil))
        f32_k = K3.locally_masked_conv2d_kernel(x, pm, w, b, compute_dtype="float32", **kw)
        f32_p = K3.locally_masked_conv2d_plain(x, pm, w, b, compute_dtype="float32", **kw)
        torch.cuda.synchronize()
        err32 = float((f32_k - f32_p).abs().max())
        log(f"[K3] {tag}: f32 max|kernel-plain| {err32:.3e} (atol 1e-4)")
        if not err32 <= 1e-4:
            raise AssertionError(f"K3 {tag} float32 disagrees with its plain version")
        for case in ("all on", "tiles off"):
            worst = max(worst, _k3_check(f"{tag}, masks {case!r}", x,
                                         K3.prepare_mask(cases[case][:, mi]), w, b, dil))
        packed = prepare_taps(w, K3.kernel_width(cin, cout))   # once, as a model does
        run = lambda: K3.locally_masked_conv2d_kernel(x, pm, packed, b, **kw)
        first = run()
        outs = [run() for _ in range(repeats)]
        torch.cuda.synchronize()
        same = all(torch.equal(o, first) for o in outs)
        kernels, dev_us, counted = device_kernels(run)
        log(f"[K3] {tag}: {repeats} back-to-back calls bit-identical {same}")
        if not same:
            raise AssertionError(f"K3 {tag}: calls on the same inputs differ")
        check_one_kernel_a_call(f"[K3] {tag}", "masked_conv", kernels, counted)
        ms = time_ms(run)
        ms32 = time_ms(lambda: K3.locally_masked_conv2d_kernel(
            x, pm, w, b, compute_dtype="float32", **kw), reps=3, rounds=3)
        pms = time_ms(lambda: K3.locally_masked_conv2d_plain(
            x, pm, w, b, compute_dtype="bfloat16", **kw), reps=3, rounds=3)
        # active (position, tap) pairs: mask on and the tap inside the image
        pairs = float(fold_boundary_masks(masks[:, mi], side, side, 3, dil).sum())
        flops = 2.0 * pairs * cin * cout
        # the timed call: x (read as f32), mask, bias and out in f32, the
        # weights in bf16
        by = (x.numel() + pm.rows.numel() + b.numel() + first.numel()) * 4 + w.numel() * 2
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
        log(f"[K3] {tag}: {ms:.4f} ms bf16 kernel (device {dev_us:.1f} us, host "
            f"{host_us(run):.1f} us a call), {ms32:.4f} ms f32 kernel, {pms:.3f} ms "
            f"plain, {flops / 1e9:.2f} GFLOP needed, {by / 1e6:.1f} MB, bound "
            f"{max(t_ops, t_bytes):.4f} ms")
        for k, v in (("ms", ms), ("pms", pms), ("ops", t_ops), ("bytes", t_bytes)):
            tot[k] += n_fwd * v
        tot["n"] += n_fwd
        timed.append((tag, x, pm, w, b, dil))
    # the streamed route: a grid whose rows and halo exceed the region
    s_side, s_b = 48, 2
    _, s_masks, _ = _half_grid(s_side)
    s_masks = s_masks.repeat(s_b, 1, 1, 1)
    for cin, cout in ((2 * Fc, Fc), (2 * Fc, 2 * Fc)):
        route = K3.k3_route(s_side, s_side, cin, 1, cluster)
        if route != "streamed":
            raise AssertionError(f"K3 at {s_side}x{s_side}, Cin {cin}: route {route}")
        x = torch.randn((s_b, s_side, s_side, cin), generator=gen).to(DEVICE)
        w = _uniform(gen, (9, cin, cout), 1.0 / (9 * cin) ** 0.5)
        b = _uniform(gen, (cout,), 0.03)
        before = K3.LAUNCHES["masked_conv_streamed"]
        worst = max(worst, _k3_check(f"({cin},{cout}) d1 at {s_b} x {s_side}x{s_side} "
                                     f"streamed", x, K3.prepare_mask(s_masks[:, 1]),
                                     w, b, 1))
        if K3.LAUNCHES["masked_conv_streamed"] != before + 1:
            raise AssertionError("the streamed K3 shape did not launch the streamed route")
    # the build with the other cluster size, on the main path's shapes
    other = 3 - cluster
    default_lib = _cuda._libs["masked_conv"]
    _cuda._libs["masked_conv"] = _cuda.load_variant("masked_conv", [f"K3_CLUSTER={other}"])
    try:
        if K3._lib().masked_conv_cluster() != other:
            raise AssertionError("the K3 variant build has the wrong cluster size")
        for tag, x, pm, w, b, dil in timed:
            worst = max(worst, _k3_check(f"{tag}, clusters of {other}", x, pm, w, b, dil))
            cin, cout = w.shape[1], w.shape[2]
            packed = prepare_taps(w, K3.kernel_width(cin, cout))
            run = lambda: K3.locally_masked_conv2d_kernel(x, pm, packed, b, dilation=dil)
            _, dev_us, _ = device_kernels(run)
            log(f"[K3] {tag}, clusters of {other}: {time_ms(run):.4f} ms, device "
                f"{dev_us:.1f} us a call")
    finally:
        _cuda._libs["masked_conv"] = default_lib
    # one entry: the mean over the 32 launches of a module-path forward
    # (14 + 14 + 4 of the three shapes), bound taken shape by shape
    n = tot["n"]
    report["masked_conv"] = _entry(
        "masked_conv", "masked_conv.cu", "pixelsynth_tpu/ops/masked_conv_pallas.py:26",
        worst, tot["ms"] / n, tot["pms"] / n, tot["ops"] / n, tot["bytes"] / n)
    log(f"[K3] masked_conv: mean of a forward's {n} launches {tot['ms'] / n:.4f} ms "
        f"(plain {tot['pms'] / n:.3f} ms)")


def _k4_case(B, side, Fc, case, gen):
    """Inputs of one K4 call: (B, side, side, Fc) activations, the masks of
    `_half_grid(side)` in the given `_mask_cases` case, seeded weights."""
    import torch
    from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask

    _, masks, _ = _half_grid(side)
    masks = _mask_cases(masks.repeat(B, 1, 1, 1))[case]
    og = torch.randn((B, side, side, Fc), generator=gen).to(DEVICE)
    a = torch.randn((B, side, side, Fc), generator=gen).to(DEVICE)
    bound = 1.0 / (18 * Fc) ** 0.5
    w1, b1 = _uniform(gen, (9, 2 * Fc, Fc), bound), _uniform(gen, (Fc,), bound)
    w2, b2 = _uniform(gen, (9, 2 * Fc, 2 * Fc), bound), _uniform(gen, (2 * Fc,), bound)
    ws, bs = _uniform(gen, (2 * Fc, Fc), (2 * Fc) ** -0.5), _uniform(gen, (Fc,), 0.1)
    return masks, prepare_mask(masks[:, 1]), og, a, (w1, b1, ws, bs, w2, b2)


def _k4_check(tag, args):
    """One K4 call against the plain version: (max, mean) |kernel - plain|.
    bf16 dot operands on both sides; a conv1 sum that straddles a bf16
    rounding boundary moves conv2's operand by one bf16 ulp, and two PONOs
    rescale it.  Such flips are rare and small, so the worst element is held
    to 2% of a unit (inside the 2% of the output's range that K1 is given)
    and the mean to 1e-4: a wrong skip bias or a shifted tap moves every
    element by far more than that."""
    import torch
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4

    out_k = K4.gated_resnet_kernel(*args)
    out_p = K4.gated_resnet_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    mean_err = float((out_k - out_p).abs().mean())
    tol, mean_tol = 0.02, 1e-4
    log(f"[K4] {tag}: max|kernel-plain| {err:.3e} (max|ref| "
        f"{float(out_p.abs().max()):.2f}, tol {tol:.1e}), mean {mean_err:.3e} "
        f"(tol {mean_tol:.0e})")
    if not (err <= tol and mean_err <= mean_tol):
        raise AssertionError(f"K4 disagrees with its plain version ({tag})")
    return err


def _k4_route_check(tag, B, side, Fc, compute_dtype, gen, timed=False):
    """K4's "k3" route (`k4_route`: f32 compute, or a shape the K4 kernel
    cannot hold) on the card against the plain version, with and without
    the skip, through `gated_resnet_kernel`: one call counted under the
    route's name, 3 (2 without the skip) K3 launches, no plain version.
    float32 within atol 1e-4 (no bf16 step anywhere in a call); bfloat16
    at K4's own tolerances (`_k4_check`).  Returns {skip: ms} when timed."""
    import torch
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4

    if K4.k4_route(side, side, Fc, compute_dtype) != "k3":
        raise AssertionError(f"K4 {tag}: not on the k3 route")
    _, pm, og, a, (w1, b1, ws, bs, w2, b2) = _k4_case(B, side, Fc, "order", gen)
    times = {}
    for skip in (False, True):
        args = (og, a if skip else None, pm, w1, b1, ws if skip else None,
                bs if skip else None, w2, b2)
        want = K4.gated_resnet_plain(*args, compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        zero_launches()
        got = K4.gated_resnet_kernel(*args, compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        check_no_plain(f"K4's k3 route ({tag})")
        n_k3 = launches.get("masked_conv", 0) + launches.get("masked_conv_streamed", 0)
        if launches.get("gated_resnet_k3") != 1 or "gated_resnet" in launches \
                or n_k3 != 2 + skip:
            raise AssertionError(f"K4 {tag} skip={skip}: launches {json.dumps(launches)}")
        err = float((got - want).abs().max())
        mean_err = float((got - want).abs().mean())
        tol, mean_tol = (1e-4, 1e-4) if compute_dtype == "float32" else (0.02, 1e-4)
        log(f"[K4] k3 route {tag} {compute_dtype} skip={skip}: launches "
            f"{json.dumps(launches)}; max|route-plain| {err:.3e} (tol {tol:.0e}), "
            f"mean {mean_err:.3e} (tol {mean_tol:.0e})")
        if not (err <= tol and mean_err <= mean_tol):
            raise AssertionError(f"K4's k3 route disagrees with the plain version ({tag})")
        if timed:
            times[skip] = time_ms(lambda: K4.gated_resnet_kernel(
                *args, compute_dtype=compute_dtype), reps=3, rounds=3)
    return times


def phase_k4(report, B=16, side=32, Fc=80, others=((4, 16), (17, 32))):
    """K4 with and without the skip at (B, side), timed; on the same size
    with every tap on and with whole tiles off; and at the `others` sizes
    (4 images of 16x16: two blocks an image; 17 of 32x32: two rounds)."""
    import torch
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4
    from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps, skipped_share
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks

    gen = torch.Generator().manual_seed(4)

    def args_of(skip, pm, og, a, weights):
        w1, b1, ws, bs, w2, b2 = weights
        return (og, a if skip else None, pm, w1, b1, ws if skip else None,
                bs if skip else None, w2, b2)

    worst = 0.0
    for b_, side_ in others:
        _, pm, og, a, weights = _k4_case(b_, side_, Fc, "order", gen)
        for skip in (False, True):
            worst = max(worst, _k4_check(f"({b_}, {side_}) skip={skip}",
                                         args_of(skip, pm, og, a, weights)))
    for case in ("all on", "tiles off"):
        _, pm, og, a, weights = _k4_case(B, side, Fc, case, gen)
        for skip in (False, True):
            worst = max(worst, _k4_check(
                f"masks {case!r} (steps skipped {skipped_share(pm.taps):.3f}) "
                f"skip={skip}", args_of(skip, pm, og, a, weights)))
    masks, pm, og, a, weights = _k4_case(B, side, Fc, "order", gen)
    w1, b1, ws, bs, w2, b2 = weights
    log(f"[K4] masks of the half-empty grid: (tile, tap) steps skipped "
        f"{skipped_share(pm.taps):.3f}")
    pairs = float(fold_boundary_masks(masks[:, 1], side, side, 3, 1).sum())
    res = {}
    for skip in (False, True):
        args = args_of(skip, pm, og, a, weights)
        err = _k4_check(f"({B}, {side}) skip={skip}", args)
        # the weights packed once, as the per-layer engine holds them
        fast = (og, args[1], pm, prepare_taps(w1, Fc), b1,
                prepare_taps(ws[None], Fc) if skip else None, args[6],
                prepare_taps(w2, Fc), b2)
        ms = time_ms(lambda: K4.gated_resnet_kernel(*fast))
        pms = time_ms(lambda: K4.gated_resnet_plain(*args), reps=3, rounds=3)
        flops = 2.0 * pairs * (2 * Fc * Fc + 4 * Fc * Fc)
        # the timed call: og, mask, biases and out in f32, the weights in bf16
        by = ((og.numel() * 2 + pm.rows.numel() + b1.numel() + b2.numel()) * 4
              + (w1.numel() + w2.numel()) * 2)
        if skip:
            flops += 2.0 * B * side * side * 2 * Fc * Fc
            by += (a.numel() + bs.numel()) * 4 + ws.numel() * 2
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
        log(f"[K4] skip={skip}: {ms:.4f} ms kernel, {pms:.3f} ms plain, "
            f"{flops / 1e9:.2f} GFLOP needed, {by / 1e6:.1f} MB, "
            f"bound {max(t_ops, t_bytes):.4f} ms")
        res[skip] = (max(err, worst), ms, pms, t_ops, t_bytes)
    # the "k3" route: f32 compute at this size (timed beside the kernel), and
    # bf16 at shapes the K4 kernel cannot hold (HW % 128 != 0, F > 80)
    route_ms = _k4_route_check(f"({B}, {side}) F={Fc}", B, side, Fc, "float32", gen,
                               timed=True)
    for b_, s_, f_ in ((4, 12, Fc), (4, 16, 96)):
        _k4_route_check(f"({b_}, {s_}) F={f_}", b_, s_, f_, "bfloat16", gen)
    for skip in (False, True):
        log(f"[K4] skip={skip} at ({B}, {side}) F={Fc}: f32 k3 route "
            f"{route_ms[skip]:.3f} ms a call ({2 + skip} K3 launches), bf16 K4 kernel "
            f"{res[skip][1]:.4f} ms")
    # one entry: the mean over a forward's 14 launches (6 without, 8 with skip)
    mean = [(6 * res[False][i] + 8 * res[True][i]) / 14 for i in range(1, 5)]
    report["gated_resnet"] = _entry(
        "gated_resnet", "gated_resnet.cu",
        "pixelsynth_tpu/ops/gated_resnet_pallas.py:71",
        max(res[False][0], res[True][0]), *mean)


def _k5_hard_rows(E=1 << 14, seed=5):
    """Three rows a sort gets wrong first: all keys equal (stability alone
    decides the indices), negative keys with both int32 extremes, keys
    already descending."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    neg = rng.integers(-2 ** 31, 2 ** 31, E, dtype=np.int64)
    neg[:4] = [-2 ** 31, 2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31]
    rows = {"all keys equal": np.full(E, 7, np.int64),
            "negative keys, int32 extremes": neg,
            "descending keys": np.arange(E, 0, -1, dtype=np.int64) - E // 2}
    return {k: torch.as_tensor(v.astype(np.int32)[None], device=DEVICE)
            for k, v in rows.items()}


def phase_k5(report, W=256):
    """K5 on real binning keys (`_k2_inputs`-style points through the
    binner's key function) at (1, 2^19) and (2, 2^17), and on three hard
    rows of 2^14: exact against torch.sort(stable=True) and against both
    plain versions (the radix passes in tensor ops; the TPU kernel's
    network)."""
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import sort_kernel as K5
    from pixelsynth_tpu_torch.ops.splat import _image_sort_keys

    def check(tag, keys):
        sk, sv = K5.sort_kv_kernel(keys)
        ref_k, ref_v = torch.sort(keys, dim=1, stable=True)
        torch.cuda.synchronize()
        n_bad = int((sk != ref_k).sum() + (sv.long() != ref_v).sum())
        plains = {"radix passes": K5.sort_kv_radix_plain(keys),
                  "network": K5.sort_kv_plain(keys)}
        same_plain = {name: bool(torch.equal(pk, sk) and torch.equal(pv, sv))
                      for name, (pk, pv) in plains.items()}
        log(f"[K5] {tag}, {int(keys.unique().numel())} distinct: equal to "
            f"torch.sort(stable=True) in keys and indices: {n_bad == 0}; to the "
            f"plain versions: {json.dumps(same_plain)}")
        if n_bad:
            raise AssertionError(f"K5 differs from a stable sort in {n_bad} places ({tag})")
        if not all(same_plain.values()):
            raise AssertionError(f"K5 differs from a plain version ({tag})")

    cfg = SplatConfig()
    log(f"[K5] launches a sort (kernels and the memset): {K5.launches_per_sort()}")
    for tag, keys in _k5_hard_rows().items():
        check(f"(1, 2^14) {tag}", keys)
    for B, N, main in ((2, 32768, False), (1, 65536 * 2, True)):
        _, pts, _, vld = _k2_inputs(W=W, N=N)
        keys, _ = _image_sort_keys(pts[:B], vld[:B], W, cfg)
        E = keys.shape[1]
        check(f"({B}, 2^{E.bit_length() - 1}) binning keys", keys)
        if not main:
            continue
        ms = time_ms(lambda: K5.sort_kv_kernel(keys))
        pms = time_ms(lambda: K5.sort_kv_radix_plain(keys), warmup=1, reps=1, rounds=3)
        nms = time_ms(lambda: K5.sort_kv_plain(keys), warmup=1, reps=1, rounds=3)
        lib = time_ms(lambda: torch.sort(keys, dim=1, stable=True))
        # bytes: each key read once (4 B), each sorted key and index written
        # once (8 B): 12 B an element; no floating-point work
        by = 12.0 * B * E
        t_bytes = by / PEAK_BYTES * 1e3
        report["sort_kv"] = _entry(
            "sort_kv", "sort_kv.cu", "pixelsynth_tpu/ops/sort_pallas.py:158",
            0.0, ms, pms, 0.0, t_bytes, library_ms=lib)
        log(f"[K5] sort_kv (1, 2^19): {ms:.4f} ms kernel, {pms:.2f} ms plain radix "
            f"passes, {nms:.2f} ms plain network, {lib:.4f} ms "
            f"torch.sort(stable=True), bound {t_bytes:.4f} ms "
            f"(12 B x {B * E} elements / 3.35 TB/s)")


def _background_distances(ps, img, cams):
    """The signed distance grid of a view's splat background, as
    masks_for_background builds it."""
    import torch
    from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
    from pixelsynth_tpu_torch.pipeline import binarize_trunc, downsample_mask

    with torch.no_grad():
        depth = ps.regress_depth(img)
        _, bg, _ = ps.splat_view(ps.features(img), depth, cams)
    return signed_distance_field(binarize_trunc(downsample_mask(~bg)),
                                 binarize_trunc(downsample_mask(bg)))


def _order_grids():
    """The order kernel's test grids -> {tag: (B, H, W) int32 on the card}:
    the default view's own distance grid (Config(), seed 0, the input and
    camera of `_run_view`: 32x32), the relay checkpoint's on four held-out
    pairs (16x16), and seeded random grids with many equal distances at
    B = 1 and B = 64, and at 48x48, 40x48, 64x64 and 99x99 (the frontier's
    2-4 and 10 words a lane), and 16x16 grids whose distances span more
    values than the kernel's counting sort takes (its bitonic ranking)."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.data.panorama import pair_items, val_pairs
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.pipeline import PixelSynth

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    ps = PixelSynth(Config(), device=DEVICE, seed=0)
    img, cams = _view_inputs(ps.W)
    _, RT = get_rt_from_rot("R", cams["P"], scene_mode=False, rotation=0.3)
    view = _background_distances(ps, dev(img), {
        "K": dev(cams["K"]), "Kinv": dev(cams["Kinv"]), "Pinv_in": dev(cams["Pinv"]),
        "P_out": dev(RT)})
    ps = PixelSynth.from_stitched(os.path.join(REPO, "evidence/relay/stitched.npz"),
                                  device=DEVICE)
    items = pair_items(val_pairs(ps.W, 4))
    b = {k: dev(np.stack([it[k] for it in items])) for k in items[0]}
    relay = _background_distances(ps, b["input_img"], b)
    rng = np.random.default_rng(3)
    grids = {"default view 1x32x32": view, "relay checkpoint 4x16x16": relay}
    for B, H, W in ((1, 32, 32), (64, 32, 32), (2, 48, 48), (1, 40, 48), (1, 64, 64),
                    (1, 99, 99)):
        grids[f"random ties {B}x{H}x{W}"] = torch.as_tensor(
            rng.integers(-3, 4, (B, H, W)).astype(np.int32), device=DEVICE)
    # a span of distances wider than the kernel's counting table: its
    # bitonic ranking
    grids["wide span 2x16x16"] = torch.as_tensor(
        rng.integers(-3000, 3001, (2, 16, 16)).astype(np.int32), device=DEVICE)
    return {k: v.to(torch.int32).contiguous() for k, v in grids.items()}


def _chain_floor(mode, steps):
    """csrc/custom_order.cu's `order_chain_floor` probe: one warp, `steps`
    dependent iterations of mode 0 (a shared load + a redux.sync) or mode
    1 (a ballot + __ffs + a shuffle) -> (ms a launch by CUDA events,
    clock64 cycles an iteration)."""
    import ctypes

    import torch
    from pixelsynth_tpu_torch.ops import _cuda

    lib = _cuda.load("custom_order")
    fn = lib.order_chain_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int32, device=DEVICE)

    def run():
        _cuda.check(fn(mode, steps, _cuda.ptr(out), _cuda.stream_of(out)), "order_chain_floor")

    ms = time_ms(run)
    run()
    torch.cuda.synchronize()
    return ms, int(out[1]) / steps


def phase_orders(report):
    """The order kernel (csrc/custom_order.cu) against its plain version
    (custom_orders_jax's loop in torch ops, on the card) and against the
    host heap (ops/orders.py: native/custom_order.cpp where g++ builds it,
    else heapq), bit for bit, one launch a call, on `_order_grids`; timed
    on the default view's grid (B = 1, what a view builds) and at B = 64,
    beside the plain version and the host path (copy to the host, heap,
    copy back) as the yardstick; and the chain's floor (`_chain_floor`)
    beside the kernel's time a step."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.ops import orders as O
    from pixelsynth_tpu_torch.ops import orders_device as D

    grids = _order_grids()
    for tag, dist in grids.items():
        before = D.LAUNCHES["custom_order"]
        got = D.custom_order_device(dist)
        torch.cuda.synchronize()
        n = D.LAUNCHES["custom_order"] - before
        plain = D.custom_order_plain(dist)
        heap = O.custom_order_flat(dist.cpu().numpy())
        same_plain = bool(torch.equal(got, plain))
        same_heap = bool(np.array_equal(got.cpu().numpy(), heap))
        log(f"[orders] {tag}: {n} launch, equal to the plain version {same_plain}, "
            f"to the host heap ({O.HOST_ORDER_PATH}) {same_heap}")
        if n != 1 or not (same_plain and same_heap):
            raise AssertionError(f"the order kernel failed on {tag}")

    rows = {}

    def host(d):
        return torch.as_tensor(O.custom_order_flat(d.cpu().numpy()), device=DEVICE)

    for tag, d in (("1x32x32", grids["default view 1x32x32"]),
                   ("64x32x32", grids["random ties 64x32x32"])):
        ms = time_ms(lambda: D.custom_order_device(d))
        pms = time_ms(lambda: D.custom_order_plain(d), warmup=1, reps=1, rounds=3)
        hms = time_ms(lambda: host(d), warmup=1, reps=3, rounds=3)
        B, H, W = d.shape
        HW = H * W
        # bytes: the distances read once, the order written once (4 B each)
        t_bytes = 8.0 * B * HW / PEAK_BYTES * 1e3
        # operations: a heap's comparisons, HW log2 HW an image, at the
        # card's 32-bit rate outside the tensor cores
        t_ops = B * HW * np.log2(HW) / PEAK_F32_FLOPS * 1e3
        # a model, not a measurement: HW - 1 dependent steps of an assumed
        # 60 cycles (a shared-memory load and two warp reductions) at an
        # assumed 1.98 GHz; logged only, never in the kernels line
        step_model = (HW - 1) * 60 / 1.98e9 * 1e3
        rows[tag] = (ms, pms, hms, t_bytes, t_ops)
        log(f"[orders] custom_order {tag}: {ms:.4f} ms kernel, {pms:.2f} ms plain, "
            f"{hms:.3f} ms host heap ({O.HOST_ORDER_PATH}: copy, heap, copy back), "
            f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({'bytes' if t_bytes >= t_ops else 'operations'}); "
            f"step model (assumed 60 cycles x {HW - 1} steps at 1.98 GHz) {step_model:.4f} ms")
    # the chain's floor, timed in this run: one warp looping HW - 1 times
    # over one shared load + one redux.sync (the first design's links) and
    # over one ballot + ffs + shuffle (this design's pop)
    steps = 32 * 32 - 1
    ms1 = rows["1x32x32"][0]
    for mode, links in enumerate(("a shared load + __reduce_max_sync",
                                  "__ballot_sync + __ffs + __shfl_sync")):
        ms, cycles = _chain_floor(mode, steps)
        log(f"[orders] chain floor, {links}: {cycles:.1f} cycles a step (clock64), "
            f"{ms * 1e6 / steps:.1f} ns a step ({ms:.4f} ms a launch of {steps} steps); "
            f"the order kernel at 1x32x32: {ms1 * 1e6 / steps:.1f} ns a step "
            f"({ms1:.4f} ms a call, the ranking and the launch included) on {card_line()}")
    ms, pms, hms, t_bytes, t_ops = rows["1x32x32"]
    report["custom_order"] = _entry(
        "custom_order", "custom_order.cu",
        "pixelsynth_tpu/ops/orders_jax.py:33 custom_order_jax (XLA, not Pallas)",
        0.0, ms, pms, t_ops, t_bytes)
    report["custom_order"].update(heap_ms=hms, ms_b64=rows["64x32x32"][0],
                                  heap_ms_b64=rows["64x32x32"][2])


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


def _counters(attr="LAUNCHES"):
    """The wrappers' counts of launches (`LAUNCHES`) or of calls that took
    the plain version (`PLAIN_CALLS`)."""
    from pixelsynth_tpu_torch.ops import (
        gated_resnet_kernel, lmconv_fused, masked_conv_kernel, orders_device,
        sort_kernel, splat)

    return [getattr(m, attr) for m in (lmconv_fused, splat, masked_conv_kernel,
                                       gated_resnet_kernel, sort_kernel, orders_device)]


def zero_launches():
    for counts in _counters() + _counters("PLAIN_CALLS"):
        counts.update(dict.fromkeys(counts, 0))


def read_launches(attr="LAUNCHES"):
    out = {}
    for counts in _counters(attr):
        out.update(counts)
    return out


def check_no_plain(path):
    """No wrapper took its plain version since the counts were zeroed."""
    plain = {k: v for k, v in read_launches("PLAIN_CALLS").items() if v}
    if plain:
        raise AssertionError(f"{path} ran plain versions: {json.dumps(plain)}")


def record_launches(report, launches, names, path):
    """Write the launch counts of the kernels `names`, read just after the
    path that runs them, into the report under that path
    (`launches_by_path`); a kernel's `launches` is their sum over every
    path that runs it.  Each must have launched."""
    for name in names:
        by_path = report[name].setdefault("launches_by_path", {})
        if path in by_path:
            raise AssertionError(f"{path}: launches of {name} recorded twice")
        by_path[path] = launches[name]
        report[name]["launches"] = sum(by_path.values())
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on {path}")


def _run_view(tag, cfg, masks_backends=False):
    """One timed `generate_view` (second call) at `cfg`, pop 16, every
    stage of the view step with re-ranking by classifier entropy.  Launch
    counts are zeroed just before it and read just after.  With
    masks_backends, the same view afterwards through both
    `lmconv.masks_backend` values (`check_masks_backends`)."""
    import torch
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator, StageTimer

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
    zero_launches()
    gen.timer = StageTimer(DEVICE)
    t0 = time.perf_counter()
    best, out = run(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stages = gen.timer.times_ms()
    if masks_backends:
        check_masks_backends(_views_by_masks_backend(ps, gen, run))
    l = cfg.model.lmconv
    n_bg = int((out["bg_ds"] >= 1 - 1e-6).sum())
    log(f"[{tag}] W={W} codes {l.obs[1]}x{l.obs[2]} F={l.nr_filters} "
        f"sample_backend={l.sample_backend} sort_backend={cfg.model.splat.sort_backend} "
        f"spec={cfg.sample.speculative} pop 16: {wall * 1e3:.1f} ms wall (second call)")
    log(f"[{tag}] stage ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log(f"[{tag}] background cells {n_bg}; launches in the timed view: "
        f"{json.dumps(launches)}")
    bi = best.float()
    if not (bool(torch.isfinite(bi).all()) and tuple(bi.shape) == (1, W, W, 3)
            and float(bi.abs().max()) <= 1.0):
        raise AssertionError("view output is not a finite image in [-1, 1]")
    if n_bg == 0:
        raise AssertionError("the view had nothing to outpaint")
    # this view's splat input: its own points and the (still empty) cloud
    from pixelsynth_tpu_torch.geometry.projection import (
        homogeneous_to_pixels, lift_to_cloud)
    c = gen._cams(view_cams)
    cloud = lift_to_cloud(out["depth"], c["K"], c["Kinv"], c["Pinv_in"], c["P_out"], W)
    pts, valid = homogeneous_to_pixels(cloud, W)
    pts = torch.cat([pts, torch.zeros_like(pts)], 1)
    valid = torch.cat([valid, torch.zeros_like(valid)], 1)
    return out, launches, n_bg, pts, valid


def phase_view(report, cfg=None):
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.ops import splat

    cfg = cfg or Config()
    out, launches, n_bg, pts, valid = _run_view("view", cfg, masks_backends=True)
    st = out["ar_stats"]
    if st["n_forwards"] == 0:
        raise AssertionError("the view had nothing to outpaint")
    log(f"[view] AR forwards {st['n_forwards']}, cells committed per forward "
        f"{n_bg / max(1, st['n_forwards']):.2f}")
    record_launches(report, launches, ("lmconv_up", "lmconv_down", "splat_blend",
                                       "custom_order"), "the default view")
    # what the (tile, tap) skip saves on this view's own order
    from pixelsynth_tpu_torch.ops.conv_pack import skipped_share
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks, tile_tables
    side, dil = cfg.model.lmconv.obs[1], cfg.model.lmconv.max_dilation
    tu, td = tile_tables(fold_boundary_masks(out["masks"][:, 1], side, side, 3, 1),
                         fold_boundary_masks(out["masks"][:, 2], side, side, 3, dil))
    log(f"[view] (tile, tap) steps skipped on this view's masks: "
        f"{skipped_share(tu):.3f} (dilation 1), {skipped_share(td):.3f} "
        f"(dilation {dil})")
    # capacity truncation of this view's splat
    _, _, counts = splat._bin_points_batched(pts, valid, cfg.model.W, cfg.model.splat,
                                             return_counts=True)
    over = torch.clamp(counts - cfg.model.splat.max_points_per_tile, min=0)
    log(f"[view] splat: max entries per tile {int(counts.max())}, entries over "
        f"max_points_per_tile={cfg.model.splat.max_points_per_tile}: {int(over.sum())}")


def phase_view_f32(cfg=None):
    """The view of phase 3 with lmconv.compute_dtype="float32": every AR
    forward takes K1's "k3" route (K3's f32 kernel), no K1 launch and no
    plain version."""
    from pixelsynth_tpu_torch.config import Config

    cfg = cfg or Config()
    cfg.model.lmconv.compute_dtype = "float32"
    out, launches, n_bg, _, _ = _run_view("view-f32", cfg)
    check_no_plain("the f32 view")
    n_fwd = out["ar_stats"]["n_forwards"]
    want = {"lmconv_up_k3": n_fwd, "lmconv_down_k3": n_fwd, "lmconv_up": 0,
            "lmconv_down": 0}
    got = {k: launches[k] for k in want}
    n_k3 = launches["masked_conv"]
    log(f"[view-f32] {n_fwd} AR forwards: {json.dumps(got)}, {n_k3} K3 launches "
        f"({sum(K3_A_PASS.values())} a forward)")
    if n_fwd == 0 or got != want or n_k3 != sum(K3_A_PASS.values()) * n_fwd \
            or launches["splat_blend"] != 1:
        raise AssertionError(f"the f32 view left the k3 route: {json.dumps(launches)}")


def _engine_fns(B=16, side=32, Fc=80):
    """The three PixelCNN engines on one seeded parameter set, at pop B on
    the half-empty grid of `_half_grid`: ({name: (logits_fn, K3/K4 launches
    a forward)}, the K1 path's logits_fn, and the inputs they share)."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN, flax_named_params
    from pixelsynth_tpu_torch.models.lmconv_fast import fast_logits_fn
    from pixelsynth_tpu_torch.ops.lmconv_fused import (
        make_fused_logits_fn, pack_lmconv_params)
    from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask
    from pixelsynth_tpu_torch.weights import unflatten_tree

    cfg, flat = _pixelcnn_params(Fc)
    l = cfg.model.lmconv
    model = LMPixelCNN(nr_resnet=l.nr_resnet, nr_filters=Fc,
                       input_channels=l.input_channels, num_classes=l.num_classes,
                       compute_dtype="bfloat16", backend="pallas")
    with torch.no_grad():
        model.load_flax(unflatten_tree(flat))
    model = model.to(DEVICE).eval()
    params = flax_named_params(model)
    order, masks, bg_ds = _half_grid(side)
    order, masks, bg_ds = (t.repeat(B, *[1] * (t.dim() - 1)) for t in (order, masks, bg_ds))
    triple = (masks[:, 0], prepare_mask(masks[:, 1]), prepare_mask(masks[:, 2]))

    @torch.no_grad()
    def module_fn(codes, filled):
        return model(None, *triple, codes=codes, filled=filled)

    engines = {"module": (module_fn, {"masked_conv": 32}),
               "fast": (fast_logits_fn(params, masks, model),
                        {"gated_resnet": 14, "masked_conv": 4})}
    k1_fn = make_fused_logits_fn(pack_lmconv_params(params, nr_resnet=l.nr_resnet,
                                                    device=DEVICE), masks)
    rng = np.random.default_rng(5)
    codes = torch.as_tensor(rng.integers(0, 512, (B, side, side)), device=DEVICE)
    filled = (1.0 - bg_ds).float()
    return engines, k1_fn, dict(codes=codes, filled=filled, order=order, masks=masks,
                                triple=triple, bg_ds=bg_ds, lmconv=l)


def phase_engines(report, B=16, side=32, Fc=80):
    """The AR fill of the bench protocol (`ar_sample` over every background
    cell of a half-empty grid, one cell per forward) through the module
    path (K3) and through the per-layer kernel engine (K4 + K3); each
    engine's logits are held to the K1 path's on the same inputs."""
    import torch
    from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN
    from pixelsynth_tpu_torch.sampling import ar_sample

    engines, k1_fn, inp = _engine_fns(B, side, Fc)
    codes, filled, order, masks, triple, bg_ds, l = (
        inp[k] for k in ("codes", "filled", "order", "masks", "triple", "bg_ds",
                         "lmconv"))
    want = k1_fn(codes, filled)
    n_bg = int((bg_ds[0] >= 1 - 1e-6).sum())
    for name, (fn, per_forward) in engines.items():
        zero_launches()
        got = fn(codes, filled)
        torch.cuda.synchronize()
        one = {k: v for k, v in read_launches().items() if v}
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        err = float((got - want).abs().max())
        log(f"[engines] {name}: launches per forward {json.dumps(one)}; against the "
            f"K1 path argmax agreement {agree:.4f} (tol >= 0.97), max|diff| {err:.3e}")
        if one != per_forward:
            raise AssertionError(f"{name} engine: launches per forward {one}, "
                                 f"expected {per_forward}")
        if not agree >= 0.97:
            raise AssertionError(f"{name} engine disagrees with the K1 path")
        fwd_ms = time_ms(lambda: fn(codes, filled), reps=5, rounds=3)
        gen = torch.Generator(device=DEVICE).manual_seed(6)
        zero_launches()
        t0 = time.perf_counter()
        sampled = ar_sample(fn, codes, order, bg_ds, gen, num_classes=512)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        log(f"[engines] {name}: {fwd_ms:.3f} ms per forward (pop {B}); AR fill of "
            f"{n_bg} cells in {secs * 1e3:.1f} ms; launches {json.dumps(launches)}")
        for k, v in per_forward.items():
            if launches[k] != v * n_bg:
                raise AssertionError(f"{name} engine: {launches[k]} {k} launches in "
                                     f"{n_bg} forwards, expected {v * n_bg}")
        keep = bg_ds < 1 - 1e-6
        if not (torch.equal(sampled[keep], codes[keep])
                and int(sampled.min()) >= 0 and int(sampled.max()) < 512):
            raise AssertionError(f"{name} engine: the AR fill changed a known cell "
                                 "or left the code range")
        if name == "fast":
            record_launches(report, launches, ("gated_resnet",),
                            "the per-layer engine's AR fill")
    # lmconv.conv_mask_weight: the learned term on the mask is added beside
    # K3, so the module path still launches it 32 times a forward; held to
    # the plain masked conv (backend "xla") with the same weights
    kw = dict(nr_resnet=l.nr_resnet, nr_filters=Fc, input_channels=l.input_channels,
              num_classes=l.num_classes, compute_dtype="bfloat16",
              conv_mask_weight=True)
    with_mw = LMPixelCNN(backend="pallas", **kw)
    with torch.no_grad():
        with_mw.reset(torch.Generator().manual_seed(7))
    with_mw = with_mw.to(DEVICE).eval()
    plain_mw = LMPixelCNN(backend="xla", **kw).to(DEVICE).eval()
    plain_mw.load_state_dict(with_mw.state_dict())
    raw = (masks[:, 0], masks[:, 1], masks[:, 2])
    zero_launches()
    with torch.no_grad():
        got = with_mw(None, *triple, codes=codes, filled=filled)
        n_k3 = read_launches()["masked_conv"]
        want_mw = plain_mw(None, *raw, codes=codes, filled=filled)
    agree = float((got.argmax(-1) == want_mw.argmax(-1)).float().mean())
    log(f"[engines] module with conv_mask_weight: {n_k3} K3 launches a forward; against "
        f"the plain masked conv argmax agreement {agree:.4f} (tol >= 0.97), "
        f"max|diff| {float((got - want_mw).abs().max()):.3e}")
    if n_k3 != 32 or not agree >= 0.97:
        raise AssertionError("the module path with conv_mask_weight left K3 or "
                             "disagrees with the plain masked conv")


def phase_view2(report):
    """This slice's path through the normal entry points at full width:
    the view of phase 3 with sample_backend="pallas" (K3 per masked conv)
    and sort_backend="pallas" (K5 binning)."""
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.ops import splat

    cfg = Config()
    cfg.model.lmconv.sample_backend = "pallas"
    cfg.model.splat.sort_backend = "pallas"
    out, launches, n_bg, pts, valid = _run_view("view-2", cfg)
    record_launches(report, launches, ("masked_conv", "sort_kv"),
                    'the view with sample_backend="pallas", sort_backend="pallas"')
    # one cell per forward, 32 masked convs a forward; one splat a view
    if launches["masked_conv"] != 32 * n_bg:
        raise AssertionError(f"{launches['masked_conv']} K3 launches for {n_bg} "
                             "forwards, expected 32 a forward")
    if launches["sort_kv"] != 1 or launches["splat_blend"] != 1:
        raise AssertionError("expected one K5 and one K2 launch per splat, got "
                             f"{launches['sort_kv']} and {launches['splat_blend']}")
    if launches["lmconv_up"] or launches["gated_resnet"]:
        raise AssertionError("the module path launched another engine's kernel")
    # the K5 binner against the library-sort binner on this view's points
    # (B = 1 keeps 16 depth-bucket bits in both)
    W, sc = cfg.model.W, cfg.model.splat
    idx_k, ok_k = splat._bin_points_batched_pallas(pts, valid, W, sc)
    idx_l, ok_l = splat._bin_points_batched(pts, valid, W, sc)
    same = bool(torch.equal(ok_k, ok_l)) and bool(torch.equal(idx_k[ok_l], idx_l[ok_l]))
    log(f"[view-2] binning tables of the K5 binner and the library-sort binner "
        f"({int(ok_l.sum())} valid slots) identical: {same}")
    if not same:
        raise AssertionError("the K5 binner's tables differ from the library-sort binner's")


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


def phase_relay(report, n_pairs=48, batch=8, consistency_items=16, num_samples=None,
                spread_seeds=range(4)):
    """The relay gate (eval/relay_report.py `build_report`) on the trained
    checkpoint at the report's own sizes: 48 held-out pairs in batches of
    8, the checkpoint's 8 samples, T = 0.5 for the paired and consistency
    evals, 16 consistency items, and the demo CLI's walk of the held-out
    world at the checkpoint's walk settings; its numbers beside the JAX
    report's (evidence/relay/relay_report.json), held to the floors of
    tests/test_relay_artifact.py.  K1 and K2 must launch and no plain
    version run; the output goes under build/relay/.  Then, logged and not
    held, the same walk at `spread_seeds` (tools/relay_walk_spread.py):
    each seed's gt PSNR and adjacency, and their means, beside the JAX
    package's 8-seed CPU means (evidence/torch/walk_parity/)."""
    import torch
    from pixelsynth_tpu_torch.eval.relay_report import (
        build_report, fresh_view_entropy, relay_floors)
    from pixelsynth_tpu_torch.pipeline import PixelSynth

    ckpt = os.path.join(REPO, "evidence/relay/stitched.npz")
    with open(os.path.join(REPO, "evidence/relay/relay_report.json")) as f:
        jax_report = json.load(f)
    out_dir = os.path.join(REPO, "build", "relay")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    got = build_report(ckpt, out_dir, device=DEVICE, num_samples=num_samples,
                       n_pairs=n_pairs, batch=batch, consistency_items=consistency_items)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    log(f"[relay] build_report in {secs:.1f} s on {card_line()} (paired "
        f"{got['paired_eval_seconds']:.1f} s, consistency {got['consistency_seconds']:.1f}"
        f" s, demo walk {got['scene_walk_seconds']:.1f} s); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check_no_plain("the relay gate")
    record_launches(report, launches, ("lmconv_up", "lmconv_down", "splat_blend",
                                       "custom_order"), "the relay gate")
    for k, v in got.items():
        if isinstance(v, (int, float)) and not k.endswith(("seconds", "time")):
            log(f"[relay] {k}: port {v!r}, JAX report {jax_report.get(k)!r}")
    for k in ("scene_gt_psnr_by_numerator", "scene_gt_psnr_by_direction"):
        log(f"[relay] {k}: port {json.dumps(got[k])}")
        log(f"[relay] {k}: JAX report {json.dumps(jax_report.get(k))}")
    # tests/test_relay_artifact.py:138-154: a trained classifier is confident
    # on fresh panorama views
    ent = fresh_view_entropy(PixelSynth.from_stitched(ckpt, device=DEVICE))
    log(f"[relay] classifier entropy on fresh views {ent['entropy']:.4f} "
        f"(ln(classes) = {ent['ln_classes']:.4f})")
    failed = []
    for name, value, holds in relay_floors(got, jax_report, ent["entropy"],
                                           ent["ln_classes"]):
        log(f"[relay] floor {name}: {value[0]!r} against {value[1]!r}: "
            f"{'holds' if holds else 'FAILS'}")
        if not holds:
            failed.append(name)
    # the walk's spread over seeds 0-3 on the same artifact, on record and
    # not held (seed 0 is the gate's walk above)
    from pixelsynth_tpu_torch.tools.relay_walk_spread import walk_spread

    spread = walk_spread(ckpt, spread_seeds, os.path.join(out_dir, "spread"), device=DEVICE)
    for row in spread["rows"]:
        log(f"[relay] walk seed {row['seed']}: gt {row['gt']!r}, adjacent "
            f"{row['adjacent']!r} ({row['seconds']:.1f} s)")
    log(f"[relay] walk seeds {list(spread_seeds)}: mean gt "
        f"{spread['summary']['gt']['mean']!r}, mean adjacent "
        f"{spread['summary']['adjacent']['mean']!r} (not held)")
    with open(os.path.join(REPO, "evidence/torch/walk_parity/jax_cpu_spread.json")) as f:
        jax_spread = json.load(f)["summary"]
    log(f"[relay] the JAX package's walk at seeds 0-7 on the CPU: mean gt "
        f"{jax_spread['gt']['mean']!r} (sd {jax_spread['gt']['sd']!r}), mean adjacent "
        f"{jax_spread['adjacent']['mean']!r} (sd {jax_spread['adjacent']['sd']!r})")
    if got["n_pairs"] != n_pairs or got["n_consistency_items"] != consistency_items \
            or got["n_scene_views_scored"] != jax_report["n_scene_views_scored"]:
        raise AssertionError("the relay gate did not run at the report's sizes")
    if failed:
        raise AssertionError(f"relay floors failed: {failed}")


def _views_by_masks_backend(ps, gen, run, pairs=12):
    """The default view (seed 2) through each `lmconv.masks_backend` in
    `pairs` alternating pairs ("jax" first in even pairs, "host" first in
    odd ones) -> {backend: ([orders_masks ms], [view wall ms], [best
    images], the last run's outputs, order-kernel launches)}, the i-th
    entries of the two backends' lists one pair."""
    import torch
    from pixelsynth_tpu_torch.ops import orders_device as D
    from pixelsynth_tpu_torch.scene import StageTimer

    l = ps.cfg.model.lmconv
    got = {b: ([], [], [], None, 0) for b in ("jax", "host")}
    for i in range(pairs):
        for backend in (("jax", "host") if i % 2 == 0 else ("host", "jax")):
            l.masks_backend = backend
            stage_ms, wall_ms, bests, _, n = got[backend]
            launches = D.LAUNCHES["custom_order"]
            gen.timer = StageTimer(DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best, out = run(2)
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            stage_ms.append(gen.timer.times_ms()["orders_masks"])
            bests.append(best.float())
            got[backend] = (stage_ms, wall_ms, bests, out,
                            n + D.LAUNCHES["custom_order"] - launches)
    l.masks_backend = "jax"
    gen.timer = StageTimer(DEVICE)
    return got


def check_masks_backends(got):
    """Both backends give the same orders, masks and sampled codes (the
    order kernel replaces the heap bit for bit), and views as close as
    repeated runs of one backend: the card's float sums after the sampler
    are not bit-reproducible (~1e-6 between runs), so the views are held
    to 1e-5 of their [-1, 1] range, beside that spread.  The host path
    launches no order kernel.  Logs each pair's `orders_masks` and view
    ms and the medians of the pairs' differences ("jax" - "host")."""
    import numpy as np
    import torch

    (jms, jwall, jviews, jout, jn), (hms, hwall, hviews, hout, hn) = got["jax"], got["host"]
    log(f"[view] {len(jms)} alternating pairs on {card_line()}; orders_masks stage ms, "
        f"masks_backend=\"jax\" (the order kernel): {json.dumps([round(v, 4) for v in jms])}; "
        f"\"host\" (copy, heap, copy back): {json.dumps([round(v, 4) for v in hms])}; "
        f"view wall ms \"jax\": {json.dumps([round(v, 2) for v in jwall])}; "
        f"\"host\": {json.dumps([round(v, 2) for v in hwall])}; order-kernel launches "
        f"{jn} / {hn}")
    d_stage = np.subtract(jms, hms)
    d_wall = np.subtract(jwall, hwall)
    log(f"[view] paired \"jax\" - \"host\": orders_masks median {np.median(d_stage):.4f} ms "
        f"({int((d_stage < 0).sum())} of {len(d_stage)} pairs faster with \"jax\"), "
        f"view wall median {np.median(d_wall):.2f} ms "
        f"({int((d_wall < 0).sum())} of {len(d_wall)} faster)")
    same = {k: bool(torch.equal(jout[k], hout[k])) for k in ("order", "masks", "sampled")}

    def spread(views):
        return max(float((v - views[0]).abs().max()) for v in views)

    within = max(spread(jviews), spread(hviews))
    gap = max(float((j - h).abs().max()) for j, h in zip(jviews, hviews))
    log(f"[view] \"jax\" against \"host\": equal {json.dumps(same)}; views max |diff| "
        f"{gap} (repeated runs of one backend: {within})")
    if not all(same.values()) or jn < len(jms) or hn != 0:
        raise AssertionError("the masks backends disagree on the orders or the sampled "
                             "codes, or the order kernel did not run a view / ran on "
                             "the host path")
    if gap > 1e-5:
        raise AssertionError(f"the \"host\" view differs from the \"jax\" view by {gap}")


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_relay_chain(report):
    """The port's relay chain (tools/run_relay.py) with --smoke settings at
    W=128 and the Config() network widths, on the card, into a fresh
    build/relay_chain/: all ten stages, each stage's seconds and its
    launches of K1, K2, K3 and the order kernel; the stitched npz loaded by
    weights.load_stitched_npz renders a finite view in [-1, 1]; the report
    carries every key of evidence/relay/relay_report.json; and
    evidence/relay/stitched.npz is byte for byte what it was."""
    import shutil

    import numpy as np
    import torch
    from pixelsynth_tpu_torch.data.panorama import pair_items, val_pairs
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator
    from pixelsynth_tpu_torch.tools.run_relay import STAGE_FNS, STAGES, run_relay
    from pixelsynth_tpu_torch.weights import from_jax_params, load_stitched_npz

    kept = os.path.join(REPO, "evidence/relay/stitched.npz")
    sha = _sha256(kept)
    workdir = os.path.join(REPO, "build", "relay_chain")
    shutil.rmtree(workdir, ignore_errors=True)
    names = ("lmconv_up", "lmconv_down", "splat_blend", "masked_conv", "custom_order")
    per_stage = {}
    torch.cuda.synchronize()
    zero_launches()
    last = [read_launches()]

    def counted(stage, fn):
        def run(*args):
            t0 = time.perf_counter()
            summary = fn(*args)
            torch.cuda.synchronize()
            now = read_launches()
            per_stage[stage] = {k: now[k] - last[0][k] for k in names}
            last[0] = now
            log(f"[chain] {stage}: {time.perf_counter() - t0:.2f} s, launches "
                f"{json.dumps(per_stage[stage])}")
            return summary
        return run

    stage_fns = dict(STAGE_FNS)
    STAGE_FNS.update({k: counted(k, fn) for k, fn in stage_fns.items()})
    t0 = time.perf_counter()
    try:
        results = run_relay(workdir, smoke=True, width=128, device=DEVICE)
    finally:
        STAGE_FNS.update(stage_fns)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    log(f"[chain] run_relay --smoke W=128: {secs:.1f} s on {card_line()}; stage s "
        + json.dumps({k: round(v["seconds"], 2) for k, v in results.items()}))
    check_no_plain("the relay chain")
    record_launches(report, launches, ("lmconv_up", "lmconv_down", "splat_blend",
                                       "custom_order"), "the relay chain")
    if list(results) != STAGES or any(
            not os.path.exists(os.path.join(workdir, f"{s}.done.json")) for s in STAGES):
        raise AssertionError(f"the relay chain ran {list(results)}, not every stage")
    for k in ("best_val_mse", "val_bpd", "val_accuracy", "val_bpd_lmconv_ema",
              "val_bpd_dpr_joint"):
        for stage, summary in results.items():
            if k in summary:
                log(f"[chain] {stage} {k}: {summary[k]!r}")

    npz = os.path.join(workdir, "evidence", "stitched.npz")
    cfg, variables, meta = load_stitched_npz(npz)
    log(f"[chain] stitched.npz {os.path.getsize(npz) / 1e6:.1f} MB, trees "
        f"{sorted(variables)}, meta {json.dumps(meta)}")
    cfg.refresh_splat_perf_knobs()
    ps = PixelSynth(cfg, device=DEVICE, state_dicts=from_jax_params(variables, cfg))
    gen = SceneGenerator(ps, num_samples=2)
    it = pair_items(val_pairs(ps.W, 1))[0]
    cams = {k: it[k][None] for k in ("K", "Kinv", "P_in", "Pinv_in", "P_out")}
    best, _ = gen.generate_view(it["input_img"][None], cams,
                                CloudState.empty(1, ps.W * ps.W, 3, DEVICE), None,
                                cams["Pinv_in"], 5)
    b = best.float()
    log(f"[chain] a view of the stitched checkpoint: shape {tuple(b.shape)}, range "
        f"[{float(b.min()):.3f}, {float(b.max()):.3f}]")
    if not (bool(torch.isfinite(b).all()) and float(b.abs().max()) <= 1.0):
        raise AssertionError("the stitched checkpoint's view is not finite in [-1, 1]")

    with open(os.path.join(REPO, "evidence/relay/relay_report.json")) as f:
        want = set(json.load(f))
    with open(os.path.join(workdir, "evidence", "relay_report.json")) as f:
        got = json.load(f)
    missing = sorted(want - set(got))
    log(f"[chain] report: {json.dumps({k: got[k] for k in sorted(got) if isinstance(got[k], (int, float))})}")
    if missing:
        raise AssertionError(f"the chain's report lacks {missing}")
    if _sha256(kept) != sha:
        raise AssertionError("evidence/relay/stitched.npz changed")
    log(f"[chain] evidence/relay/stitched.npz unchanged (sha256 {sha[:16]})")


def _psnr_png_bound(pred01, tgt01):
    """Per image, the most the PSNR can move when both images are written
    as 8-bit PNGs (each value truncated by less than d = 1/255): the RMS
    error moves by at most d, so the PSNR by at most
    20 log10(r / (r - d)) (r the RMS error, r > d)."""
    import numpy as np

    d = 1.0 / 255.0
    r = np.sqrt(((pred01 - tgt01) ** 2).reshape(len(pred01), -1).mean(1))
    return 20.0 * np.log10(r / np.maximum(r - d, 1e-12)), r > d


def phase_eval(report, n_pairs=16, batch=8, consistency_items=8, seed=0):
    """The paper's evaluation protocol on the trained checkpoint
    (evidence/relay/stitched.npz, W=128): `eval_quality` on `n_pairs`
    held-out pairs in batches of `batch`, `eval_consistency` and
    `write_fixtures` on the first `consistency_items`, then
    `calc_errors_quality` (PercSim VGG16 and the InceptionV3 FID features)
    and `calc_errors_consistency` (the fixtures' masks and points), and
    LPIPS over the same pairs, every network on the card with seeded random
    weights: the printed PercSim, LPIPS and FID are smoke numbers, not the
    paper's.  K1 and K2 must launch on the path and no plain version run.
    Checks: every metric finite; calc_errors' PSNR (read from the PNGs)
    within the 8-bit bound of the in-memory views' PSNR; PercSim, LPIPS and
    the Inception features on the card within 1e-4 (relative) of the same
    modules on the CPU.  Output under build/eval/."""
    import shutil

    import numpy as np
    import torch
    from pixelsynth_tpu_torch.data.panorama import pair_items, val_pairs
    from pixelsynth_tpu_torch.eval import harness
    from pixelsynth_tpu_torch.eval.calc_errors import calc_errors_quality, load01
    from pixelsynth_tpu_torch.eval.calc_errors_consistency import calc_errors_consistency
    from pixelsynth_tpu_torch.eval.consistency_fixtures import write_fixtures
    from pixelsynth_tpu_torch.eval.inception import make_fid_feature_fn
    from pixelsynth_tpu_torch.eval.metrics import LPIPS, PercSim, psnr_clamped
    from pixelsynth_tpu_torch.pipeline import PixelSynth

    ps = PixelSynth.from_stitched(os.path.join(REPO, "evidence/relay/stitched.npz"),
                                  device=DEVICE)
    out = os.path.join(REPO, "build", "eval")
    shutil.rmtree(out, ignore_errors=True)
    quality, consistency = os.path.join(out, "quality"), os.path.join(out, "consistency")
    fixtures = os.path.join(out, "fixtures")
    items = pair_items(val_pairs(ps.W, n_pairs), direction_seed=9)
    kw = dict(num_samples=ps.cfg.sample.num_samples, temperature=0.5,
              batch_size=batch, seed=seed)
    seen = {}                      # what eval_quality hands to save_png
    save_png = harness.save_png
    harness.save_png = lambda path, img: seen.__setitem__(path, np.asarray(img)) or \
        save_png(path, img)
    torch.cuda.synchronize()
    zero_launches()
    try:
        t0 = time.perf_counter()
        harness.eval_quality(ps, items, quality, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        harness.eval_consistency(ps, items[:consistency_items], consistency, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        harness.save_png = save_png
    write_fixtures(ps, items[:consistency_items], fixtures)
    t3 = time.perf_counter()
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    percsim = PercSim("vgg16", device=DEVICE, gen=gens[0])
    lpips = LPIPS(device=DEVICE, gen=gens[1])
    fid_fn = make_fid_feature_fn(device=DEVICE, gen=gens[2], batch=batch)
    q = calc_errors_quality(quality, percsim=percsim, feature_fn=fid_fn, batch=batch,
                            device=DEVICE)
    directions = np.array([it["direction"] for it in items])
    c = calc_errors_consistency(
        consistency, directions, masks_dir=os.path.join(fixtures, "consistency_masks"),
        points_dir=os.path.join(fixtures, "consistency_reference_points"),
        percsim=percsim, device=DEVICE)
    names = sorted(os.listdir(os.path.join(quality, "pred")))
    pred = np.stack([load01(os.path.join(quality, "pred", n)) for n in names])
    tgt = np.stack([load01(os.path.join(quality, "tgt", n)) for n in names])
    lp = np.concatenate([lpips(pred[i:i + batch], tgt[i:i + batch])
                         for i in range(0, len(names), batch)])
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = read_launches()
    check_no_plain("the eval path")
    record_launches(report, launches, ("lmconv_up", "lmconv_down", "splat_blend"), "eval")
    log(f"[eval] {n_pairs} pairs (batch {batch}, {kw['num_samples']} samples, T 0.5) in "
        f"{t1 - t0:.2f} s = {(t1 - t0) / n_pairs:.3f} s an item; {consistency_items} "
        f"consistency items in {t2 - t1:.2f} s = {(t2 - t1) / consistency_items:.3f} s an "
        f"item; fixtures {t3 - t2:.2f} s; metrics {t4 - t3:.2f} s; on {card_line()}; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    metrics = {**q, **c, "LPIPS": float(lp.mean())}
    log("[eval] metrics (random-weight PercSim / LPIPS / FID networks: smoke numbers, "
        "not the paper's) " + json.dumps(metrics))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or len(names) != n_pairs:
        raise AssertionError(f"eval metrics not finite: {bad} ({len(names)} pairs)")

    # calc_errors' PSNR on the PNGs against the in-memory views' PSNR
    def to01(img):   # save_png's rule: below -0.01 means [-1, 1]
        return np.clip(img * 0.5 + 0.5 if img.min() < -0.01 else img, 0, 1)

    mem_pred = np.stack([to01(seen[os.path.join(quality, "pred", n)]) for n in names])
    mem_tgt = np.stack([to01(seen[os.path.join(quality, "tgt", n)]) for n in names])
    mem_psnr = psnr_clamped(mem_pred, mem_tgt).numpy()
    bound, valid = _psnr_png_bound(mem_pred, mem_tgt)
    gap = abs(q["PSNR"] - float(mem_psnr.mean()))
    log(f"[eval] PSNR from the PNGs {q['PSNR']:.4f} dB, in memory "
        f"{float(mem_psnr.mean()):.4f} dB: gap {gap:.4f} dB, 8-bit bound "
        f"{float(bound.mean()):.4f} dB")
    if not valid.all() or gap > float(bound.mean()):
        raise AssertionError("calc_errors' PSNR is outside the 8-bit bound of the views'")

    # the eval nets on the card against the same modules on the CPU
    cpu = [PercSim("vgg16", device="cpu", gen=torch.Generator().manual_seed(1)),
           LPIPS(device="cpu", gen=torch.Generator().manual_seed(2)),
           make_fid_feature_fn(device="cpu", gen=torch.Generator().manual_seed(3),
                               batch=batch)]
    a, b = pred[:batch], tgt[:batch]
    for name, on_card, on_cpu in (("PercSim", percsim(a, b), cpu[0](a, b)),
                                  ("LPIPS", lpips(a, b), cpu[1](a, b)),
                                  ("Inception", fid_fn(a), cpu[2](a))):
        err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
        log(f"[eval] {name} on the card against the CPU: max err {err:.2e} of its scale")
        if not err <= 1e-4:
            raise AssertionError(f"{name} on the card differs from the CPU by {err:.2e}")
    times = {"PercSim": time_ms(lambda: percsim(a, b), warmup=1, reps=3, rounds=3),
             "LPIPS": time_ms(lambda: lpips(a, b), warmup=1, reps=3, rounds=3),
             "Inception": time_ms(lambda: fid_fn(a), warmup=1, reps=3, rounds=3)}
    log(f"[eval] eval nets, ms a batch of {batch} at W={ps.W} (fp32, TF32 off): "
        + json.dumps({k: round(v, 3) for k, v in times.items()}) + f" on {card_line()}")


def _max_err(a, b):
    return max(float((x.float().cpu() - y.float().cpu()).abs().max()) for x, y in zip(a, b))


def phase_angle(report, n_frames=8):
    """forward_angle and the encoder composition on the card.
      * K2 at C = 9, 24, 64 and 72 (two blocks of channels), and at 64
        and 72 with tiles of 8 and 32, against its plain version
        (`k2_wide_check`), one backward at C = 64 (`k2_wide_backward`);
      * `forward_angle` on the trained checkpoint (stitched.npz, W=128,
        RGB) over nerf_like_circle(n_frames): ms a view on the second call,
        exactly one K2 launch a view and no plain version, views finite in
        [-1, 1], the card's views against the port's own CPU run (the
        decoder's noise from one CPU generator on both);
      * the encoder composition at the Config() widths (W=256, ngf 64,
        use_rgb_features=False, predict_residual=False, seeded random
        weights, a projector on 64 + 1 channels): `forward_angle` and
        `render_no_outpaint` over the same views, then one view with
        sort_backend="pallas" (K5 feeding the 64-wide K2);
      * card against CPU on the same seeded modules: depth_warp_forward at
        W=256, ViewAppearanceFlow and Tatarchenko at W=256 (batch 2,
        eval), the two-level VQVAE's encode and decode_code at W=256.
    K2's and K5's launches from the forward_angle / render runs are
    recorded under the path "angle"."""
    import copy

    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.models.baselines import Tatarchenko, ViewAppearanceFlow
    from pixelsynth_tpu_torch.models.depth_model import depth_warp_forward
    from pixelsynth_tpu_torch.models.vqvae import VQVAE
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.utils.camera_paths import nerf_like_circle

    t_phase = time.perf_counter()
    for C in (9, 24, 72):
        k2_wide_check(C)
    for tile in (8, 32):
        for C in (64, 72):
            k2_wide_check(C, tile=tile)
    wide = k2_wide_check(64, timed=True)
    bwd_ms = k2_wide_backward(64)
    RTs = nerf_like_circle(n_frames)
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def timed_views(tag, fn, n_k2):
        fn()                                           # warm-up
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        views = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(views)
        launches = read_launches()
        check_no_plain(tag)
        add(launches)
        ran = {k: v for k, v in launches.items() if v}
        log(f"[angle] {tag}: {len(views)} views, {ms:.2f} ms a view (second call, host "
            f"clock around a synchronised call) on {card_line()}; launches {json.dumps(ran)}")
        if ran != {"splat_blend": n_k2}:
            raise AssertionError(f"{tag}: launches {json.dumps(ran)}, expected "
                                 f"{n_k2} K2 launches and nothing else")
        for v in views:
            if not (bool(torch.isfinite(v).all()) and float(v.abs().max()) <= 1.0):
                raise AssertionError(f"{tag}: a view is not finite in [-1, 1]")
        return views, ms

    # the trained checkpoint, RGB features
    path = os.path.join(REPO, "evidence/relay/stitched.npz")
    ps = PixelSynth.from_stitched(path, device=DEVICE)
    W = ps.W
    img, cams = _view_inputs(W)
    x = torch.as_tensor(img, device=DEVICE)
    K = torch.as_tensor(cams["K"], device=DEVICE)
    Kinv = torch.as_tensor(cams["Kinv"], device=DEVICE)
    angle = lambda m, xx, KK, KKi, **kw: m.forward_angle(  # noqa: E731
        xx, KK, KKi, RTs, gen=torch.Generator().manual_seed(2), **kw)
    views, ckpt_ms = timed_views("forward_angle on stitched.npz",
                                 lambda: angle(ps, x, K, Kinv), n_frames)
    _, depth = angle(ps, x, K, Kinv, return_depth=True)
    cpu = PixelSynth.from_stitched(path, device="cpu")
    cpu_views, cpu_depth = angle(cpu, x.cpu(), K.cpu(), Kinv.cpu(), return_depth=True)
    # a point that moves by an ulp of the depth can cross the splat radius
    # or swap z order with a neighbour (ROADMAP Queue 3: the walk's float
    # sensitivity), so single pixels may move by more: the check is on the
    # depth, the mean error and the share of values off by more than 1e-3
    d = torch.stack([(a.cpu() - b).abs() for a, b in zip(views, cpu_views)])
    derr = _max_err([depth], [cpu_depth])
    mean, off = float(d.mean()), float((d > 1e-3).float().mean())
    log(f"[angle] forward_angle on stitched.npz, card against CPU: depth max err "
        f"{derr:.2e}; views max err {float(d.max()):.2e}, mean {mean:.2e}, share of "
        f"values off by more than 1e-3: {off:.2e} (tolerances: depth 1e-4 of its "
        "scale, mean 1e-5, share 1e-3; fp32, TF32 off, sums in other orders)")
    if not (derr <= 1e-4 * float(cpu_depth.abs().max()) and mean <= 1e-5 and off <= 1e-3):
        raise AssertionError("forward_angle on the card differs from the CPU run")
    del ps, cpu

    # the encoder composition at the Config() widths
    cfg = Config()
    cfg.model.use_rgb_features = False
    cfg.model.predict_residual = False
    pe = PixelSynth(cfg, device=DEVICE, seed=0)
    if pe.projector.in_channels != 65:
        raise AssertionError(f"the projector reads {pe.projector.in_channels} channels")
    W = cfg.model.W
    img, cams = _view_inputs(W)
    x = torch.as_tensor(img, device=DEVICE)
    eye = torch.eye(4, device=DEVICE)[None]
    enc_views, enc_ms = timed_views(
        "forward_angle, encoder (64-wide features)",
        lambda: pe.forward_angle(x, eye, eye, RTs, gen=torch.Generator().manual_seed(3)),
        n_frames)
    rcams = [{"K": eye, "Kinv": eye, "P_in": eye, "Pinv_in": eye,
              "P_out": torch.as_tensor(RT, device=DEVICE)[None]} for RT in RTs]
    render = lambda: [pe.render_no_outpaint(  # noqa: E731
        x, c, gen=torch.Generator().manual_seed(4))["PredImg"] for c in rcams]
    _, render_ms = timed_views("render_no_outpaint, encoder", render, n_frames)
    fs = pe.render_no_outpaint(x, rcams[0], gen=torch.Generator().manual_seed(4))
    if tuple(fs["FeaturesImg"].shape) != (1, W, W, 64):
        raise AssertionError(f"the splatted features are {tuple(fs['FeaturesImg'].shape)}")
    pe.cfg.model.splat.sort_backend = "pallas"
    torch.cuda.synchronize()
    zero_launches()
    pallas = pe.render_no_outpaint(x, rcams[1], gen=torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    launches = read_launches()
    check_no_plain("render_no_outpaint with sort_backend=pallas")
    pe.cfg.model.splat.sort_backend = "xla"
    ran = {k: v for k, v in launches.items() if v}
    log(f"[angle] one encoder view with sort_backend=\"pallas\": launches {json.dumps(ran)}")
    if ran != {"splat_blend": 1, "sort_kv": 1}:
        raise AssertionError("expected one K5 and one K2 launch for the pallas-sorted view")
    if not bool(torch.isfinite(pallas["PredImg"]).all()):
        raise AssertionError("the pallas-sorted encoder view is not finite")
    add(launches)
    record_launches(report, totals, ("splat_blend", "sort_kv"), "angle")
    n64 = 2 * n_frames + 1
    report["splat_blend_c64"] = _entry(
        "splat_blend_c64", "splat_blend.cu", "pixelsynth_tpu/ops/splat_pallas.py:40",
        wide["err"], wide["ms"], wide["plain_ms"], wide["t_ops"], wide["t_bytes"])
    report["splat_blend_c64"]["launches_by_path"] = {"angle": n64}
    report["splat_blend_c64"]["launches"] = n64

    # card against CPU on the same seeded modules
    pc = PixelSynth(cfg, device="cpu", seed=0)
    batch = {"input_img": x, "K": eye, "Kinv": eye, "Pinv_in": eye, "P_out": rcams[1]["P_out"]}
    warp = depth_warp_forward(pe, batch)
    warp_cpu = depth_warp_forward(pc, {k: v.cpu() for k, v in batch.items()})
    same = float((warp["PredImg"].cpu() == warp_cpu["PredImg"]).all(-1).float().mean())
    derr = _max_err([warp["PredDepth"]], [warp_cpu["PredDepth"]])
    log(f"[angle] depth_warp_forward W={W}: card against CPU, depth max err {derr:.2e}, "
        f"pixels equal {same:.5f}, visible {float(warp['VisMask'].float().mean()):.3f}")
    if not (derr <= 1e-4 and same >= 0.999):
        raise AssertionError("depth_warp_forward on the card differs from the CPU run")
    del pe, pc
    img2 = np.concatenate([_view_inputs(W, s)[0] for s in (5, 6)])
    RT2 = torch.as_tensor(RTs[1])[None].expand(2, 4, 4)
    eye2 = torch.eye(4)[None].expand(2, 4, 4)
    for cls in (ViewAppearanceFlow, Tatarchenko):
        m = cls()
        m.reset(torch.Generator().manual_seed(6))
        m.eval()
        mc = copy.deepcopy(m).to(DEVICE)
        args = (torch.as_tensor(img2), eye2, RT2)
        with torch.no_grad():
            want = m(*args)
            got = mc(*(a.to(DEVICE) for a in args))
            ms = time_ms(lambda: mc(*(a.to(DEVICE) for a in args)), warmup=1, reps=3,
                         rounds=3)
        err = _max_err([got], [want])
        log(f"[angle] {cls.__name__} W={W} batch 2, eval: card against CPU max err "
            f"{err:.2e} (tolerance 1e-3), output std {float(want.std()):.3f}; {ms:.3f} ms "
            f"a call on {card_line()}")
        if not (err <= 1e-3 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{cls.__name__} on the card differs from the CPU run")
    vq = VQVAE()
    vq.reset(torch.Generator().manual_seed(7))
    vq.eval()
    vqc = copy.deepcopy(vq).to(DEVICE)
    xin = torch.as_tensor(img2)
    with torch.no_grad():
        ids = vq.encode(xin)
        ids_c = vqc.encode(xin.to(DEVICE))
        dec = vq.decode_code(*ids)
        dec_c = vqc.decode_code(*(i.to(DEVICE) for i in ids))
    same = [float((a.cpu() == b).float().mean()) for a, b in zip(ids_c, ids)]
    err = _max_err([dec_c], [dec])
    log(f"[angle] VQVAE (two-level) W={W}: ids equal card/CPU {same[0]:.4f} (top "
        f"{tuple(ids[0].shape)}), {same[1]:.4f} (bottom {tuple(ids[1].shape)}); "
        f"decode_code max err {err:.2e} of scale {float(dec.abs().max()):.3f}")
    if not (min(same) >= 0.99 and err <= 1e-4 * max(1.0, float(dec.abs().max()))):
        raise AssertionError("the two-level VQ-VAE on the card differs from the CPU run")
    log(f"[angle] K2 C=64: {wide['ms']:.4f} ms a call, device {wide['device_us']:.1f} us, "
        f"bound {max(wide['t_ops'], wide['t_bytes']):.4f} ms, backward {bwd_ms:.2f} ms; "
        f"forward_angle {ckpt_ms:.2f} ms a view (stitched.npz, W=128), {enc_ms:.2f} ms a "
        f"view (encoder, W=256); render_no_outpaint {render_ms:.2f} ms a view; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_card_vs_cpu(steps=3):
    """Each trainer the relay chain runs (stage 1, stage 2 G+D, stage 3, the
    scene classifier) stepped `steps` times in float64 on the card beside
    the CPU from one seeded state, on the same batches and NoiseBN rows
    (train/card_vs_cpu.py `compare_trainer`, its plain K2 on both sides),
    each step from the CPU's carried state: after every step each
    gradient, parameter, Adam moment and step, and each buffer held to
    1e-9 of the leaf's largest value (a parameter whose gradient is
    float64 rounding alone to 1e-9 of its tree's largest; the record names
    it).  The worst leaf of each tree is logged; then, logged and not
    held, the same steps with each device carrying its own state (Adam's
    division compounds the rounding).  The records go to
    build/card_vs_cpu/<trainer>[_own].json."""
    import torch
    from pixelsynth_tpu_torch.train.card_vs_cpu import BOUND, TRAINERS, compare_trainer

    out_dir = os.path.join(REPO, "build", "card_vs_cpu")
    os.makedirs(out_dir, exist_ok=True)

    def worst_of(got):
        return max(((w[0], kind, tree, w[1], w[2]) for kind, trees in got["worst"].items()
                    for tree, w in trees.items()), default=(0.0, "", "", "", 0))

    failed = []
    for name in TRAINERS:
        t0 = time.perf_counter()
        got = compare_trainer(name, (DEVICE, "cpu"), steps=steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(got, f, indent=1)
        w = worst_of(got)
        log(f"[card_vs_cpu] {name}: {steps} float64 steps in {secs:.1f} s on "
            f"{card_line()}; worst leaf {w[0]:.3e} ({w[1]} {w[2]}.{w[3]}, step {w[4]}), "
            f"bound {BOUND:g}: {'holds' if got['ok'] else 'MISSES'}")
        for tree in got["worst"]["grads"]:
            log(f"[card_vs_cpu] {name} {tree}: " + ", ".join(
                f"{kind} {trees[tree][0]:.2e} ({trees[tree][1]})"
                for kind, trees in got["worst"].items() if tree in trees))
        rounding = got["steps"][-1]["rounding"].get("grads")
        if rounding:
            log(f"[card_vs_cpu] {name} gradients held as rounding alone: "
                f"{json.dumps(rounding)}")
        log(f"[card_vs_cpu] {name} metrics' relative differences, last step: "
            f"{json.dumps(got['steps'][-1]['metrics'])}")
        if not got["ok"]:
            failed.append(name)
        own = compare_trainer(name, (DEVICE, "cpu"), steps=steps, resync=False)
        with open(os.path.join(out_dir, f"{name}_own.json"), "w") as f:
            json.dump(own, f, indent=1)
        w = worst_of(own)
        log(f"[card_vs_cpu] {name}, each device carrying its own state (not held): "
            f"worst leaf by step " + ", ".join(
                f"{max(x[0] for trees in r['worst'].values() for x in trees.values()):.2e}"
                for r in own["steps"]) + f"; overall {w[1]} {w[2]}.{w[3]}")
    if failed:
        raise AssertionError(f"the card's float64 steps differ from the CPU's: {failed}")


def _train_cfg(batch=None):
    """The trainer at the Config() widths (W=256, 32x32 codes, nr_filters
    80, nr_resnet 2, ngf/ndf 64, VQ channel 128, losses 1.0_l1 +
    10.0_content with a random-init VGG19), TrainConfig's batch (12),
    every masked conv of the PixelCNN through K3 (train_backend "pallas")."""
    from pixelsynth_tpu_torch.config import Config

    cfg = Config()
    cfg.dataset = "synthetic"
    cfg.model.lmconv.train_backend = "pallas"
    if batch is not None:
        cfg.train.batch_size = batch
    return cfg


def _n_k3_convs(ps):
    from pixelsynth_tpu_torch.models.lmconv import LMConv

    return sum(isinstance(m, LMConv) for m in ps.pixelcnn.modules())


def _steps_timed(step, batches):
    """Run step(*b) for each b, each timed to its synchronise, from zeroed
    counts and peak memory.  -> (per-step seconds, per-step metrics,
    launches, peak bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    secs, metrics = [], []
    for b in batches:
        t0 = time.perf_counter()
        m = step(*b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return secs, metrics, read_launches(), torch.cuda.max_memory_allocated()


def _fits(run, B, tag):
    """run(B) at batch B, halved while it does not fit the card."""
    import torch

    while True:
        try:
            return run(B), B
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
        # out of the except block, so the failed run's tensors are free
        log(f"[{tag}] batch {B} does not fit the card's memory: halving it")
        torch.cuda.empty_cache()
        B //= 2


def _train_steps(cfg, steps):
    """`steps` G+D steps of a seeded trainer on synthetic batches, each timed
    to its synchronise; the counts zeroed just before and read just
    after.  -> (ps, per-step seconds, per-step losses, launches, peak
    bytes, parameters / statistics before)."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.train.dpr import create_dpr_state, make_dpr_train_step

    ps = PixelSynth(cfg, device=DEVICE, seed=0, trainable=True)
    step = make_dpr_train_step(ps, create_dpr_state(ps))
    rng = np.random.default_rng(0)
    B, W = cfg.train.batch_size, cfg.model.W
    batches = [ps.batch_to_device(synthetic_pair_batch(rng, B, W)) for _ in range(steps)]
    before = {t: {k: v.clone() for k, v in getattr(ps, t).state_dict().items()}
              for t in ("unet", "projector", "pixelcnn", "disc")}
    gen = torch.Generator(DEVICE).manual_seed(1)
    return (ps,) + _steps_timed(step, [(b, gen) for b in batches]) + (before,)


def phase_train(report, steps=6):
    """The stage-2 trainer (train/dpr.py through pipeline.train_forward) at
    full width: `steps` G+D steps from the seeded initialiser.  Each G step
    launches K2 once (the splat under a gradient) and K3 once per masked
    conv of the PixelCNN (its backward is plain); no plain version runs.
    Losses finite; parameters, batch statistics and spectral vectors of
    the trained trees move.  Batch 12, halved where it does not fit."""
    import numpy as np
    import torch

    def run(B):
        cfg = _train_cfg(B)
        return (cfg,) + _train_steps(cfg, steps)

    (cfg, ps, secs, losses, launches, peak, before), B = _fits(
        run, _train_cfg().train.batch_size, "train")
    check_no_plain("the train steps")
    n_k3 = _n_k3_convs(ps)
    k3 = launches["masked_conv"] + launches["masked_conv_streamed"]
    log(f"[train] W={cfg.model.W} batch {B} codes {cfg.model.lmconv.obs[1:]} "
        f"F={cfg.model.lmconv.nr_filters} ngf={cfg.model.ngf} ndf={cfg.model.ndf} "
        f"train_backend={cfg.model.lmconv.train_backend} on {card_line()}")
    log(f"[train] ms per step (steps 2-{steps}): {1e3 * float(np.mean(secs[1:])):.1f} "
        f"(each {json.dumps([round(1e3 * t, 1) for t in secs])}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    for i, m in enumerate(losses):
        log(f"[train] step {i} " + json.dumps({k: round(v, 5) for k, v in m.items()}))
    log(f"[train] launches in {steps} steps: {json.dumps({k: v for k, v in launches.items() if v})}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError("a train step gave a loss that is not finite")
    if launches["splat_blend"] != steps:
        raise AssertionError(f"K2 launched {launches['splat_blend']} times in "
                             f"{steps} G steps, not once a step")
    if k3 != steps * n_k3:
        raise AssertionError(f"K3 launched {k3} times in {steps} steps, not the "
                             f"{n_k3} masked convs of the PixelCNN a step")
    for t, sd in before.items():
        now = getattr(ps, t).state_dict()
        params = [k for k, _ in getattr(ps, t).named_parameters()]
        stats = [k for k in now if k.split(".")[-1] in ("mean", "var")]
        us = [k for k in now if k.split(".")[-1] in ("u", "u_gain", "u_bias")]
        for kind, keys in (("parameters", params), ("batch statistics", stats),
                           ("spectral u", us)):
            if keys and not any(not torch.equal(now[k], sd[k]) for k in keys):
                raise AssertionError(f"{t}: no {kind} changed in {steps} steps")
        log(f"[train] {t}: changed {sum(not torch.equal(now[k], sd[k]) for k in params)}"
            f"/{len(params)} parameters, {sum(not torch.equal(now[k], sd[k]) for k in stats)}"
            f"/{len(stats)} batch statistics, "
            f"{sum(not torch.equal(now[k], sd[k]) for k in us)}/{len(us)} spectral u")
    record_launches(report, launches, ("splat_blend", "masked_conv", "custom_order"),
                    "the train steps")
    del ps
    torch.cuda.empty_cache()
    return B


class plain_kernels:
    """K2's launcher and K3's kernel wrapper swapped for their plain
    versions inside the block (on CUDA tensors): the check of the
    kernels against their plain versions inside a train step.  The
    package has no such switch; this rebinds module attributes and puts
    them back."""

    def __enter__(self):
        from pixelsynth_tpu_torch.ops import masked_conv_kernel as k3, splat as k2

        self.saved = (k2.blend_slots_kernel, k3.locally_masked_conv2d_kernel)
        k2.blend_slots_kernel = k2.blend_slots_plain
        k3.locally_masked_conv2d_kernel = k3.locally_masked_conv2d_plain
        return self

    def __exit__(self, *exc):
        from pixelsynth_tpu_torch.ops import masked_conv_kernel as k3, splat as k2

        k2.blend_slots_kernel, k3.locally_masked_conv2d_kernel = self.saved
        return False


def phase_train_kernels(B):
    """One G step's K2 and K3 work at noise_scale 0 from the same state,
    with the kernels and with their plain versions (`plain_kernels`):
    K2's forward on the step's splat inputs to <= 1e-5 and the splat's
    input gradients (the same recomputed backward) to <= 1e-5 x max|g|;
    the PixelCNN's AR loss on the step's codes and masks and each of its
    gradient leaves (K3 bf16 against its plain bf16 version) to <= 2e-2 of
    the leaf's max|g|.  The plain run launches neither kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
    from pixelsynth_tpu_torch.ops import splat as K2
    from pixelsynth_tpu_torch.pipeline import PixelSynth, softmax_xent

    cfg = _train_cfg(B)
    W = cfg.model.W
    ps = PixelSynth(cfg, device=DEVICE, seed=0, trainable=True)
    b = ps.batch_to_device(synthetic_pair_batch(np.random.default_rng(0), B, W))
    with torch.no_grad():
        depth = ps.regress_depth(b["input_img"])
        cloud = lift_to_cloud(depth, b["K"], b["Kinv"], b["Pinv_in"], b["P_out"], W)
        pts, valid = homogeneous_to_pixels(cloud, W)
        feats = b["input_img"].reshape(B, -1, 3)
        codes = ps.vq_encode(b["output_img"])
        _, masks, _ = ps.masks_for_background(K2.splat(pts, feats, valid, W=W,
                                                       cfg=cfg.model.splat)[1])
    cot = torch.randn((B, W, W, 3), generator=torch.Generator(DEVICE).manual_seed(2),
                      device=DEVICE)
    oh = F.one_hot(codes, cfg.model.lmconv.num_classes).float()
    named = list(ps.pixelcnn.named_parameters())

    def run():
        p = pts.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        out, _ = K2.splat(p, f, valid, W=W, cfg=cfg.model.splat)
        gp, gf = torch.autograd.grad(out, (p, f), cot)
        loss = softmax_xent(ps.pixelcnn_logits(oh, masks, train=True), codes)
        grads = torch.autograd.grad(loss, [q for _, q in named])
        torch.cuda.synchronize()
        return out.detach(), gp, gf, float(loss), grads

    zero_launches()
    got = run()
    launches = read_launches()
    check_no_plain("the kernel side of the train check")
    with plain_kernels():
        zero_launches()
        want = run()
        plain_launches = read_launches()
    if launches["splat_blend"] != 1 or launches["masked_conv"] != _n_k3_convs(ps):
        raise AssertionError(f"kernel side launches {json.dumps(launches)}")
    if any(plain_launches.values()):
        raise AssertionError(f"the plain side launched kernels: {json.dumps(plain_launches)}")
    # K2 under a gradient at this step's shapes: the kernel's forward and the
    # recomputed backward (one group of tile_group tiles at a time)
    idx, svld = K2._bin_dispatch(pts, valid, W, cfg.model.splat)
    fwd_ms = time_ms(lambda: K2.blend_slots_kernel(pts, feats, idx, svld, W,
                                                   cfg.model.splat), reps=5, rounds=3)
    bwd_ms = time_ms(lambda: K2.blend_slots_vjp(cot, pts, feats, idx, svld, W,
                                                cfg.model.splat), warmup=1, reps=2, rounds=3)
    log(f"[train-check] K2 under a gradient, batch {B} x {pts.shape[1]} points, "
        f"W={W}: forward {fwd_ms:.4f} ms (the kernel), recomputed backward "
        f"{bwd_ms:.2f} ms ({-(-idx.shape[0] * idx.shape[1] // cfg.model.splat.tile_group)}"
        f" groups of {cfg.model.splat.tile_group} tiles) on {card_line()}")
    fwd = float((got[0] - want[0]).abs().max())
    gp_err = float((got[1] - want[1]).abs().max() / want[1].abs().max())
    gf_err = float((got[2] - want[2]).abs().max() / want[2].abs().max())
    loss_err = abs(got[3] - want[3]) / abs(want[3])
    leaf_err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                   for g, w in zip(got[4], want[4]))
    log(f"[train-check] batch {B} W={W}: K2 forward max |kernel - plain| {fwd:.3e}; "
        f"splat input gradients {gp_err:.3e} (points), {gf_err:.3e} (feats) of max|g|; "
        f"K3 AR loss {got[3]:.6f} vs plain {want[3]:.6f} ({loss_err:.3e} relative), "
        f"worst gradient leaf {leaf_err:.3e} of its max|g|")
    if not (fwd <= 1e-5 and gp_err <= 1e-5 and gf_err <= 1e-5 and loss_err <= 2e-2
            and leaf_err <= 2e-2):
        raise AssertionError("the train step's kernels disagree with their plain versions")
    del ps
    torch.cuda.empty_cache()


def phase_train_overfit(steps=300):
    """The committed evidence protocol (tools/training_evidence.py: W=64,
    batch 8, 48 fixed synthetic items, seed 0; JAX's evidence/dpr.jsonl
    goes 7.37 -> 0.975 in total loss by step 300) for `steps` steps: the
    total loss at the last step is at most a quarter of step 0's, and L1
    falls.  The curve goes under build/train_evidence/."""
    from pixelsynth_tpu_torch.tools.training_evidence import evidence_dpr

    out_dir = os.path.join(REPO, "build", "train_evidence")
    t0 = time.perf_counter()
    zero_launches()
    res = evidence_dpr(out_dir, steps=steps, log_every=100, device=DEVICE,
                       log_fn=lambda s: log(f"[overfit] {s}"))
    launches = read_launches()
    check_no_plain("the overfit run")
    with open(os.path.join(out_dir, "dpr.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    first, last = rows[0], rows[-1]
    log(f"[overfit] {steps} steps in {time.perf_counter() - t0:.1f} s on {card_line()}: "
        f"total loss {first['total_loss']:.4f} (step {first['step']}) -> "
        f"{last['total_loss']:.4f} (step {last['step']}), L1 {first['l1']:.4f} -> "
        f"{last['l1']:.4f}, psnr_det {first['psnr_det']:.3f} -> {last['psnr_det']:.3f}, "
        f"psnr_std_det {first['psnr_std_det']:.3f} -> {last['psnr_std_det']:.3f}; "
        f"K2 launches {launches['splat_blend']}")
    if last["step"] != steps - 1 or not last["total_loss"] <= 0.25 * first["total_loss"]:
        raise AssertionError("the overfit did not quarter the total loss")
    if not last["l1"] < first["l1"]:
        raise AssertionError("the overfit did not lower L1")
    if launches["splat_blend"] == 0:
        raise AssertionError("the overfit run did not launch K2")
    return res


def _log_steps(tag, secs, metrics, peak):
    import numpy as np

    log(f"[{tag}] ms per step (steps 2-{len(secs)}): {1e3 * float(np.mean(secs[1:])):.1f} "
        f"(each {json.dumps([round(1e3 * t, 1) for t in secs])}); peak memory "
        f"{peak / 2 ** 30:.2f} GiB on {card_line()}")
    for i, m in enumerate(metrics):
        log(f"[{tag}] step {i} " + json.dumps({k: round(v, 5) for k, v in m.items()}))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{tag}: a step gave a loss that is not finite")


def phase_train_vqvae(steps=6):
    """The stage-1 trainer (train/vqvae.py) at full width: the VQVAEConfig
    defaults (channel 128, 2 res blocks, n_res_channel 32, embed 64, 512
    codes) at W=256, TrainConfig's batch (12, halved where it does not
    fit), `steps` steps from the data-dependent codebook init on
    structured images.  Losses finite; parameters and each codebook's
    embed, cluster_size and embed_avg move.  Then the training loop `run_vqvae`
    at that batch (`_run_loop_twice`).  No kernel is on this path (its
    convolutions are cuDNN's)."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.tools.training_evidence import structured_images
    from pixelsynth_tpu_torch.train.loop import run_vqvae
    from pixelsynth_tpu_torch.train.vqvae import create_vqvae_state, make_vqvae_train_step

    cfg = _stage_cfg()
    W, v = cfg.model.W, cfg.model.vqvae

    def run(B):
        rng = np.random.default_rng(0)
        model = build_vqvae(cfg).to(DEVICE)
        state = create_vqvae_state(model, torch.Generator().manual_seed(0),
                                   init_batch=structured_images(rng, B, W))
        before = {k: t.clone() for k, t in model.state_dict().items()}
        batches = [(torch.as_tensor(structured_images(rng, B, W), device=DEVICE),)
                   for _ in range(steps)]
        out = _steps_timed(make_vqvae_train_step(model, state), batches)
        return model, before, batches, out

    (model, before, batches, (secs, metrics, launches, peak)), B = _fits(
        run, cfg.train.batch_size, "train-vqvae")
    check_no_plain("the stage-1 steps")
    log(f"[train-vqvae] W={W} batch {B} channel {v.channel} n_res_channel "
        f"{v.n_res_channel} embed {v.embed_dim} x {v.n_embed}")
    _log_steps("train-vqvae", secs, metrics, peak)
    now = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    if not any(not torch.equal(now[k], before[k]) for k in params):
        raise AssertionError("stage 1: no parameter changed")
    for q in ("quantize_t", "quantize_b"):
        for leaf in ("embed", "cluster_size", "embed_avg"):
            if torch.equal(now[f"{q}.{leaf}"], before[f"{q}.{leaf}"]):
                raise AssertionError(f"stage 1: {q}.{leaf} did not move")
    with torch.no_grad():
        model.eval()
        ids = model.encode(batches[-1][0])
    log(f"[train-vqvae] {int(torch.unique(ids).numel())} distinct top codes of "
        f"{v.n_embed} in the last batch ({ids.numel()} cells); changed "
        f"{sum(not torch.equal(now[k], before[k]) for k in params)}/{len(params)} "
        f"parameters; kernel launches {json.dumps({k: n for k, n in launches.items() if n})}")
    del model, batches
    torch.cuda.empty_cache()

    cfg.train.batch_size = B
    zero_launches()
    saved = _run_loop_twice("train-vqvae", run_vqvae, cfg, "vqvae", val_iters=1,
                        sample_grid_every=1)
    check_no_plain("run_vqvae")
    for q in ("quantize_t", "quantize_b"):
        if not bool((saved["variables"][f"{q}.cluster_size"] > 0).all()):
            raise AssertionError(f"run_vqvae: {q} saved a cluster size that is not positive")
    _check_png("train-vqvae", os.path.join("vqvae_run", "vqvae_samples"),
               (2 * W, min(8, B) * W, 3))
    torch.cuda.empty_cache()


def _run_loop_twice(tag, run, cfg, name, **kw):
    """A stage's training loop (`run_vqvae` / `run_lmconv`) on the card at `cfg`:
    one epoch of 2 iterations into build/<name>_run/ (emptied first),
    then a second call that restores its checkpoint and trains on.  The
    metrics finite, the resume logged, the checkpoint's step 4.  ->
    the checkpoint's state."""
    import shutil

    import numpy as np
    from pixelsynth_tpu_torch.checkpoint import CheckpointManager

    workdir = os.path.join(REPO, "build", f"{name}_run")
    shutil.rmtree(workdir, ignore_errors=True)
    logs = []
    t0 = time.perf_counter()
    for _ in range(2):
        m = run(cfg, workdir, epochs=1, iters_per_epoch=2, device=DEVICE,
                log_fn=logs.append, **kw)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: {run.__name__} gave metrics that are not finite: {m}")
    ckpt = CheckpointManager(os.path.join(workdir, name))
    saved = ckpt.restore()
    log(f"[{tag}] {run.__name__} twice (1 epoch of 2 iterations, then a resume) in "
        f"{time.perf_counter() - t0:.2f} s: " + " | ".join(logs))
    if not any("resumed from epoch 1" in s for s in logs) or saved["step"] != 4:
        raise AssertionError(f"{tag}: {run.__name__} did not resume (checkpoint step "
                             f"{saved['step']})")
    return saved


def _check_png(tag, sub, shape):
    """build/<sub>/epoch_0001.png, a training loop's first epoch's PNG, has `shape`."""
    from pixelsynth_tpu_torch.eval.harness import load_png

    path = os.path.join(REPO, "build", sub, "epoch_0001.png")
    got = load_png(path).shape
    log(f"[{tag}] {path}: {got}")
    if got != shape:
        raise AssertionError(f"{tag}: {path} is {got}, not {shape}")


def _stage_cfg():
    """The Config() defaults, the full width of stages 1 and 3, on the
    synthetic source (the only one ported)."""
    from pixelsynth_tpu_torch.config import Config

    cfg = Config()
    cfg.dataset = "synthetic"
    return cfg


def _lm_setup(B, seed=0):
    """A full-width stage-3 trainer: the LMConvConfig defaults (32x32
    codes, F=80, nr_resnet 2, 512 classes) built by
    `build_pixelcnn(cfg, trainable=True)` with train_backend "pallas" (K3,
    bf16), a mask pool of the 8 variants of the raster, s-curve and
    Hilbert orders (`masks_for_orders_batch`), low-entropy code grids."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.ops.orders import (
        augment_orders, hilbert_order, masks_for_orders_batch, raster_scan_order,
        s_curve_order,
    )
    from pixelsynth_tpu_torch.pipeline import build_pixelcnn
    from pixelsynth_tpu_torch.train.lmconv import create_lmconv_state

    cfg = _stage_cfg()
    cfg.train.batch_size = B
    l = cfg.model.lmconv
    l.train_backend = "pallas"
    rows, cols = l.obs[1], l.obs[2]
    model = build_pixelcnn(cfg, trainable=True)
    state = create_lmconv_state(model, torch.Generator().manual_seed(seed))
    model.to(DEVICE)
    orders = [o for base in (raster_scan_order, s_curve_order, hilbert_order)
              for o in augment_orders(base(rows, cols), rows, cols)]
    a, b, d = masks_for_orders_batch(orders, rows, cols, l.kernel_size, l.max_dilation)
    pool = np.stack([a, b, d], 1)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 16, (64, rows // 4, cols // 4))
    codes = np.kron(base, np.ones((1, 4, 4), np.int64)).astype(np.int64)

    def batch():
        return (torch.as_tensor(codes[rng.integers(len(codes), size=B)], device=DEVICE),
                torch.as_tensor(pool[rng.integers(len(pool), size=B)], device=DEVICE))

    return cfg, model, state, batch, np.stack(orders), codes


def phase_train_lmconv(report, steps=6):
    """The stage-3 trainer (train/lmconv.py) at full width, batch 12
    (halved where it does not fit), every masked conv on K3 (its
    differentiable entry): `steps` steps launch K3 33 times a step (the
    one-hot first layer, Cin 513, on its f32 kernel) and no plain version.
    K3's device time inside a step, its f32 and bf16 kernels apart, from
    the profiler.  Then one step's loss and gradients with the kernels and
    inside `plain_kernels`: the loss within 2e-2 relative, each gradient
    leaf within 2e-2 of its max|g|.  Then `lmconv_sample_preview` at full
    width (4 images, frac 0.6, decoded through a seeded VQ-VAE), which
    launches K1 (sample_backend "fused") and no plain version; its PNG goes
    under build/lmconv_preview/.  Then the training loop `run_lmconv` with
    train_backend "pallas", an EMA and the preview (`_run_loop_twice`): K3 33
    times a step and a val forward, K1 twice a sampled cell."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.models.lmconv import LMConv
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.train.lmconv import lmconv_loss, make_lmconv_train_step
    from pixelsynth_tpu_torch.train.loop import lmconv_sample_preview, run_lmconv

    def run(B):
        cfg, model, state, batch, orders, codes = _lm_setup(B)
        batches = [batch() + (None,) for _ in range(steps)]
        out = _steps_timed(make_lmconv_train_step(model, state), batches)
        return cfg, model, state, batch, orders, codes, out

    (cfg, model, state, batch, orders, codes, (secs, metrics, launches, peak)), B = _fits(
        run, _stage_cfg().train.batch_size, "train-lmconv")
    check_no_plain("the stage-3 steps")
    l = cfg.model.lmconv
    n_k3 = sum(isinstance(m, LMConv) for m in model.modules())
    k3 = launches["masked_conv"] + launches["masked_conv_streamed"]
    log(f"[train-lmconv] codes {l.obs[1]}x{l.obs[2]} F={l.nr_filters} nr_resnet "
        f"{l.nr_resnet} classes {l.num_classes} batch {B} backend pallas ({l.compute_dtype})")
    _log_steps("train-lmconv", secs, metrics, peak)
    log(f"[train-lmconv] launches in {steps} steps: "
        f"{json.dumps({k: n for k, n in launches.items() if n})} ({n_k3} masked convs)")
    if n_k3 != 33 or k3 != steps * n_k3:
        raise AssertionError(f"K3 launched {k3} times in {steps} stage-3 steps, not "
                             f"33 a step ({n_k3} masked convs)")
    record_launches(report, launches, ("masked_conv",), "the stage-3 steps")
    _k3_in_step(make_lmconv_train_step(model, state), [batch() + (None,) for _ in range(3)])

    # one step's work with the kernels and with their plain versions
    codes_b, masks_b = batch()
    params = list(model.parameters())
    model.train()

    def grads():
        loss = lmconv_loss(model, codes_b, masks_b)
        g = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return float(loss.detach()), g

    zero_launches()
    got = grads()
    kernel_launches = read_launches()
    check_no_plain("the kernel side of the stage-3 check")
    with plain_kernels():
        zero_launches()
        want = grads()
        plain_launches = read_launches()
    if kernel_launches["masked_conv"] != n_k3 or any(plain_launches.values()):
        raise AssertionError(f"stage-3 check launches: kernel {json.dumps(kernel_launches)}, "
                             f"plain {json.dumps(plain_launches)}")
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    leaf_err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                   for g, w in zip(got[1], want[1]))
    log(f"[train-lmconv] K3 against plain inside a step: AR loss {got[0]:.9g} vs "
        f"{want[0]:.9g} ({loss_err:.3e} relative), worst gradient leaf {leaf_err:.3e} "
        f"of its max|g|")
    if not (loss_err <= 2e-2 and leaf_err <= 2e-2):
        raise AssertionError("stage 3: K3 disagrees with its plain version inside a step")

    # the preview, K1 serving sample_backend "fused"
    vq = build_vqvae(cfg).to(DEVICE)
    with torch.no_grad():
        vq.reset(torch.Generator().manual_seed(1))
    out = os.path.join(REPO, "build", "lmconv_preview", "preview.png")
    n, frac = 4, 0.6
    t0 = time.perf_counter()
    zero_launches()
    sampled = lmconv_sample_preview(cfg, model.state_dict(), vq, codes[:n], orders[:n], out,
                                    frac=frac, device=DEVICE,
                                    gen=torch.Generator(DEVICE).manual_seed(2))
    torch.cuda.synchronize()
    launches = read_launches()
    check_no_plain("the stage-3 preview")
    rows, cols = l.obs[1], l.obs[2]
    cut = int(frac * rows * cols)
    kept = all(np.array_equal(sampled[i][orders[i, :cut, 0], orders[i, :cut, 1]],
                              codes[i][orders[i, :cut, 0], orders[i, :cut, 1]])
               for i in range(n))
    log(f"[train-lmconv] preview: {n} images, frac {frac}, {rows * cols - cut} cells "
        f"sampled in {time.perf_counter() - t0:.2f} s, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; {out}")
    if not kept or not os.path.exists(out):
        raise AssertionError("the preview changed kept cells or wrote no PNG")
    if launches["lmconv_up"] != rows * cols - cut or launches["lmconv_down"] != launches["lmconv_up"]:
        raise AssertionError("the preview did not run one K1 forward (2 passes) a cell")
    record_launches(report, launches, ("lmconv_up", "lmconv_down"), "the stage-3 preview")
    del model, state
    torch.cuda.empty_cache()

    # the training loop: 2 runs of (2 steps, 1 val forward, the preview)
    cfg.model.lmconv.ema_decay = 0.999
    zero_launches()
    _run_loop_twice("train-lmconv", run_lmconv, cfg, "lmconv", val_iters=1, preview_every=1,
                vq_model=vq)
    torch.cuda.synchronize()
    launches = read_launches()
    check_no_plain("run_lmconv")
    log(f"[train-lmconv] run_lmconv launches {json.dumps({k: v for k, v in launches.items() if v})}")
    want = {"masked_conv": 2 * 3 * n_k3, "lmconv_up": 2 * (rows * cols - cut),
            "lmconv_down": 2 * (rows * cols - cut)}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"run_lmconv: launches {json.dumps(launches)}, expected "
                             f"{json.dumps(want)}")
    _check_png("train-lmconv", os.path.join("lmconv_run", "lmconv_samples"),
               (cfg.model.W, 4 * cfg.model.W, 3))
    record_launches(report, launches, ("masked_conv", "lmconv_up", "lmconv_down"),
                    "run_lmconv (two runs, the second resumed)")
    del vq
    torch.cuda.empty_cache()


def _k3_in_step(step, batches):
    """The device time of `len(batches)` stage-3 steps by the profiler:
    K3's f32 kernel (the one-hot first layer), its bf16 kernels (the other
    32 masked convs), every other kernel, over the steps' wall time; per
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(*b)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(batches)
    parts = {"k3_f32": [0.0, 0], "k3_bf16": [0.0, 0], "other": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        part = ("k3_f32" if "masked_conv_f32_kernel" in e.key else
                "k3_bf16" if "resident_kernel" in e.key or "layer_kernel" in e.key else
                "other")
        parts[part][0] += e.device_time_total / 1e3 / len(batches)
        parts[part][1] += e.count / len(batches)
    busy = sum(ms for ms, _ in parts.values())
    log(f"[train-lmconv] device time a step by the profiler ({len(batches)} steps): "
        + ", ".join(f"{k} {ms:.3f} ms in {n:.1f} kernels" for k, (ms, n) in parts.items())
        + f"; busy {busy:.3f} ms of {1e3 * wall:.3f} ms wall (busy share "
          f"{busy / (1e3 * wall):.3f}) on {card_line()}")
    if parts["k3_f32"][1] == 0 or parts["k3_bf16"][1] == 0:
        raise AssertionError("the profiler saw no K3 kernel in a stage-3 step")


def phase_train_evidence():
    """The evidence curves of stages 1 and 3 (tools/training_evidence.py:
    stage 1 at W=128, batch 8, 1200 steps; stage 3 on codes from that
    model, 300 steps; the JAX tool's protocol), into
    build/train_evidence/, held to the bars of
    tests/test_training_evidence.py:25-41 and printed beside the JAX
    package's committed curves (evidence/vqvae.jsonl, lmconv.jsonl)."""
    from pixelsynth_tpu_torch.tools.training_evidence import (
        evidence_lmconv, evidence_vqvae,
    )

    out_dir = os.path.join(REPO, "build", "train_evidence")
    t0 = time.perf_counter()
    zero_launches()
    vq = evidence_vqvae(out_dir, device=DEVICE, log_fn=lambda s: log(f"[evidence] {s}"))
    evidence_lmconv(out_dir, vq=vq, device=DEVICE, log_fn=lambda s: log(f"[evidence] {s}"))
    check_no_plain("the evidence runs")

    def ends(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        return rows[0], rows[-1], len(rows)

    failed = []
    for name, key in (("vqvae", "mse"), ("lmconv", "bpd")):
        first, last, n = ends(os.path.join(out_dir, f"{name}.jsonl"))
        jfirst, jlast, _ = ends(os.path.join(REPO, "evidence", f"{name}.jsonl"))
        if name == "vqvae":
            bars = {"last mse < first / 5": last["mse"] < first["mse"] / 5,
                    "recon_psnr up > 5 dB": last["recon_psnr"] > first["recon_psnr"] + 5}
            extra = (f", recon_psnr {first['recon_psnr']:.2f} -> {last['recon_psnr']:.2f} dB "
                     f"(JAX {jfirst['recon_psnr']:.2f} -> {jlast['recon_psnr']:.2f})")
        else:
            bars = {"first bpd > 5": first["bpd"] > 5,
                    "last bpd < first / 2": last["bpd"] < first["bpd"] * 0.5}
            extra = ""
        bars["at least 10 rows"] = n >= 10
        log(f"[evidence] {name}: {key} {first[key]:.4f} (step {first['step']}) -> "
            f"{last[key]:.4f} (step {last['step']}) (JAX {jfirst[key]:.4f} -> "
            f"{jlast[key]:.4f}){extra} on {card_line()}")
        for bar, holds in bars.items():
            log(f"[evidence] {name} bar {bar}: {'holds' if holds else 'FAILS'}")
            if not holds:
                failed.append(f"{name}: {bar}")
    log(f"[evidence] stages 1 and 3 in {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"evidence bars missed: {failed}")


def _write_re10k_tree(base, n_videos=10, n_frames=12, step_deg=6.0, hw=(180, 320),
                      seed=0):
    """A synthetic RealEstate10K tree (the layout data/realestate10k.py
    reads): video_loc.txt, per-video metadata and frames of `hw` (smooth
    colour fields plus noise) written as PNG bytes under the dataset's
    <timestamp>.jpg names -- the card's machine has no PIL to write or
    read JPEGs, and the reader goes by content."""
    import numpy as np
    from pixelsynth_tpu_torch.eval.harness import save_png

    rng = np.random.default_rng(seed)
    d = os.path.join(base, "frames", "train")
    os.makedirs(d, exist_ok=True)
    vids = [f"vid{i}" for i in range(n_videos)]
    with open(os.path.join(d, "video_loc.txt"), "w") as f:
        f.write("\n".join(vids) + "\n")
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw[0]), np.linspace(-1, 1, hw[1]),
                         indexing="ij")
    for vi, vid in enumerate(vids):
        rows = []
        os.makedirs(os.path.join(d, vid), exist_ok=True)
        for fi in range(n_frames):
            ts = 1000 * (fi + 1)
            r = np.radians(step_deg * fi)
            R = np.array([[np.cos(r), 0, np.sin(r)], [0, 1, 0], [-np.sin(r), 0, np.cos(r)]])
            ex = np.hstack([R, [[0.01 * fi], [0.0], [0.02 * fi]]]).reshape(-1)
            rows.append(" ".join(f"{v:.9g}" for v in
                                 [ts, 0.9, 1.2, 0.5, 0.5, 0.0, 0.0] + list(ex)))
            ph = 0.3 * vi + 0.1 * fi
            img = np.stack([np.sin(3 * xx + ph), np.cos(2 * yy - ph), xx * yy], -1)
            img = np.clip(0.8 * img + 0.05 * rng.normal(size=img.shape), -1, 1)
            save_png(os.path.join(d, vid, f"{ts}.jpg"), img.astype(np.float32))
        with open(os.path.join(d, f"{vid}.txt"), "w") as f:
            f.write("https://example.com/video\n" + "\n".join(rows) + "\n")
    return base


def phase_datasets(report, steps=3, bridge_steps=2, n_extract=24):
    """The other datasets at the Config() widths (W=256, batch 12,
    train_backend "pallas"), under build/datasets/:
      * a synthetic RealEstate10K tree (frames of 180x320, PNG bytes under
        .jpg names), `steps` stage-2 G+D steps on batches of
        make_batch_source("realestate"), the curriculum's
        set_max_rotation called before them as run_dpr calls it (K2 once
        and K3 33 times a G step, the order kernel once);
      * a VectorGeneratorBridge of 5 PanoramaGenerator workers (W=256)
        feeding `bridge_steps` more steps; its items/s;
      * the extract chain on `n_extract` RealEstate10K images:
        extract_vqvae_dataset -> Custom -> extract_code (VQ-VAE encode,
        cuDNN) -> extract_pixcnn_orders (K2, the order kernel), each
        tool's seconds, the codes in range and every order a permutation
        of the 32x32 grid.
    Each path's launches are zeroed just before it and read just after."""
    import shutil

    import numpy as np
    import torch
    from pixelsynth_tpu_torch.data.custom import Custom
    from pixelsynth_tpu_torch.data.habitat_bridge import PanoramaGenerator, VectorGeneratorBridge
    from pixelsynth_tpu_torch.data.realestate10k import RealEstate10K
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.tools.extract_code import extract_codes
    from pixelsynth_tpu_torch.tools.extract_pixcnn_orders import extract_orders
    from pixelsynth_tpu_torch.tools.extract_vqvae_dataset import extract
    from pixelsynth_tpu_torch.train.dpr import create_dpr_state, make_dpr_train_step
    from pixelsynth_tpu_torch.train.loop import make_batch_source

    root = os.path.join(REPO, "build", "datasets")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = _write_re10k_tree(os.path.join(root, "re10k"))
    log(f"[datasets] RealEstate10K tree: 10 videos x 12 frames of 180x320 in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = _train_cfg()
    cfg.dataset, cfg.train_data_path = "realestate", tree
    B = cfg.train.batch_size
    batch_fn = make_batch_source(cfg, "train")
    tc = cfg.train
    rot = min(tc.max_rotation + tc.curriculum_step, tc.curriculum_max)   # epoch 50
    batch_fn.dataset.set_max_rotation(rot)
    if batch_fn.dataset.max_rotation != rot:
        raise AssertionError("set_max_rotation did not set the sampler's rotation")
    t0 = time.perf_counter()
    batches = [batch_fn() for _ in range(steps)]
    load_s = (time.perf_counter() - t0) / steps
    log(f"[datasets] realestate batch {B} at W={cfg.model.W}: {load_s * 1e3:.1f} ms a "
        f"batch to read and resize (host), rotation {rot}")

    ps = PixelSynth(cfg, device=DEVICE, seed=0, trainable=True)
    step = make_dpr_train_step(ps, create_dpr_state(ps))
    gen = torch.Generator(DEVICE).manual_seed(1)
    n_k3 = _n_k3_convs(ps)
    secs, losses, launches, peak = _steps_timed(step, [(b, gen) for b in batches])
    check_no_plain("the RealEstate10K steps")
    log(f"[datasets] RealEstate10K G+D steps on {card_line()}: ms "
        f"{json.dumps([round(1e3 * t, 1) for t in secs])}; peak {peak / 2 ** 30:.2f} GiB; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError("a RealEstate10K step gave a loss that is not finite")
    k3 = launches["masked_conv"] + launches.get("masked_conv_streamed", 0)
    if launches["splat_blend"] != steps or k3 != steps * n_k3:
        raise AssertionError(f"RealEstate10K steps: K2 {launches['splat_blend']}, K3 {k3} "
                             f"launches in {steps} steps")
    record_launches(report, launches, ("splat_blend", "masked_conv", "custom_order"),
                    "the RealEstate10K steps")

    t0 = time.perf_counter()
    with VectorGeneratorBridge(PanoramaGenerator(W=cfg.model.W, max_rotation=rot),
                               num_workers=5, seed=cfg.train.seed) as bridge:
        first = bridge.batch(B, timeout=300)
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fed = [bridge.batch(B, timeout=300) for _ in range(bridge_steps)]
        rate = bridge_steps * B / (time.perf_counter() - t0)
    log(f"[datasets] bridge of 5 PanoramaGenerator workers at W={cfg.model.W}: first "
        f"batch after {start_s:.1f} s, then {rate:.1f} items/s (host)")
    if first["input_img"].shape != (B, cfg.model.W, cfg.model.W, 3):
        raise AssertionError(f"bridge batch shape {first['input_img'].shape}")
    secs, losses, launches, _ = _steps_timed(step, [(b, gen) for b in fed])
    check_no_plain("the bridge steps")
    log(f"[datasets] bridge G+D steps: ms {json.dumps([round(1e3 * t, 1) for t in secs])}; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError("a bridge step gave a loss that is not finite")
    record_launches(report, launches, ("splat_blend", "masked_conv", "custom_order"),
                    "the bridge steps")
    del ps, step
    torch.cuda.empty_cache()

    folder = os.path.join(root, "extraction")
    cfg.train.batch_size = n_extract // 2
    t0 = time.perf_counter()
    n = extract(cfg, folder, num_train=n_extract - n_extract // 3, num_val=n_extract // 3)
    ext_s = time.perf_counter() - t0
    ds = Custom(folder, W=cfg.model.W)
    W = cfg.model.W
    if n != n_extract or len(ds) != n_extract or ds[0]["input_img"].shape != (W, W, 3):
        raise AssertionError(f"the extraction holds {len(ds)} images, not {n_extract}")
    t0 = time.perf_counter()
    codes = extract_codes(cfg, folder, os.path.join(root, "codes.npy"), batch=12,
                          device=DEVICE)
    torch.cuda.synchronize()
    code_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    orders = extract_orders(folder, os.path.join(root, "orders.npy"), batch=12,
                            device=DEVICE)
    torch.cuda.synchronize()
    order_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_plain("extract_pixcnn_orders")
    log(f"[datasets] extract chain on {n_extract} images: extract_vqvae_dataset "
        f"{ext_s:.2f} s, extract_code {code_s:.2f} s, extract_pixcnn_orders {order_s:.2f} s "
        f"on {card_line()}; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    side = W // 8
    if codes.shape != (n_extract, side, side) or codes.min() < 0 or codes.max() >= 512:
        raise AssertionError(f"codes {codes.shape} [{codes.min()}, {codes.max()}]")
    if orders.shape != (n_extract, side * side, 2) or not (
            np.sort(orders[..., 0] * side + orders[..., 1], 1) == np.arange(side * side)).all():
        raise AssertionError("an extracted order is not a permutation of the code grid")
    record_launches(report, launches, ("splat_blend", "custom_order"),
                    "extract_pixcnn_orders")
    if not isinstance(batch_fn.dataset, RealEstate10K):
        raise AssertionError("make_batch_source('realestate') serves no RealEstate10K")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_parallel(report, B=4, num_samples=16, backend="nccl"):
    """The mesh path on the card: `initialize_multihost` with NCCL at world
    size 1 (tcp://localhost, a free port), then
      * one stage-2 step at the Config() widths (batch B) through the mesh
        (shard_batch, the step inside `with mesh:`: NCCL all-reduces of the
        BatchNorm sums, the gradients and the metrics), held to the same
        step of a trainer from the same seed without a group: every loss
        within 1e-5 relative;
      * a sharded-population view (SceneGenerator(mesh=), K1) held to the
        ungrouped view: every candidate's codes equal, the same best view.
    Two ranks on one card are not run: NCCL refuses two ranks on one
    device; the two-rank path is tests/test_torch_parallel.py's (gloo)."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.parallel.distributed import initialize_multihost, shutdown
    from pixelsynth_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator
    from pixelsynth_tpu_torch.train.dpr import create_dpr_state, make_dpr_train_step

    t0 = time.perf_counter()
    world = initialize_multihost(f"localhost:{_free_port()}", num_processes=1,
                                 process_id=0, backend=backend)
    cfg = _train_cfg(B)
    mesh = make_mesh(cfg.mesh)
    log(f"[parallel] {torch.distributed.get_backend()} group of {world} in "
        f"{time.perf_counter() - t0:.2f} s: {mesh}")
    try:
        batch = synthetic_pair_batch(np.random.default_rng(0), B, cfg.model.W)
        got = {}
        for tag in ("no group", "mesh"):
            ps = PixelSynth(cfg, device=DEVICE, seed=0, trainable=True)
            step = make_dpr_train_step(ps, create_dpr_state(ps))
            gen = torch.Generator(DEVICE).manual_seed(1)
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            if tag == "mesh":
                replicate([getattr(ps, t) for t in ps.trees], mesh)
                with mesh:
                    m = step(shard_batch(batch, mesh), gen)
            else:
                m = step(batch, gen)
            got[tag] = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            log(f"[parallel] stage-2 step ({tag}), batch {B}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
            if tag == "mesh":
                check_no_plain("the mesh step")
                record_launches(report, read_launches(), ("splat_blend", "masked_conv",
                                                          "custom_order"), "the mesh step")
            del ps, step
            torch.cuda.empty_cache()
        errs = {k: abs(got["mesh"][k] - w) / max(abs(w), 1e-30)
                for k, w in got["no group"].items()}
        log(f"[parallel] mesh step vs no group, relative error of each loss: "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
        if not all(np.isfinite(v) for v in got["mesh"].values()) or max(errs.values()) > 1e-5:
            raise AssertionError("the mesh step's losses differ from the step without a group")

        vcfg = _train_cfg()
        ps = PixelSynth(vcfg, device=DEVICE, seed=0, with_classifier=True)
        W = vcfg.model.W
        img, cams = _view_inputs(W)
        _, RT = get_rt_from_rot("R", cams["P"], scene_mode=False, rotation=0.3)
        view_cams = {"K": cams["K"], "Kinv": cams["Kinv"], "P_in": cams["P"],
                     "Pinv_in": cams["Pinv"], "P_out": RT}
        views = {}
        for tag, m in (("no group", None), ("mesh", mesh)):
            sg = SceneGenerator(ps, num_samples=num_samples, mesh=m)
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            best, out = sg.generate_view(img, view_cams, CloudState.empty(1, W * W, 3, DEVICE),
                                         None, cams["Pinv"], 2)
            torch.cuda.synchronize()
            log(f"[parallel] view, pop {num_samples} ({tag}): "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
            if tag == "mesh":
                check_no_plain("the sharded-population view")
                record_launches(report, read_launches(), ("lmconv_up", "lmconv_down",
                                                          "splat_blend", "custom_order"),
                                "the sharded-population view")
            if out["sampled"] is None:
                raise AssertionError("the view had nothing to sample")
            views[tag] = (best, out)
        (b0, o0), (b1, o1) = views["no group"], views["mesh"]
        same = torch.equal(o0["sampled"], o1["sampled"])
        best_err = float((b0.float() - b1.float()).abs().max())
        log(f"[parallel] sharded population vs no group: codes equal {same}, best view "
            f"max |diff| {best_err:.3g}")
        if not same or best_err > 1e-5:
            raise AssertionError("the sharded population differs from the ungrouped one")
    finally:
        shutdown()


class _path:
    """One tool's run as a path of the report: the launch counts zeroed
    just before it and read just after, the kernels `names` recorded under
    `tag` (each must have launched), no plain version taken."""

    def __init__(self, report, tag, names):
        self.report, self.tag, self.names = report, tag, names

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        zero_launches()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, *_):
        import torch

        if kind is not None:
            return False
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        launches = read_launches()
        check_no_plain(self.tag)
        record_launches(self.report, launches, self.names, self.tag)
        log(f"[tools] {self.tag}: {self.seconds:.1f} s, launches "
            + json.dumps({k: v for k, v in launches.items() if v}))
        return False


def _finite_numbers(tag, out):
    bad = {k: v for k, v in out.items()
           if isinstance(v, (int, float)) and not (v == v and abs(v) < float("inf"))}
    if bad:
        raise AssertionError(f"{tag} gave numbers that are not finite: {bad}")


def _reference_files(ps, out_dir, seed=0):
    """Reference-layout state dicts of ps's unet, projector, disc, vqvae and
    PixelCNN (tests/torch_reference_dicts.random_reference_state_dict),
    written as the reference writes its three checkpoint files: -> the
    import_from_files keywords."""
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.tools import import_reference_ckpt as imp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference_dicts import random_reference_state_dict

    rng = np.random.default_rng(seed)
    mc = ps.cfg.model
    plans = {"pts_regressor": (imp.plan_unet(ps.unet.levels), ps.unet),
             "projector": (imp.plan_resnet_blocks(ps.projector, "eblocks"), ps.projector),
             "netD": (imp.plan_discriminator(), ps.disc)}
    main = {}
    for prefix, (plan, module) in plans.items():
        sd = random_reference_state_dict(plan, module, rng)
        main.update({f"model.module.{prefix}.{k}": v for k, v in sd.items()})
    vq = random_reference_state_dict(imp.plan_vqvae(mc.vqvae.n_res_block), ps.vqvae, rng)
    lm = random_reference_state_dict(imp.plan_lmconv(mc.lmconv.nr_resnet), ps.pixelcnn, rng)
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"{k}.pth")
             for k in ("pixelsynth", "vqvae", "autoregressive")}
    torch.save({"state_dict": main, "epoch": 0}, paths["pixelsynth"])
    torch.save({f"module.{k}": v for k, v in vq.items()}, paths["vqvae"])
    torch.save({"model_state_dict": lm, "epoch": 0}, paths["autoregressive"])
    return {f"{k}_path": v for k, v in paths.items()}


def phase_tools(report, view_samples=8, cfg=None, W=256, N=65536 * 2):
    """The profiling and tuning tools, the importer and the exporter on the
    card, each at reduced repetitions (output under build/tools/):
      * profile_view (reps 2, samples 8; Config() widths, random weights):
        the view step's stages one by one, then the step;
      * profile_hotspots (reps 2): the U-Net's and the decoder's parts;
      * profile_splat (reps 5): the splat at f32 and bf16 on the bench
        protocol (C=64); the background must not move and the bf16 image
        stay within the JAX package's bar of 0.02 x scale of the f32 one
        (tests/test_splat.py:158-160);
      * tune_splat.sweep on three rows (a tile_group-only change, which K2
        does not read; tile 32 with M 2048; tile 24, which K2 refuses at
        W=256) against the default;
      * sweep_speculative (specs 4 and 12, reps 2);
      * scene_drift on evidence/relay/stitched.npz over its held-out world
        (heldout_demo_world), the "fixed" knobs, directions R and L,
        num_split 2;
      * import_reference_ckpt: a reference-layout state dict at the
        Config() widths, written as the reference's three files, read by
        import_from_files; one default view through K1 and K2 must be
        finite in [-1, 1]; then forward_angle on it over
        nerf_like_circle(4) with blend_dtype "bfloat16" against "float32"
        (the max and mean difference logged, K2's bf16 launches recorded);
      * export_torch_weights.export_features of a VGG19-layout stack built
        here, read back by models/losses.load_torch_vgg19.
    Each tool's kernel launches are recorded as a path of the report.
    `cfg` (default Config()) sets the networks' widths and W, N the splat
    tools' protocol (the bench protocol by default)."""
    import copy

    import numpy as np
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world
    from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
    from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
    from pixelsynth_tpu_torch.scene import SceneGenerator
    from pixelsynth_tpu_torch.tools import (
        export_torch_weights, import_reference_ckpt, profile_hotspots, profile_splat,
        profile_view, scene_drift, sweep_speculative, tune_splat)
    from pixelsynth_tpu_torch.utils.camera_paths import nerf_like_circle

    from pixelsynth_tpu_torch.demo import load_model

    t_phase = time.perf_counter()
    cfg = cfg or Config()
    out_dir = os.path.join(REPO, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    K1K2 = ("lmconv_up", "lmconv_down", "splat_blend", "custom_order")

    with _path(report, "tools: profile_view", K1K2):
        pv = profile_view.profile_view(load_model(None, copy.deepcopy(cfg), device=DEVICE),
                                       samples=view_samples, reps=2, device=DEVICE)
    _finite_numbers("profile_view", pv)
    log(f"[tools] profile_view (samples {view_samples}, reps 2) on {card_line()}: "
        + json.dumps(pv))

    hs = profile_hotspots.profile_hotspots(W, reps=2, cfg=cfg, device=DEVICE)
    _finite_numbers("profile_hotspots", hs)
    log("[tools] profile_hotspots (reps 2): " + json.dumps(hs))

    with _path(report, "tools: profile_splat", ("splat_blend", "splat_blend_bf16")):
        # the bench protocol's draws (profile_splat._inputs) at W, N
        sp = profile_splat.profile_splat(
            reps=5, inputs=(W, *tune_splat._inputs(W, N, 2, device=DEVICE)), device=DEVICE)
    _finite_numbers("profile_splat", sp)
    log("[tools] profile_splat (reps 5): " + json.dumps(sp))
    bar = 0.02 * max(sp["bf16_scale"], 1.0)
    if not (sp["bf16_bg_diff_frac"] == 0.0 and sp["bf16_max_abs_diff"] <= bar):
        raise AssertionError(f"profile_splat: the bf16 splat moved the background or left "
                             f"the bar {bar:.4f}: {json.dumps(sp)}")

    grid = [(16, 1024, 64), (32, 2048, 16), (24, 1024, 16)]
    with _path(report, "tools: tune_splat", ("splat_blend",)):
        rows = tune_splat.sweep(W, N, 2, grid, 3, device=DEVICE)
    log("[tools] tune_splat.sweep (bench protocol, reps 3): " + json.dumps(rows))
    if not (rows[1]["max_abs_delta"] == 0.0 and rows[1]["bg_delta_frac"] == 0.0
            and str(rows[3]["ms"]).startswith("failed")
            and isinstance(rows[2]["ms"], float)):
        raise AssertionError("tune_splat: a tile_group-only row must equal the default, "
                             "tile 24 must be refused, tile 32 must run")

    with _path(report, "tools: sweep_speculative", ("lmconv_up", "lmconv_down")):
        spec_rows = sweep_speculative.sweep_speculative((4, 12), 16, 2, cfg=cfg,
                                                        device=DEVICE)
    for r in spec_rows:
        if not 1 <= r["cells_per_fwd"] <= r["spec"] + 1:
            raise AssertionError(f"sweep_speculative: {r}")

    ps = PixelSynth.from_stitched(os.path.join(REPO, "evidence/relay/stitched.npz"),
                                  device=DEVICE)
    world, _, _ = heldout_demo_world(ps.W)
    with _path(report, "tools: scene_drift", K1K2):
        dr = scene_drift.drift(ps, world, configs=["fixed"], num_samples=4, num_split=2,
                               directions=["R", "L"],
                               out=os.path.join(out_dir, "scene_drift.json"))
    fixed = dr["fixed"]
    log("[tools] scene_drift (stitched.npz, fixed, R and L, num_split 2): " + json.dumps(
        {k: v for k, v in fixed.items() if k != "records"}))
    if fixed["n_views_scored"] != 6 or not np.isfinite(fixed["scene_gt_psnr"]):
        raise AssertionError("scene_drift scored no finite walk")
    del ps

    # the importer: reference-layout files at the Config() widths
    base = PixelSynth(cfg, device=DEVICE, seed=0)
    t0 = time.perf_counter()
    files = _reference_files(base, os.path.join(out_dir, "reference"))
    sds = import_reference_ckpt.import_from_files(base, **files)
    del base
    ps = PixelSynth(cfg, device=DEVICE, state_dicts=sds, with_classifier=True)
    log(f"[tools] import_reference_ckpt: {sorted(sds)} from three reference-layout files "
        f"in {time.perf_counter() - t0:.1f} s")
    img, cams = _view_inputs(cfg.model.W)
    _, RT = get_rt_from_rot("R", cams["P"], scene_mode=False, rotation=0.3)
    view_cams = {"K": cams["K"], "Kinv": cams["Kinv"], "P_in": cams["P"],
                 "Pinv_in": cams["Pinv"], "P_out": RT}
    gen = SceneGenerator(ps, num_samples=view_samples)
    with _path(report, "tools: imported checkpoint view", K1K2):
        best, out = gen.generate_view(img, view_cams,
                                      CloudState.empty(1, cfg.model.W ** 2, 3, DEVICE),
                                      None, cams["Pinv"], 3)
    n_bg = int((out["bg_ds"] >= 1 - 1e-6).sum())
    log(f"[tools] imported checkpoint: one default view, {n_bg} background cells, range "
        f"[{float(best.min()):.3f}, {float(best.max()):.3f}]")
    if not (bool(torch.isfinite(best).all()) and float(best.abs().max()) <= 1.0
            and tuple(best.shape) == (1, cfg.model.W, cfg.model.W, 3) and n_bg > 0):
        raise AssertionError("the imported checkpoint's view is not a finite image in "
                             "[-1, 1] with cells to outpaint")
    x = torch.as_tensor(img, device=DEVICE)
    K = torch.as_tensor(cams["K"], dtype=torch.float32, device=DEVICE)
    Kinv = torch.as_tensor(cams["Kinv"], dtype=torch.float32, device=DEVICE)
    RTs = nerf_like_circle(4)
    views = {}
    for dt in ("float32", "bfloat16"):
        ps.cfg.model.splat.blend_dtype = dt
        names = ("splat_blend_bf16",) if dt == "bfloat16" else ("splat_blend",)
        with _path(report, f"tools: forward_angle {dt} (imported)", names):
            views[dt] = ps.forward_angle(x, K, Kinv, RTs,
                                         gen=torch.Generator(device=DEVICE).manual_seed(5))
    ps.cfg.model.splat.blend_dtype = "float32"
    diffs = [(a - b).abs() for a, b in zip(views["float32"], views["bfloat16"])]
    log(f"[tools] forward_angle bf16 against f32 on the imported checkpoint, 4 views: "
        f"max |diff| {max(float(d.max()) for d in diffs):.3e}, mean "
        f"{float(torch.stack([d.mean() for d in diffs]).mean()):.3e}")
    if not all(bool(torch.isfinite(v).all()) and float(v.abs().max()) <= 1.0
               for v in views["bfloat16"]):
        raise AssertionError("forward_angle with the bf16 blend is not finite in [-1, 1]")
    del ps, gen

    # the exporter: a VGG19-layout stack round trip through the loader
    from pixelsynth_tpu_torch.models.losses import VGG19Features, load_torch_vgg19
    from pixelsynth_tpu_torch.weights import merge_collections

    g = torch.Generator().manual_seed(0)
    layers, cin = [], 3
    for c in [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]:
        if c == "M":
            layers.append(torch.nn.MaxPool2d(2))
            continue
        conv = torch.nn.Conv2d(cin, c, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        layers += [conv, torch.nn.ReLU()]
        cin = c
    seq = torch.nn.Sequential(*layers)
    path = os.path.join(out_dir, "vgg19_features.npz")
    export_torch_weights.export_features(seq, path)
    vgg = VGG19Features()
    vgg.load_flax(merge_collections(load_torch_vgg19(path)))
    theirs = [m.weight for m in seq if isinstance(m, torch.nn.Conv2d)]
    ours = [p for n, p in vgg.named_parameters() if n.endswith("weight")]
    if not ours or not all(torch.equal(a, b) for a, b in zip(ours, theirs)):
        raise AssertionError("export_features -> load_torch_vgg19 did not round-trip")
    log(f"[tools] export_torch_weights: {len(theirs)} VGG19 convs round-tripped through "
        f"load_torch_vgg19 ({len(ours)} read)")
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f} s")


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
    phase_k2_bf16(report)
    phase_k3(report)
    phase_k4(report)
    phase_k5(report)
    phase_orders(report)
    if not only_kernels:
        phase_view(report)
        phase_view_f32()
        phase_engines(report)
        phase_view2(report)
        phase_walk()
        phase_relay(report)
        phase_eval(report)
        phase_angle(report)
        phase_card_vs_cpu()
        B = phase_train(report)
        phase_train_kernels(B)
        phase_train_overfit()
        phase_train_vqvae()
        phase_train_lmconv(report)
        phase_train_evidence()
        phase_relay_chain(report)
        phase_datasets(report)
        phase_parallel(report)
        phase_tools(report)
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    keys = ["name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "heap_ms"]
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
