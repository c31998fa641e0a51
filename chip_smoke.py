#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero and never
prints the final ok line):
  1. build the CUDA kernels (all nvcc processes started together) and
     print the toolchain and the card;
  2. each kernel against its plain PyTorch version at the main path's
     shapes, timed with CUDA events (K1: pop 16, 32x32 codes, F=80, bf16;
     K2: W=256, 2 images x 131072 points, each accumulation; K3: pop 16,
     32x32, (Cin, Cout) = (160, 80), (160, 160) and, dilation 2, (80, 80),
     bf16 and float32; K4: pop 16, 32x32, F=80, with and without the skip;
     K5: the binning keys of 131072 points, (1, 2^19), and (2, 2^17),
     exact against torch.sort(stable=True), which is also its library
     yardstick);
  3. the default path at full width: one `generate_view` at the Config()
     defaults (W=256, 32x32 codes, nr_filters 80, speculative 12) with
     seeded random weights and 16 candidates (K1, K2);
  4. the per-layer engines: the AR fill (`ar_sample` over every background
     cell, pop 16) through the module path (32 K3 launches a forward) and
     through the per-layer kernel engine (14 K4 + 4 K3), each held to the
     K1 path by argmax agreement;
  5. the same view with sample_backend="pallas" and sort_backend="pallas"
     (K3, K5, K2), its binning tables held to the library-sort binner's;
  6. the trained relay checkpoint (evidence/relay/stitched.npz, W=128)
     through the weight bridge, walking directions R and L.
Each path's launch counts are zeroed just before it is driven and read
just after.  The script ends with a `kernels` JSON line, the card's name
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
SOURCES = ["lmconv_fused", "splat_blend", "masked_conv", "gated_resnet", "sort_kv"]


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
            if "registers" in line or "spill" in line:
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


def _pixelcnn_params(Fc=80, seed=0):
    """Flax-named PixelCNN arrays at width Fc from a seed (CPU tensors)."""
    import torch
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params

    cfg = Config()
    cfg.model.lmconv.nr_filters = Fc
    return cfg, random_pixelcnn_params(cfg, torch.Generator().manual_seed(seed))


def _k1_inputs(B=16, side=32, Fc=80, seed=0):
    import numpy as np
    import torch
    from pixelsynth_tpu_torch.ops.lmconv_fused import (
        embed_input, fold_boundary_masks, pack_lmconv_params)

    _, params = _pixelcnn_params(Fc, seed)
    packed = pack_lmconv_params(params, nr_resnet=2, device=DEVICE)
    rng = np.random.default_rng(seed)
    _, masks, _ = _half_grid(side)
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
        report[name] = _entry(name, "lmconv_fused.cu",
                              f"pixelsynth_tpu/ops/lmconv_fused.py:{line}",
                              err, ms, pms, t_ops, t_bytes)
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
    report["splat_blend"] = _entry(
        "splat_blend", "splat_blend.cu", "pixelsynth_tpu/ops/splat_pallas.py:40",
        max(errs.values()), ms, pms, t_ops, t_bytes)
    log(f"[K2] splat_blend: {ms:.3f} ms kernel, {pms:.3f} ms plain, "
        f"{pairs / 1e6:.1f} M pixel x slot pairs, bound {max(t_ops, t_bytes):.4f} ms")


def _uniform(gen, shape, bound):
    import torch

    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(DEVICE)


def phase_k3(report, B=16, side=32, Fc=80):
    """K3 at the trunk's three conv shapes, on the masks of `_half_grid`:
    the bf16 kernel and the float32 kernel against the plain version."""
    import torch
    from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks

    _, masks, _ = _half_grid(side)
    masks = masks.repeat(B, 1, 1, 1)
    gen = torch.Generator().manual_seed(3)
    # (Cin, Cout, dilation, which mask, launches per module-path forward)
    shapes = [(2 * Fc, Fc, 1, 1, 14), (2 * Fc, 2 * Fc, 1, 1, 14), (Fc, Fc, 2, 2, 4)]
    tot = {"ms": 0.0, "pms": 0.0, "ops": 0.0, "bytes": 0.0, "n": 0}
    worst = 0.0
    for cin, cout, dil, mi, n_fwd in shapes:
        x = torch.randn((B, side, side, cin), generator=gen).to(DEVICE)
        bound = 1.0 / (9 * cin) ** 0.5
        w = _uniform(gen, (9, cin, cout), bound)
        b = _uniform(gen, (cout,), bound)
        pm = K3.prepare_mask(masks[:, mi])
        kw = dict(dilation=dil)
        out_k = K3.locally_masked_conv2d_kernel(x, pm, w, b, compute_dtype="bfloat16", **kw)
        out_p = K3.locally_masked_conv2d_plain(x, pm, w, b, compute_dtype="bfloat16", **kw)
        f32_k = K3.locally_masked_conv2d_kernel(x, pm, w, b, compute_dtype="float32", **kw)
        f32_p = K3.locally_masked_conv2d_plain(x, pm, w, b, compute_dtype="float32", **kw)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        err32 = float((f32_k - f32_p).abs().max())
        ref = float(out_p.abs().max())
        # Both sides round the operands to the compute dtype and sum in f32:
        # only the summation order differs, in bf16 as in f32.  So 1e-4
        # holds the indexing itself in both, far inside the 2% of the
        # output's range that K1 and K4 (which round activations between
        # layers) are given.
        tol = 1e-4
        log(f"[K3] ({cin},{cout}) d{dil}: bf16 max|kernel-plain| {err:.3e} "
            f"(max|ref| {ref:.2f}, atol {tol:.0e}); f32 {err32:.3e} (atol 1e-4)")
        if not (err <= tol and err32 <= 1e-4):
            raise AssertionError(f"K3 ({cin},{cout}) disagrees with its plain version")
        worst = max(worst, err)
        wb = w.to(torch.bfloat16)
        ms = time_ms(lambda: K3.locally_masked_conv2d_kernel(
            x, pm, wb, b, compute_dtype="bfloat16", **kw))
        ms32 = time_ms(lambda: K3.locally_masked_conv2d_kernel(
            x, pm, w, b, compute_dtype="float32", **kw), reps=3, rounds=3)
        pms = time_ms(lambda: K3.locally_masked_conv2d_plain(
            x, pm, w, b, compute_dtype="bfloat16", **kw), reps=3, rounds=3)
        # active (position, tap) pairs: mask on and the tap inside the image
        pairs = float(fold_boundary_masks(masks[:, mi], side, side, 3, dil).sum())
        flops = 2.0 * pairs * cin * cout
        # the timed call: x, mask, bias and out in f32, the weights in bf16
        by = ((x.numel() + pm.rows.numel() + b.numel() + out_k.numel()) * 4
              + wb.numel() * wb.element_size())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, by / PEAK_BYTES * 1e3
        log(f"[K3] ({cin},{cout}) d{dil}: {ms:.4f} ms bf16 kernel, {ms32:.4f} ms f32 "
            f"kernel, {pms:.3f} ms plain, {flops / 1e9:.2f} GFLOP needed, "
            f"{by / 1e6:.1f} MB, bound {max(t_ops, t_bytes):.4f} ms")
        for k, v in (("ms", ms), ("pms", pms), ("ops", t_ops), ("bytes", t_bytes)):
            tot[k] += n_fwd * v
        tot["n"] += n_fwd
    # one entry: the mean over the 32 launches of a module-path forward
    # (14 + 14 + 4 of the three shapes), bound taken shape by shape
    n = tot["n"]
    report["masked_conv"] = _entry(
        "masked_conv", "masked_conv.cu", "pixelsynth_tpu/ops/masked_conv_pallas.py:26",
        worst, tot["ms"] / n, tot["pms"] / n, tot["ops"] / n, tot["bytes"] / n)
    log(f"[K3] masked_conv: mean of a forward's {n} launches {tot['ms'] / n:.4f} ms "
        f"(plain {tot['pms'] / n:.3f} ms)")


def phase_k4(report, B=16, side=32, Fc=80):
    import torch
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks
    from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask

    _, masks, _ = _half_grid(side)
    masks = masks.repeat(B, 1, 1, 1)
    pm = prepare_mask(masks[:, 1])
    gen = torch.Generator().manual_seed(4)
    og = torch.randn((B, side, side, Fc), generator=gen).to(DEVICE)
    a = torch.randn((B, side, side, Fc), generator=gen).to(DEVICE)
    bound = 1.0 / (18 * Fc) ** 0.5
    w1, b1 = _uniform(gen, (9, 2 * Fc, Fc), bound), _uniform(gen, (Fc,), bound)
    w2, b2 = _uniform(gen, (9, 2 * Fc, 2 * Fc), bound), _uniform(gen, (2 * Fc,), bound)
    ws, bs = _uniform(gen, (2 * Fc, Fc), (2 * Fc) ** -0.5), _uniform(gen, (Fc,), 0.1)
    pairs = float(fold_boundary_masks(masks[:, 1], side, side, 3, 1).sum())
    res = {}
    for skip in (False, True):
        args = (og, a if skip else None, pm, w1, b1, ws if skip else None,
                bs if skip else None, w2, b2)
        out_k = K4.gated_resnet_kernel(*args)
        out_p = K4.gated_resnet_plain(*args)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        mean_err = float((out_k - out_p).abs().mean())
        ref = float(out_p.abs().max())
        # bf16 dot operands on both sides; a conv1 sum that straddles a bf16
        # rounding boundary moves conv2's operand by one bf16 ulp, and two
        # PONOs rescale it.  Such flips are rare and small, so the worst
        # element is held to 2% of a unit (inside the 2% of the output's
        # range that K1 is given) and the mean to 1e-4: a wrong skip bias or
        # a shifted tap moves every element by far more than that.
        tol, mean_tol = 0.02, 1e-4
        log(f"[K4] skip={skip}: max|kernel-plain| {err:.3e} (max|ref| {ref:.2f}, "
            f"tol {tol:.1e}), mean {mean_err:.3e} (tol {mean_tol:.0e})")
        if not (err <= tol and mean_err <= mean_tol):
            raise AssertionError("K4 disagrees with its plain version")
        bf = torch.bfloat16
        fast = (og, args[1], pm, w1.to(bf), b1, ws.to(bf) if skip else None,
                args[6], w2.to(bf), b2)
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
        res[skip] = (err, ms, pms, t_ops, t_bytes)
    # one entry: the mean over a forward's 14 launches (6 without, 8 with skip)
    mean = [(6 * res[False][i] + 8 * res[True][i]) / 14 for i in range(1, 5)]
    report["gated_resnet"] = _entry(
        "gated_resnet", "gated_resnet.cu",
        "pixelsynth_tpu/ops/gated_resnet_pallas.py:71",
        max(res[False][0], res[True][0]), *mean)


def phase_k5(report, W=256):
    """K5 on real binning keys: `_k2_inputs`-style points through the
    binner's key function, at (1, 2^19) and (2, 2^17); exact."""
    import torch
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import sort_kernel as K5
    from pixelsynth_tpu_torch.ops.splat import _image_sort_keys

    cfg = SplatConfig()
    for B, N, main in ((1, 65536 * 2, True), (2, 32768, False)):
        _, pts, _, vld = _k2_inputs(W=W, N=N)
        keys, _ = _image_sort_keys(pts[:B], vld[:B], W, cfg)
        E = keys.shape[1]
        sk, sv = K5.sort_kv_kernel(keys)
        ref_k, ref_v = torch.sort(keys, dim=1, stable=True)
        torch.cuda.synchronize()
        same = bool(torch.equal(sk, ref_k)) and bool(torch.equal(sv.long(), ref_v))
        n_bad = int((sk != ref_k).sum() + (sv.long() != ref_v).sum())
        log(f"[K5] ({B}, 2^{E.bit_length() - 1}) keys, {int(keys.unique().numel())} "
            f"distinct: equal to torch.sort(stable=True) in keys and indices: {same}")
        if not same:
            raise AssertionError(f"K5 differs from a stable sort in {n_bad} places")
        if not main:
            continue
        pk, pv = K5.sort_kv_plain(keys)
        if not (torch.equal(pk, sk) and torch.equal(pv, sv)):
            raise AssertionError("K5 differs from its plain network")
        ms = time_ms(lambda: K5.sort_kv_kernel(keys))
        pms = time_ms(lambda: K5.sort_kv_plain(keys), warmup=1, reps=1, rounds=3)
        lib = time_ms(lambda: torch.sort(keys, dim=1, stable=True))
        # bytes: each key read once (4 B), each sorted key and index written
        # once (8 B): 12 B an element; no floating-point work
        by = 12.0 * B * E
        t_bytes = by / PEAK_BYTES * 1e3
        report["sort_kv"] = _entry(
            "sort_kv", "sort_kv.cu", "pixelsynth_tpu/ops/sort_pallas.py:158",
            0.0, ms, pms, 0.0, t_bytes, library_ms=lib)
        log(f"[K5] sort_kv (1, 2^19): {ms:.4f} ms kernel, {pms:.2f} ms plain network, "
            f"{lib:.4f} ms torch.sort(stable=True), bound {t_bytes:.4f} ms "
            f"(12 B x {B * E} elements / 3.35 TB/s)")


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


def _counters():
    from pixelsynth_tpu_torch.ops import (
        gated_resnet_kernel, lmconv_fused, masked_conv_kernel, sort_kernel, splat)

    return [lmconv_fused.LAUNCHES, splat.LAUNCHES, masked_conv_kernel.LAUNCHES,
            gated_resnet_kernel.LAUNCHES, sort_kernel.LAUNCHES]


def zero_launches():
    for counts in _counters():
        counts.update(dict.fromkeys(counts, 0))


def read_launches():
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def record_launches(report, launches, names, path):
    """Write the launch counts of the kernels `names`, read just after the
    path that runs them, into the report; each must have launched."""
    for name in names:
        report[name]["launches"] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on {path}")


def _run_view(tag, cfg):
    """One timed `generate_view` (second call) at `cfg`, pop 16, every
    stage of the view step with re-ranking by classifier entropy.  Launch
    counts are zeroed just before it and read just after."""
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
    out, launches, n_bg, pts, valid = _run_view("view", cfg)
    st = out["ar_stats"]
    if st["n_forwards"] == 0:
        raise AssertionError("the view had nothing to outpaint")
    log(f"[view] AR forwards {st['n_forwards']}, cells committed per forward "
        f"{n_bg / max(1, st['n_forwards']):.2f}")
    record_launches(report, launches, ("lmconv_up", "lmconv_down", "splat_blend"),
                    "the default view")
    # capacity truncation of this view's splat
    _, _, counts = splat._bin_points_batched(pts, valid, cfg.model.W, cfg.model.splat,
                                             return_counts=True)
    over = torch.clamp(counts - cfg.model.splat.max_points_per_tile, min=0)
    log(f"[view] splat: max entries per tile {int(counts.max())}, entries over "
        f"max_points_per_tile={cfg.model.splat.max_points_per_tile}: {int(over.sum())}")


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
    phase_k3(report)
    phase_k4(report)
    phase_k5(report)
    if not only_kernels:
        phase_view(report)
        phase_engines(report)
        phase_view2(report)
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
