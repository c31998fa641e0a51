"""Device time of the kernels (K1 up and down, K2, K3, K4, K5), on the card.

  python3 -m pixelsynth_tpu_torch.tools.device_times [--only k2,k3]
      [--k2-channels 3,64] [--k2-save OUT.npz] [--k2-compare REF.npz]
      [--k3-variant]

A call of these wrappers is one or a few launches, and the host's work for
a call can exceed the kernels' time: CUDA events around back-to-back calls
(chip_smoke.time_ms) then read the host.  This reads the kernels' own
durations from torch.profiler, at chip_smoke.py's shapes (pop 16, 32x32,
F=80, bf16, the masks of the half-empty grid; K2 at W=256, 2 images x
131072 points; the binning keys of 131072 points, (1, 2^19)), beside the
time of a call, and for K5 beside
torch.sort(stable=True).  K2 is timed as the checkout has it: the blend
from the binner's tables with the gather inside (`blend_slots`), or the
slot gather followed by the blend over the gathered lists; the device time
of either is the sum of its kernels, at each of `--k2-channels` feature
widths (default 3; f32 features, K2's f32 entry).  K3's device time likewise includes
the cast of x to bf16 where the checkout's wrapper launches one.
`--k2-save` writes K2's image and coverage in every accumulation (image
layout) to an npz, `--k2-compare` holds them bit for bit to such a file
(written by another checkout); `--k3-variant` also times K3 built with the
other cluster size.  It uses only the wrappers' public signatures, so a
copy of this file runs unchanged in an older checkout of the repository
(to compare two versions inside one run on one card).
Needs a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_us(fn, reps: int = 20):
    """({kernel name: device us per call}, their sum) over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            by[name] = by.get(name, 0.0) + e.device_time_total / reps
    return {k: round(v, 2) for k, v in by.items()}, sum(by.values())


def k2_runs(K2, pts, fts, vld, W, cfg):
    """{accumulation: fn() -> (image (B, W, W, C), coverage (B, W, W))} of
    the checkout's K2 from the binner's tables, gather included."""
    import dataclasses

    slot_idx, slot_valid = K2._bin_points_batched(pts, vld, W, cfg)
    runs = {}
    for acc in ("alphacomposite", "wsum", "wsumnorm"):
        c = dataclasses.replace(cfg, accumulation=acc)
        if hasattr(K2, "blend_slots"):
            runs[acc] = (lambda c=c: K2.blend_slots(pts, fts, slot_idx, slot_valid, W, c))
        else:   # the slot gather, then the blend of the gathered lists
            def run(c=c):
                B, TS = pts.shape[0], c.tile_size
                n = W // TS
                spts, sfts, svld = K2.gather_slots(pts, fts, slot_idx, slot_valid)
                org = K2.tile_origins(W, TS, pts.device).repeat(B, 1)
                out, cov = K2.blend_tiles(spts, sfts, svld, org, W, c)
                img = out.reshape(B, n, n, TS, TS, -1).transpose(2, 3).reshape(B, W, W, -1)
                return img, cov.reshape(B, n, n, TS, TS).transpose(2, 3).reshape(B, W, W)
            runs[acc] = run
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="k1,k2,k3,k4,k5")
    ap.add_argument("--k2-channels", default="3")
    ap.add_argument("--k2-save")
    ap.add_argument("--k2-compare")
    ap.add_argument("--k3-variant", action="store_true")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("device_times: needs a CUDA device")
    sys.path.insert(0, REPO)
    import numpy as np
    import chip_smoke as cs
    from pixelsynth_tpu_torch.config import SplatConfig
    from pixelsynth_tpu_torch.ops import _cuda
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1
    from pixelsynth_tpu_torch.ops import splat as K2
    from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
    from pixelsynth_tpu_torch.ops import sort_kernel as K5
    from pixelsynth_tpu_torch.ops.splat import _image_sort_keys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, side, Fc = 16, 32, 80
    bf = torch.bfloat16
    _, masks, _ = cs._half_grid(side)
    masks = masks.repeat(B, 1, 1, 1)
    gen = torch.Generator().manual_seed(3)

    try:    # weights laid out once, where the checkout has that
        from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps
    except ImportError:
        def prepare_taps(w, _width):
            return w if w.dim() == 3 and w.shape[0] == 9 else w[0]

    def report(tag, fn):
        by, total = device_us(fn)
        call = cs.time_ms(fn) * 1e3
        print(f"[{tag}] device {total:.1f} us a call {json.dumps(by)}; "
              f"a call takes {call:.1f} us (CUDA events)", flush=True)

    if "k1" in only:
        packed, u0, mu, md, *_ = cs._k1_inputs(B, side, Fc)
        kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16",
                  tables=K1.tile_tables(mu, md))
        stack = K1.up(u0, mu, md, packed, **kw)
        report("K1 up", lambda: K1.up(u0, mu, md, packed, **kw))
        report("K1 down", lambda: K1.down(stack, mu, md, packed, **kw))

    if "k2" in only:
        got = {}
        for C in map(int, args.k2_channels.split(",")):
            W2, pts, fts, vld = cs._k2_inputs(C=C, W=256, N=65536 * 2)
            runs = k2_runs(K2, pts, fts, vld, W2, SplatConfig())
            at = "" if C == 3 else f" at C={C}"
            report(f"K2 splat blend{at}, gather included", runs["alphacomposite"])
            suffix = "" if C == 3 else f"_c{C}"
            for acc, run in runs.items():
                img, cov = run()
                got[f"{acc}_image{suffix}"] = img.cpu().numpy()
                got[f"{acc}_coverage{suffix}"] = cov.cpu().numpy()
        if args.k2_save:
            np.savez(args.k2_save, **got)
        if args.k2_compare:
            ref = np.load(args.k2_compare)
            for k, v in got.items():
                same = np.array_equal(v.view(np.uint8), ref[k].view(np.uint8))
                d = np.abs(v.astype(np.float64) - ref[k].astype(np.float64))
                print(f"[K2] {k}: bit-identical to {os.path.basename(args.k2_compare)} "
                      f"{same}, largest difference {float(d.max())}, values that "
                      f"differ {int((d > 0).sum())} of {d.size}", flush=True)

    if "k3" in only:
        k3 = []
        for cin, cout, dil, mi in ((2 * Fc, Fc, 1, 1), (2 * Fc, 2 * Fc, 1, 1), (Fc, Fc, 2, 2)):
            x = torch.randn((B, side, side, cin), generator=gen).to(cs.DEVICE)
            w = prepare_taps(cs._uniform(gen, (9, cin, cout), 0.03).to(bf),
                             K3.kernel_width(cin, cout))
            b = cs._uniform(gen, (cout,), 0.03)
            pm = K3.prepare_mask(masks[:, mi])
            k3.append((f"({cin},{cout}) d{dil}", x, pm, w, b, dil))
        for tag, x, pm, w, b, dil in k3:
            report(f"K3 {tag}",
                   lambda: K3.locally_masked_conv2d_kernel(x, pm, w, b, dilation=dil))
        if args.k3_variant:
            other = 3 - K3._lib().masked_conv_cluster()
            plain = _cuda._libs["masked_conv"]
            _cuda._libs["masked_conv"] = _cuda.load_variant(
                "masked_conv", [f"K3_CLUSTER={other}"])
            for tag, x, pm, w, b, dil in k3:
                report(f"K3 {tag}, clusters of {other}",
                       lambda: K3.locally_masked_conv2d_kernel(x, pm, w, b, dilation=dil))
            _cuda._libs["masked_conv"] = plain

    if "k4" in only:
        pm = K3.prepare_mask(masks[:, 1])
        og = torch.randn((B, side, side, Fc), generator=gen).to(cs.DEVICE)
        a = torch.randn((B, side, side, Fc), generator=gen).to(cs.DEVICE)
        w1 = prepare_taps(cs._uniform(gen, (9, 2 * Fc, Fc), 0.03).to(bf), Fc)
        w2 = prepare_taps(cs._uniform(gen, (9, 2 * Fc, 2 * Fc), 0.03).to(bf), Fc)
        ws = prepare_taps(cs._uniform(gen, (1, 2 * Fc, Fc), 0.08).to(bf), Fc)
        b1, b2 = cs._uniform(gen, (Fc,), 0.03), cs._uniform(gen, (2 * Fc,), 0.03)
        bs = cs._uniform(gen, (Fc,), 0.1)
        report("K4 no skip",
               lambda: K4.gated_resnet_kernel(og, None, pm, w1, b1, None, None, w2, b2))
        report("K4 skip", lambda: K4.gated_resnet_kernel(og, a, pm, w1, b1, ws, bs, w2, b2))

    if "k5" in only:
        _, pts, _, vld = cs._k2_inputs(W=256, N=65536 * 2)
        keys, _ = _image_sort_keys(pts[:1], vld[:1], 256, SplatConfig())
        report("K5 (1, 2^19)", lambda: K5.sort_kv_kernel(keys))
        report("torch.sort(stable=True) (1, 2^19)",
               lambda: torch.sort(keys, dim=1, stable=True))
    print(cs.card_line())


if __name__ == "__main__":
    main()
