"""Device time of the kernels (K1 up and down, K2, K3, K4, K5), on the card.

  python3 -m pixelsynth_tpu_torch.tools.device_times

A call of these wrappers is one or a few launches, and the host's work for
a call can exceed the kernels' time: CUDA events around back-to-back calls
(chip_smoke.time_ms) then read the host.  This reads the kernels' own
durations from torch.profiler, at chip_smoke.py's shapes (pop 16, 32x32,
F=80, bf16, the masks of the half-empty grid; K2 at W=256, 2 images x
131072 points; the binning keys of 131072 points, (1, 2^19)), beside the
time of a call, and for K5 beside
torch.sort(stable=True).  It uses only the wrappers' public signatures, so
a copy of this file runs unchanged in an older checkout of the repository
(to compare two versions inside one run on one card).
Needs a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("device_times: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pixelsynth_tpu_torch.config import SplatConfig
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

    packed, u0, mu, md, *_ = cs._k1_inputs(B, side, Fc)
    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16",
              tables=K1.tile_tables(mu, md))
    stack = K1.up(u0, mu, md, packed, **kw)
    report("K1 up", lambda: K1.up(u0, mu, md, packed, **kw))
    report("K1 down", lambda: K1.down(stack, mu, md, packed, **kw))

    W2, pts, fts, vld = cs._k2_inputs(W=256, N=65536 * 2)
    scfg = SplatConfig()
    slot_idx, slot_valid = K2._bin_points_batched(pts, vld, W2, scfg)
    spts, sfts, svld = K2.gather_slots(pts, fts, slot_idx, slot_valid)
    org = K2.tile_origins(W2, scfg.tile_size, pts.device).repeat(pts.shape[0], 1)
    report("K2 splat blend", lambda: K2.blend_tiles(spts, sfts, svld, org, W2, scfg))

    for cin, cout, dil, mi in ((2 * Fc, Fc, 1, 1), (2 * Fc, 2 * Fc, 1, 1), (Fc, Fc, 2, 2)):
        x = torch.randn((B, side, side, cin), generator=gen).to(cs.DEVICE)
        w = prepare_taps(cs._uniform(gen, (9, cin, cout), 0.03).to(bf),
                         K3.kernel_width(cin, cout))
        b = cs._uniform(gen, (cout,), 0.03)
        pm = K3.prepare_mask(masks[:, mi])
        report(f"K3 ({cin},{cout}) d{dil}",
               lambda: K3.locally_masked_conv2d_kernel(x, pm, w, b, dilation=dil))

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

    _, pts, _, vld = cs._k2_inputs(W=256, N=65536 * 2)
    keys, _ = _image_sort_keys(pts[:1], vld[:1], 256, SplatConfig())
    report("K5 (1, 2^19)", lambda: K5.sort_kv_kernel(keys))
    report("torch.sort(stable=True) (1, 2^19)",
           lambda: torch.sort(keys, dim=1, stable=True))
    print(cs.card_line())


if __name__ == "__main__":
    main()
