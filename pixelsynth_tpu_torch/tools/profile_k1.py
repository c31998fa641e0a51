"""K1's, K4's and K3's time by part, on the card.

  python3 -m pixelsynth_tpu_torch.tools.profile_k1 [--k1-only | --k3-only]

At chip_smoke.py's K1 shapes (16 candidates, 32x32 codes, F=80, bf16):
  1. the device kernels of one up + down pass (torch.profiler): one a
     pass, and its device time;
  2. the time of each stage inside a pass and of its parts (waiting for
     the neighbours' counters, the rows' copy, each consumer warpgroup's
     products and epilogue, the publish): a build with LMK_STAMPS writes
     %globaltimer at seven points of every stage (csrc/lmconv_pass.cuh);
     the means over the blocks, by layer kind;
  3. the up / down pass's call time (CUDA events, chip_smoke.time_ms) and
     device time (profiler) of builds beside the plain one: the
     neighbours' counters replaced by a grid-wide count (LMK_GRID_SYNC),
     clusters of 2 sharing the weights' copies (LMK_MULTICAST), and with
     one part compiled out: the epilogue (LMK_NO_EPILOGUE), the
     tensor-core products (LMK_NO_MMA), the copies of the operand rows
     (LMK_NO_COPY; the weights' bulk copies stay);
  4. K4 (one gated resnet, with and without the skip) with the same parts
     compiled out and, its own, the two grid barriers (LMK_NO_GRID_SYNC)
     and phase 0 (LMK_NO_PHASE0): the kernel's device time from the
     profiler, beside the time of a call (left out with --k1-only);
  5. K3's resident route at the trunk's three conv shapes with the same
     parts compiled out (LMK_NO_COPY: the rows' f32 reads and bf16 stores)
     and built with the other cluster size (K3_CLUSTER): device us from
     the profiler (left out with --k1-only; with --k3-only, only this).
The part variants compute wrong values; only their times are read.  Needs
a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# variant -> the macros that compile its parts out
BODY_VARIANTS = {"whole": [], "no epilogue": ["LMK_NO_EPILOGUE"],
                 "no products": ["LMK_NO_MMA"], "no copies": ["LMK_NO_COPY"],
                 "no products, no copies": ["LMK_NO_MMA", "LMK_NO_COPY"]}
K1_VARIANTS = dict(BODY_VARIANTS, **{
    "grid-wide count, no flags": ["LMK_GRID_SYNC"],
    "multicast (clusters of 2)": ["LMK_MULTICAST"]})
STAMP_VARIANTS = {"clusters of 1": ["LMK_STAMPS"],
                  "clusters of 2": ["LMK_STAMPS", "LMK_MULTICAST"]}
K3_VARIANTS = dict(BODY_VARIANTS, **{"clusters of 2": ["K3_CLUSTER=2"]})
K4_VARIANTS = dict(BODY_VARIANTS, **{
    "no grid barriers": ["LMK_NO_GRID_SYNC"], "no phase 0": ["LMK_NO_PHASE0"],
    "no grid barriers, no phase 0": ["LMK_NO_GRID_SYNC", "LMK_NO_PHASE0"]})


def layer_kinds(nr: int, up: bool):
    """Stage names of one pass in order: phase 0, then its layers."""
    gated = ["gated conv 1", "gated conv 2"]
    blocks = (nr, nr, nr) if up else (nr, nr + 1, nr + 1)
    kinds = ["phase 0"]
    for i, n in enumerate(blocks):
        kinds += gated * n + (["dilated"] if i < 2 else [])
    return kinds


def _device_us(fn, kernel: str, reps: int = 10) -> float:
    """Mean device time (torch.profiler) of the launches of `kernel` in
    `reps` calls of fn: what the card takes, whatever the host does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    return sum(e.device_time_total for e in hits) / max(1, sum(e.count for e in hits))


PARTS = ("neighbours", "rows", "products", "products, warpgroup 1 after 0",
         "epilogue 0", "epilogue 1", "publish")


def stage_us(stamps: torch.Tensor, n_stages: int):
    """(blocks, 256) globaltimer ns of one pass (csrc/lmconv_pass.cuh
    `stamp`) -> per stage, the mean us over the blocks that ran of: the
    whole stage (publish to publish; phase 0 from the start) and, for a
    layer, its parts: waiting for the window's counters after the block's
    own last publish, the rows' copy, consumer warpgroup 0's products and
    how much later warpgroup 1's end, each warpgroup's epilogue, and the
    rest up to the publish (the barrier of both)."""
    t = stamps.view(-1, 256).double().cpu()
    t = t[t[:, 0] > 0]
    out = [{"stage": float((t[:, 0] - t[:, 255]).mean()) / 1e3}]
    for j in range(1, n_stages):
        pub, win, rows, prod0, prod1, epi0, epi1 = (t[:, 8 * j + k] for k in range(7))
        prev = t[:, 8 * (j - 1)]
        parts = (win - prev, rows - win, prod0 - rows, prod1 - prod0, epi0 - prod0,
                 epi1 - prod1, pub - torch.maximum(epi0, epi1))
        row = {"stage": float((pub - prev).mean()) / 1e3}
        row.update({k: float(v.mean()) / 1e3 for k, v in zip(PARTS, parts)})
        out.append(row)
    return out


def k3_parts(cs):
    """K3's device us at the trunk's three conv shapes for every build of
    K3_VARIANTS (the plain build's clusters are K3_CLUSTER's default)."""
    from pixelsynth_tpu_torch.ops import _cuda
    from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
    from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps

    with ThreadPoolExecutor(len(K3_VARIANTS)) as pool:
        list(pool.map(lambda m: _cuda.build(["masked_conv"], defines=m),
                      K3_VARIANTS.values()))
    B, side, Fc = 16, 32, 80
    _, masks, _ = cs._half_grid(side)
    masks = masks.repeat(B, 1, 1, 1)
    gen = torch.Generator().manual_seed(3)
    calls = []
    for cin, cout, dil, mi, _ in cs._k3_shapes(Fc):
        x = torch.randn((B, side, side, cin), generator=gen).to(cs.DEVICE)
        w = prepare_taps(cs._uniform(gen, (9, cin, cout), 0.03), K3.kernel_width(cin, cout))
        b = cs._uniform(gen, (cout,), 0.03)
        pm = K3.prepare_mask(masks[:, mi])
        calls.append((f"({cin},{cout}) d{dil}", lambda x=x, pm=pm, w=w, b=b, dil=dil:
                      K3.locally_masked_conv2d_kernel(x, pm, w, b, dilation=dil)))
    plain_lib = _cuda.load("masked_conv")
    for name, macros in K3_VARIANTS.items():
        _cuda._libs["masked_conv"] = _cuda.load_variant("masked_conv", macros)
        us = {tag: round(_device_us(fn, "resident_kernel"), 2) for tag, fn in calls}
        print(f"[K3 parts] {name:30s} device us {json.dumps(us)}", flush=True)
    _cuda._libs["masked_conv"] = plain_lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    if "--k3-only" in sys.argv:
        k3_parts(cs)
        print(cs.card_line())
        return
    from pixelsynth_tpu_torch.ops import _cuda
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, side, nr = 16, 32, 2
    packed, u0, mu, md, *_ = cs._k1_inputs(B, side, 80)
    kw = dict(H=side, W=side, nr=nr, dilation=2, compute_dtype="bfloat16",
              tables=K1.tile_tables(mu, md))
    stack = K1.up(u0, mu, md, packed, **kw)
    passes = {"up": lambda: K1.up(u0, mu, md, packed, **kw),
              "down": lambda: K1.down(stack, mu, md, packed, **kw)}

    for name, fn in passes.items():
        kernels, dev = cs.device_kernels(fn)
        print(f"[trace] {name}: device kernels of 10 calls {json.dumps(kernels)}; "
              f"device {dev:.1f} us a pass; a call {cs.time_ms(fn) * 1e3:.1f} us "
              f"(CUDA events)", flush=True)

    # every variant is a library of its own, all built together first
    k4 = "--k1-only" not in sys.argv
    jobs = ([("lmconv_fused", m)
             for m in list(K1_VARIANTS.values()) + list(STAMP_VARIANTS.values())]
            + [("gated_resnet", m) for m in K4_VARIANTS.values() if k4])
    with ThreadPoolExecutor(len(jobs)) as pool:   # each thread waits on its nvcc
        list(pool.map(lambda job: _cuda.build([job[0]], defines=job[1]), jobs))
    plain_lib = _cuda.load("lmconv_fused")

    K1.STAMPS["buffer"] = torch.zeros(B * side * side // 128 * 256, dtype=torch.int64,
                                      device="cuda")
    for variant, macros in STAMP_VARIANTS.items():
        _cuda._libs["lmconv_fused"] = _cuda.load_variant("lmconv_fused", macros)
        K1._lib()
        for name, fn in passes.items():
            kinds = layer_kinds(nr, name == "up")
            fn()
            torch.cuda.synchronize()
            K1.STAMPS["buffer"].zero_()
            fn()
            torch.cuda.synchronize()
            stages = stage_us(K1.STAMPS["buffer"], len(kinds))
            by_kind = {}
            for kind, st in zip(kinds, stages):
                by_kind.setdefault(kind, []).append(st)
            mean = {k: {p: round(sum(x[p] for x in v) / len(v), 2) for p in v[0]}
                    for k, v in by_kind.items()}
            print(f"[stages] {variant}, {name}: us a stage, in order "
                  f"{json.dumps([round(x['stage'], 2) for x in stages])}; sum "
                  f"{sum(x['stage'] for x in stages):.1f} us; mean by kind, with parts "
                  f"{json.dumps(mean)}", flush=True)
    K1.STAMPS["buffer"] = None

    for name, macros in K1_VARIANTS.items():
        _cuda._libs["lmconv_fused"] = _cuda.load_variant("lmconv_fused", macros)
        K1._lib()
        up = cs.time_ms(passes["up"])
        down = cs.time_ms(passes["down"])
        dev_up = _device_us(passes["up"], "pass_kernel")
        dev_dn = _device_us(passes["down"], "pass_kernel")
        print(f"[K1 parts] {name:30s} up {up:.3f} ms (device {dev_up:.1f} us)  "
              f"down {down:.3f} ms (device {dev_dn:.1f} us)", flush=True)
    _cuda._libs["lmconv_fused"] = plain_lib

    if not k4:
        print(cs.card_line())
        return
    k3_parts(cs)
    gen = torch.Generator().manual_seed(4)
    _, pm, og, a, (w1, b1, ws, bs, w2, b2) = cs._k4_case(16, 32, 80, "order", gen)
    from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps

    w1, ws, w2 = prepare_taps(w1, 80), prepare_taps(ws[None], 80), prepare_taps(w2, 80)
    plain_lib = _cuda.load("gated_resnet")
    for name, macros in K4_VARIANTS.items():
        _cuda._libs["gated_resnet"] = _cuda.load_variant("gated_resnet", macros)
        K4._lib()
        # a K4 call is one launch: the host's work per call can exceed the
        # kernel's time, so the device time is read from the profiler
        no = _device_us(lambda: K4.gated_resnet_kernel(og, None, pm, w1, b1, None, None,
                                                       w2, b2), "gated_resnet_kernel")
        sk = _device_us(lambda: K4.gated_resnet_kernel(og, a, pm, w1, b1, ws, bs, w2, b2),
                        "gated_resnet_kernel")
        call = cs.time_ms(lambda: K4.gated_resnet_kernel(og, a, pm, w1, b1, ws, bs, w2, b2))
        print(f"[K4 parts] {name:30s} device us: no skip {no:.1f}  skip {sk:.1f}; "
              f"a call with the skip {call * 1e3:.1f} us", flush=True)
    _cuda._libs["gated_resnet"] = plain_lib
    print(cs.card_line())


if __name__ == "__main__":
    main()
