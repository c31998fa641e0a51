"""K1's and K4's time by part, on the card.

  python3 -m pixelsynth_tpu_torch.tools.profile_k1

At chip_smoke.py's K1 shapes (16 candidates, 32x32 codes, F=80, bf16):
  1. the device time of every launch of one up + down pass
     (torch.profiler), averaged by layer kind, beside the pass's time;
  2. the up / down pass times (CUDA events, chip_smoke.time_ms) of the
     layer body (csrc/lmconv_layer.cuh) built with one part compiled out
     by a macro: the epilogue (LMK_NO_EPILOGUE), the tensor-core products
     (LMK_NO_MMA), the producer's copies of the operand rows
     (LMK_NO_COPY; the weights' bulk copy stays);
  3. K4 (one gated resnet, with and without the skip) with the same parts
     compiled out and, its own, the two grid barriers (LMK_NO_GRID_SYNC)
     and phase 0 (LMK_NO_PHASE0): the kernel's device time from the
     profiler, beside the time of a call.
The variants compute wrong values; only their times are read.  Needs a
CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# variant -> the macros that compile its parts out
BODY_VARIANTS = {"whole": [], "no epilogue": ["LMK_NO_EPILOGUE"],
                 "no products": ["LMK_NO_MMA"], "no copies": ["LMK_NO_COPY"],
                 "no products, no copies": ["LMK_NO_MMA", "LMK_NO_COPY"]}
K4_VARIANTS = dict(BODY_VARIANTS, **{
    "no grid barriers": ["LMK_NO_GRID_SYNC"], "no phase 0": ["LMK_NO_PHASE0"],
    "no grid barriers, no phase 0": ["LMK_NO_GRID_SYNC", "LMK_NO_PHASE0"]})


def _launch_kinds(nr: int):
    """Layer kinds of one up + down pass, in launch order."""
    gated = ["gated conv 1", "gated conv 2"]
    up = ["init"] + gated * nr + ["dilated"] + gated * nr + ["dilated"] + gated * nr
    down = (["init"] + gated * nr + ["dilated"] + gated * (nr + 1) + ["dilated"]
            + gated * (nr + 1))
    return up + down


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pixelsynth_tpu_torch.ops import _cuda
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, u0, mu, md, *_ = cs._k1_inputs(16, 32, 80)
    kw = dict(H=32, W=32, nr=2, dilation=2, compute_dtype="bfloat16",
              tables=K1.tile_tables(mu, md))

    def one_pass():
        return K1.down(K1.up(u0, mu, md, packed, **kw), mu, md, packed, **kw)

    for _ in range(3):
        one_pass()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "k1.json")
        prof.export_chrome_trace(trace)
        events = [e for e in json.load(open(trace))["traceEvents"]
                  if e.get("cat") == "kernel"]
    events.sort(key=lambda e: e["ts"])
    kinds = _launch_kinds(2)
    if len(events) != len(kinds):
        raise AssertionError(f"{len(events)} launches traced, {len(kinds)} expected")
    by_kind = {}
    for kind, e in zip(kinds, events):
        by_kind.setdefault(kind, []).append(e["dur"])
    print("[trace] us per launch: " + json.dumps(
        {k: round(sum(v) / len(v), 1) for k, v in by_kind.items()}))
    # the profiler slows the host's launches, so the pass is timed without it
    print(f"[trace] {len(events)} launches busy {sum(e['dur'] for e in events):.1f} us; "
          f"the pass takes {cs.time_ms(one_pass) * 1e3:.1f} us (CUDA events)")

    # every variant is a library of its own, all built together first
    from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4

    jobs = [(source, macros)
            for source, variants in (("lmconv_fused", BODY_VARIANTS),
                                     ("gated_resnet", K4_VARIANTS))
            for macros in variants.values()]
    with ThreadPoolExecutor(len(jobs)) as pool:   # each thread waits on its nvcc
        list(pool.map(lambda job: _cuda.build([job[0]], defines=job[1]), jobs))
    stack = K1.up(u0, mu, md, packed, **kw)
    plain_lib = _cuda.load("lmconv_fused")
    for name, macros in BODY_VARIANTS.items():
        _cuda._libs["lmconv_fused"] = _cuda.load_variant("lmconv_fused", macros)
        K1._lib()
        up = cs.time_ms(lambda: K1.up(u0, mu, md, packed, **kw))
        down = cs.time_ms(lambda: K1.down(stack, mu, md, packed, **kw))
        print(f"[K1 parts] {name:30s} up {up:.3f} ms  down {down:.3f} ms", flush=True)
    _cuda._libs["lmconv_fused"] = plain_lib

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
