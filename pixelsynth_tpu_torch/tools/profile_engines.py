"""One forward of each PixelCNN engine, traced on the card: is it the
device or the host that bounds it?

  python3 -m pixelsynth_tpu_torch.tools.profile_engines

At chip_smoke.py's engine shapes (16 candidates, 32x32 codes, F=80, bf16)
and for the K1 path, the module engine (32 K3 launches a forward) and the
per-layer kernel engine (14 K4 + 4 K3), one forward under torch.profiler:
  - the device kernels it runs: how many, their busy time, and the share of
    that time in this package's own kernels (K1/K3/K4);
  - the host's launch calls (CUDA runtime events) and ATen ops;
  - the forward's time without the profiler (CUDA events around
    back-to-back forwards, chip_smoke.time_ms), and so the device's busy
    share of it: a low share means the host bounds the engine.
Needs a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OWN_KERNELS = ("layer_kernel", "gated_resnet_kernel", "masked_conv", "init_kernel")


def trace_forward(fn):
    """Chrome-trace events of one fn() call: (device kernels, CUDA runtime
    calls, ATen ops)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forward.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]

    def of(cat):
        return [e for e in events if e.get("cat") == cat]

    launches = [e for e in of("cuda_runtime") if "Launch" in e.get("name", "")]
    return of("kernel"), launches, of("cpu_op")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_engines: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pixelsynth_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build(["lmconv_fused", "masked_conv", "gated_resnet"])
    engines, k1_fn, inp = cs._engine_fns(16, 32, 80)
    codes, filled = inp["codes"], inp["filled"]
    fns = {"k1": k1_fn, **{name: fn for name, (fn, _) in engines.items()}}
    for name, fn in fns.items():
        def forward():
            return fn(codes, filled)

        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        kernels, launches, ops = trace_forward(forward)
        if not kernels:
            raise AssertionError("the profiler traced no device kernel")
        busy = sum(e["dur"] for e in kernels)
        own = [e for e in kernels if any(k in e["name"] for k in OWN_KERNELS)]
        span = (max(e["ts"] + e["dur"] for e in kernels)
                - min(e["ts"] for e in kernels))
        fwd_us = cs.time_ms(forward, reps=5, rounds=3) * 1e3
        print(f"[{name}] {len(kernels)} device kernels busy {busy:.1f} us "
              f"({len(own)} of this package's: {sum(e['dur'] for e in own):.1f} us); "
              f"{len(launches)} launch calls, {len(ops)} ATen ops on the host; "
              f"first to last kernel under the profiler {span:.1f} us", flush=True)
        print(f"[{name}] forward {fwd_us:.1f} us without the profiler (CUDA events): "
              f"device busy share {busy / fwd_us:.3f}", flush=True)
        by_name = {}
        for e in kernels:
            k = e["name"].replace("(anonymous namespace)::", "")
            k = k.split("<")[0].split("(")[0][-60:]
            n, t = by_name.get(k, (0, 0.0))
            by_name[k] = (n + 1, t + e["dur"])
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"[{name}] top kernels (count, us): " + json.dumps(
            {k: (n, round(t, 1)) for k, (n, t) in top}), flush=True)
    print(cs.card_line())


if __name__ == "__main__":
    main()
