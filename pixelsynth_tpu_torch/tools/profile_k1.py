"""K1's time by part, on the card.

  python3 -m pixelsynth_tpu_torch.tools.profile_k1

At chip_smoke.py's K1 shapes (16 candidates, 32x32 codes, F=80, bf16):
  1. the device time of every launch of one up + down pass
     (torch.profiler), averaged by layer kind, beside the pass's time;
  2. the up / down pass times (CUDA events, chip_smoke.time_ms) of the
     layer kernel built with one part compiled out: the epilogue, the
     tensor-core products, the ring's copies.  Those variants compute
     wrong values; only their times are read.
Needs a CUDA device and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (first line of the part, text that ends it, macro that compiles it out)
PARTS = (
    ("  // epilogue: one warp per position", "    }\n  }\n", "NO_EPILOGUE"),
    ("    mma_step<F, NOUT, F>(acc, ring_a[i & 1]", ";\n", "NO_MMA"),
    ("      copy_step<F, NOUT>(ring_a[(i + 1) & 1]", ";\n", "NO_COPY"),
)
VARIANTS = {"whole": [], "no epilogue": ["NO_EPILOGUE"], "no products": ["NO_MMA"],
            "no copies": ["NO_COPY"], "no products, no copies": ["NO_MMA", "NO_COPY"]}


def _guarded_source(path: str) -> str:
    text = open(path).read()
    for start, end, macro in PARTS:
        i = text.index(start)
        j = text.index(end, i) + len(end)
        text = f"{text[:i]}#ifndef {macro}\n{text[i:j]}#endif\n{text[j:]}"
    return text


def _launch_kinds(nr: int):
    """Layer kinds of one up + down pass, in launch order."""
    gated = ["gated conv 1", "gated conv 2"]
    up = ["init"] + gated * nr + ["dilated"] + gated * nr + ["dilated"] + gated * nr
    down = (["init"] + gated * nr + ["dilated"] + gated * (nr + 1) + ["dilated"]
            + gated * (nr + 1))
    return up + down


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
    kw = dict(H=32, W=32, nr=2, dilation=2, compute_dtype="bfloat16")

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

    # the parts live in the layer body's header: a guarded copy of it goes
    # beside a copy of the source that includes it
    parts_dir = os.path.join(_cuda.BUILD_DIR, "k1_parts")
    os.makedirs(parts_dir, exist_ok=True)
    guarded = os.path.join(parts_dir, "lmconv_fused.cu")
    shutil.copyfile(os.path.join(_cuda.CSRC_DIR, "lmconv_fused.cu"), guarded)
    with open(os.path.join(parts_dir, "lmconv_layer.cuh"), "w") as f:
        f.write(_guarded_source(os.path.join(_cuda.CSRC_DIR, "lmconv_layer.cuh")))
    procs = {}
    for name, macros in VARIANTS.items():
        out = os.path.join(_cuda.BUILD_DIR, f"lmconv_fused_{'_'.join(macros) or 'whole'}.so")
        cmd = [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-w", *[f"-D{m}" for m in macros], "-o", out,
               guarded]
        procs[name] = (subprocess.Popen(cmd), out)
    for name, (proc, _) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} variant")
    stack = K1.up(u0, mu, md, packed, **kw)
    for name, (_, lib) in procs.items():
        _cuda._libs["lmconv_fused"] = ctypes.CDLL(lib)
        up = cs.time_ms(lambda: K1.up(u0, mu, md, packed, **kw))
        down = cs.time_ms(lambda: K1.down(stack, mu, md, packed, **kw))
        print(f"[parts] {name:24s} up {up:.3f} ms  down {down:.3f} ms", flush=True)
    _cuda._libs.pop("lmconv_fused")
    print(cs.card_line())


if __name__ == "__main__":
    main()
