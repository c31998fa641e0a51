"""Profiling and timing helpers (port of pixelsynth_tpu/utils/profiling.py).

  * `trace(log_dir)`: a `torch.profiler` trace of the block, CPU and CUDA
    activities, written into log_dir as a Chrome trace (viewable in
    Perfetto or chrome://tracing), where the JAX package starts the XLA
    profiler;
  * `SectionTimer`: accumulating per-section timer with the JAX package's
    summary (total_s, count, mean_ms); a section synchronises the current
    CUDA device at entry and at exit when one is in use, so it times the
    device work launched inside it and not only the launches;
  * `time_compiled(fn, *args)`: mean seconds a call, `reps` back-to-back
    calls between two CUDA events after `warmup` calls, or with
    `sync_each` events around each call (the host clock on the CPU).

The profiling tools (pixelsynth_tpu_torch/tools/profile_*.py, tune_splat.py,
sweep_speculative.py) time with `time_compiled` or `scene.StageTimer`,
never with a bare host clock around asynchronous work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU and, with a card, CUDA activities) and write
    a Chrome trace `trace_<pid>_<n>.json` into log_dir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if _cuda_in_use():
            torch.cuda.synchronize()
        prof.stop()
        n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(log_dir))
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class SectionTimer:
    """Accumulating timer for pipeline stages: each section's seconds,
    the device's work included where a card is in use."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        sync = _cuda_in_use()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(v / self.counts[k] * 1000, 3)}
            for k, v in sorted(self.totals.items())
        }


def time_compiled(fn, *args, reps: int = 10, warmup: int = 1,
                  sync_each: bool = False) -> float:
    """Mean seconds a call of fn(*args): `warmup` calls (at least one),
    then `reps` calls back to back between two CUDA events, read after a
    synchronise; with `sync_each`, CUDA events around each call, each
    read before the next call starts (a dispatched call's time).  On the
    CPU (no card in use) the host clock around the same calls."""
    for _ in range(max(1, warmup)):
        fn(*args)
    if not _cuda_in_use():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps if sync_each else 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if sync_each else reps):
            fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) / 1e3
    return total / reps
