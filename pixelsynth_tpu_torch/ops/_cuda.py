"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` exposes a plain C interface.  It is compiled on first
use into `build/kernels/lib<name>-<hash>.so` at the repository root (the
hash covers the source and every `csrc/*.cuh` header it includes, directly
or through another header, so an edited source or header is rebuilt) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

and loaded with `ctypes`.  Pointers and the stream travel as
`ctypes.c_void_p`; every entry point returns `cudaGetLastError()` and
`check` raises on a non-zero code.  Nothing here runs at import time: the
CPU tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(name: str) -> List[str]:
    """csrc/<name>.cu and the local headers (`#include "..."`) it pulls in,
    transitively, in first-seen order."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return [os.path.join(CSRC_DIR, rel) for rel in seen]


def _lib_path(name: str, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha1(" ".join(defines).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _nvcc_cmd(name: str, out: str, verbose: bool, defines: Sequence[str]) -> list:
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", *[f"-D{d}" for d in defines], "-o", out,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build(names: Iterable[str], verbose: bool = False,
          defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every named source not built yet, all nvcc processes
    started together.  Returns {name: compiler output}.  Every process
    is waited for; then one RuntimeError names each source that failed
    (an error in a shared header fails every source that includes it).
    `defines` are preprocessor macros ("NAME" or "NAME=value") of a
    variant build: a library of its own, beside the plain one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name, defines)
        if os.path.exists(out) and not verbose:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp, verbose, defines), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def load_variant(name: str, defines: Sequence[str]) -> ctypes.CDLL:
    """csrc/<name>.cu built with the macros `defines`, loaded beside the
    plain library (the profiling tools time a kernel with a part compiled
    out).  To route a wrapper through it, put it into `_libs[name]`."""
    build([name], defines=defines)
    return ctypes.CDLL(_lib_path(name, defines))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def require(t, name: str, *, dtype, shape=None, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape (None entries in `shape` match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
