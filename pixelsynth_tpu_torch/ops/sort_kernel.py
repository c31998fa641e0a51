"""K5: per-row stable sort of the splat binning keys (port of
pixelsynth_tpu/ops/sort_pallas.py).

`sort_kv_kernel(keys)` sorts each row of (B, E) int32 keys ascending and
returns (sorted_keys, original_index), both int32, bit-equal to a stable
sort.  For CUDA tensors it launches the bitonic network of
csrc/sort_kv.cu; for CPU tensors it takes `sort_kv_plain`, the same
compare-exchange network on (key, original index) pairs written out pass
by pass (`_sort_network`, :89-155, `_cmpswap`, :51-64), each pass
vectorised over its E/2 partner pairs.  Lexicographic comparison on
distinct pairs makes the network's output the stable order.  Neither calls
a library sort.
"""

from __future__ import annotations

import ctypes

import torch

from pixelsynth_tpu_torch.ops import _cuda

MIN_E = 1 << 14
MAX_E = 1 << 19   # as the TPU kernel's ceiling, so both packages route alike

LAUNCHES = {"sort_kv": 0}
PLAIN_CALLS = {"sort_kv": 0}


def _check_size(E: int) -> None:
    if E & (E - 1) or not (MIN_E <= E <= MAX_E):
        raise ValueError(f"E must be a power of two in [2^14, 2^19], got {E}")


def sort_kv_plain(keys: torch.Tensor):
    """The bitonic network: merge stages k = 2, 4, .., E, each of passes at
    partner distance j = k/2, .., 1.  In a pass, element i (bit j clear)
    and i | j are exchanged when out of order for their block's direction:
    ascending where bit k of i is clear."""
    B, E = keys.shape
    _check_size(E)
    k_arr = keys.to(torch.int32).clone()
    v_arr = torch.arange(E, dtype=torch.int32, device=keys.device).repeat(B, 1)
    t = torch.arange(E // 2, device=keys.device)
    k = 2
    while k <= E:
        j = k // 2
        while j > 0:
            lo = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            hi = lo | j
            asc = (lo & k) == 0
            ka, kb = k_arr[:, lo], k_arr[:, hi]
            va, vb = v_arr[:, lo], v_arr[:, hi]
            gt = (ka > kb) | ((ka == kb) & (va > vb))
            swap = gt == asc
            k_arr[:, lo] = torch.where(swap, kb, ka)
            k_arr[:, hi] = torch.where(swap, ka, kb)
            v_arr[:, lo] = torch.where(swap, vb, va)
            v_arr[:, hi] = torch.where(swap, va, vb)
            j //= 2
        k *= 2
    return k_arr, v_arr


def _lib():
    lib = _cuda.load("sort_kv")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sort_kv.argtypes = [P, P, P, I, I, P]
        lib.sort_kv.restype = I
        lib._typed = True
    return lib


def sort_kv_kernel(keys: torch.Tensor):
    """K5.  keys (B, E) int32, E a power of two in [2^14, 2^19] (ValueError
    otherwise) -> (sorted_keys (B, E), original_index (B, E)), int32."""
    B, E = keys.shape
    _check_size(E)
    if not keys.is_cuda:
        PLAIN_CALLS["sort_kv"] += 1
        return sort_kv_plain(keys)
    _cuda.require(keys, "keys", dtype=torch.int32, shape=(B, E))
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(keys)
    P = _cuda.ptr
    rc = _lib().sort_kv(P(keys), P(out_k), P(out_v), B, E,
                        _cuda.stream_of(keys))
    _cuda.check(rc, "sort_kv")
    LAUNCHES["sort_kv"] += 1
    return out_k, out_v
