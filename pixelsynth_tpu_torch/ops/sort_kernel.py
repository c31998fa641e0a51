"""K5: per-row stable sort of the splat binning keys (port of
pixelsynth_tpu/ops/sort_pallas.py).

`sort_kv_kernel(keys)` sorts each row of (B, E) int32 keys ascending and
returns (sorted_keys, original_index), both int32, bit-equal to a stable
sort.  For CUDA tensors it launches the radix sort of csrc/sort_kv.cu
(four stable scatter passes over 8-bit digits, least significant first);
for CPU tensors it takes `sort_kv_plain`, the TPU kernel's
compare-exchange network on (key, original index) pairs written out pass
by pass (`_sort_network`, :89-155, `_cmpswap`, :51-64), each pass
vectorised over its E/2 partner pairs.  Lexicographic comparison on
distinct pairs makes the network's output the stable order.
`sort_kv_radix_plain` is the CUDA kernel's own arithmetic in plain tensor
ops: histogram, scans and the stable scatter, tile by tile.  None of them
calls a library sort.
"""

from __future__ import annotations

import ctypes

import torch

from pixelsynth_tpu_torch.ops import _cuda

MIN_E = 1 << 14
MAX_E = 1 << 19   # as the TPU kernel's ceiling, so both packages route alike

# the CUDA kernel's tiling (csrc/sort_kv.cu)
RADIX_BITS = 8
RADIX_TILE = 4096

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


def sort_kv_radix_plain(keys: torch.Tensor):
    """The CUDA kernel's radix sort, step by step: four passes over the
    8-bit digits of key ^ 0x80000000, least significant first.  A pass
    counts each digit in the row (histogram) and in every tile of 4096
    elements, and sends an element to
        digits below it in the row + the same digit in earlier tiles
        + the same digit earlier in its own tile,
    which is a stable scatter; the values start as the index in the row."""
    B, E = keys.shape
    _check_size(E)
    dev = keys.device
    radix, tile = 1 << RADIX_BITS, RADIX_TILE
    T = E // tile
    k_arr = keys.to(torch.int32).clone()
    v_arr = torch.arange(E, dtype=torch.int32, device=dev).repeat(B, 1)
    rows = torch.arange(B, device=dev)[:, None].expand(B, E)
    for p in range(32 // RADIX_BITS):
        flipped = (k_arr.long() + (1 << 31)) & 0xFFFFFFFF      # key ^ 0x80000000
        digit = (flipped >> (RADIX_BITS * p)) & (radix - 1)    # (B, E)
        onehot = torch.zeros((B, T, tile, radix), dtype=torch.int32, device=dev)
        onehot.scatter_(3, digit.reshape(B, T, tile, 1), 1)
        in_tile = onehot.cumsum(2, dtype=torch.int32) - onehot  # same digit, earlier in the tile
        tile_count = onehot.sum(2, dtype=torch.int32)           # (B, T, radix)
        hist = tile_count.sum(1, dtype=torch.int32)             # (B, radix)
        below = hist.cumsum(1, dtype=torch.int32) - hist
        earlier = tile_count.cumsum(1, dtype=torch.int32) - tile_count
        base = (below[:, None] + earlier)[:, :, None].expand(B, T, tile, radix)
        pos = (base + in_tile).gather(3, digit.reshape(B, T, tile, 1))
        pos = pos.reshape(B, E).long()
        nk, nv = torch.empty_like(k_arr), torch.empty_like(v_arr)
        nk[rows, pos] = k_arr
        nv[rows, pos] = v_arr
        k_arr, v_arr = nk, nv
    return k_arr, v_arr


def _lib():
    lib = _cuda.load("sort_kv")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sort_kv.argtypes = [P] * 4 + [I, I, P]
        lib.sort_kv.restype = I
        lib.sort_kv_work_bytes.argtypes = [I, I]
        lib.sort_kv_work_bytes.restype = ctypes.c_longlong
        lib.sort_kv_launches.argtypes = []
        lib.sort_kv_launches.restype = I
        lib._typed = True
    return lib


def launches_per_sort() -> int:
    """Kernel launches (and the memset) one call of the CUDA sort makes."""
    return int(_lib().sort_kv_launches())


def sort_kv_kernel(keys: torch.Tensor):
    """K5.  keys (B, E) int32, E a power of two in [2^14, 2^19] (ValueError
    otherwise) -> (sorted_keys (B, E), original_index (B, E)), int32."""
    B, E = keys.shape
    _check_size(E)
    if not keys.is_cuda:
        PLAIN_CALLS["sort_kv"] += 1
        return sort_kv_plain(keys)
    _cuda.require(keys, "keys", dtype=torch.int32, shape=(B, E))
    lib = _lib()
    work = int(lib.sort_kv_work_bytes(B, E))
    # two allocations: the outputs, and the passes' other buffer + work area
    out = torch.empty((2, B, E), dtype=torch.int32, device=keys.device)
    scratch = torch.empty(2 * B * E + work // 4, dtype=torch.int32,
                          device=keys.device)
    P = _cuda.ptr
    rc = lib.sort_kv(P(keys), P(out[0]), P(out[1]), P(scratch), B, E,
                     _cuda.stream_of(keys))
    _cuda.check(rc, "sort_kv")
    LAUNCHES["sort_kv"] += 1
    return out[0], out[1]
