"""The generation order and kernel masks on the device (port of
pixelsynth_tpu/ops/orders_jax.py).

`custom_order_device(distances)` takes (B, H, W) int32 signed distances
and returns the (B, H*W) int32 flat greedy order: on a CUDA tensor one
launch of csrc/custom_order.cu (one warp an image; see its note), on a
CPU tensor `custom_order_plain`, which is `custom_order_jax`'s loop step
for step in torch ops, vectorised over B.  The fused key distance * 10000
- flat index makes "largest distance, then smallest (r, c)" one integer
maximum, so both are bit-equal to the JAX loop and to the host heap
(ops/orders.py).  The masks reuse ops/orders.py `masks_from_rank`.  Nothing
here falls back to the host: a build or launch failure on the card raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pixelsynth_tpu_torch.ops import _cuda
from pixelsynth_tpu_torch.ops.orders import masks_from_rank

KEY_SCALE = 10000

LAUNCHES = {"custom_order": 0}
PLAIN_CALLS = {"custom_order": 0}


def _check_size(H: int, W: int) -> None:
    # the flat-index term of the fused key must stay below the distance step
    assert H * W < KEY_SCALE, "grid too large for the fused tie-break key"


def custom_order_plain(distances: torch.Tensor) -> torch.Tensor:
    """custom_order_jax (orders_jax.py:33-80) in torch ops: (B, H, W) int
    -> (B, H*W) int32.  Each of the HW - 1 steps pushes the unvisited
    in-grid 4-neighbours of the last pixel into the frontier and pops the
    frontier's maximum score.  Out-of-grid neighbours point at a spare
    slot HW that counts as used, so no two pushes of a step share an
    index."""
    B, H, W = distances.shape
    _check_size(H, W)
    HW = H * W
    dev = distances.device
    idx = torch.arange(HW, dtype=torch.int32, device=dev)
    score = distances.reshape(B, HW).to(torch.int32) * KEY_SCALE - idx
    r, c = idx // W, idx % W
    nb_ok = torch.stack([r > 0, r < H - 1, c > 0, c < W - 1], 1)
    nb = torch.stack([idx - W, idx + W, idx - 1, idx + 1], 1).long()
    nb = torch.where(nb_ok, nb, torch.full_like(nb, HW))
    rows = torch.arange(B, device=dev)
    cur = score.argmax(1)
    used = torch.zeros((B, HW + 1), dtype=torch.bool, device=dev)
    used[:, HW] = True
    used[rows, cur] = True
    frontier = torch.zeros((B, HW + 1), dtype=torch.bool, device=dev)
    masked_fill = torch.full((B, 1), torch.iinfo(torch.int32).min,
                             dtype=torch.int32, device=dev)
    score = torch.cat([score, masked_fill], 1)
    order = torch.empty((B, HW), dtype=torch.int32, device=dev)
    order[:, 0] = cur
    for t in range(1, HW):
        cand = nb[cur]                                    # (B, 4)
        push = ~used.gather(1, cand)
        used.scatter_(1, cand, True)
        frontier.scatter_(1, cand, frontier.gather(1, cand) | push)
        cur = torch.where(frontier, score, masked_fill).argmax(1)
        frontier[rows, cur] = False
        order[:, t] = cur
    return order


def _lib():
    lib = _cuda.load("custom_order")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.custom_order.argtypes = [P, P, I, I, I, P]
        lib.custom_order.restype = I
        lib._typed = True
    return lib


def custom_order_device(distances: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 distances, H * W < 10000 -> (B, H*W) int32 flat
    order: the CUDA kernel for a CUDA tensor, `custom_order_plain` for a
    CPU one."""
    B, H, W = distances.shape
    _check_size(H, W)
    if not distances.is_cuda:
        PLAIN_CALLS["custom_order"] += 1
        return custom_order_plain(distances)
    _cuda.require(distances, "distances", dtype=torch.int32, shape=(B, H, W))
    out = torch.empty((B, H * W), dtype=torch.int32, device=distances.device)
    rc = _lib().custom_order(_cuda.ptr(distances), _cuda.ptr(out), B, H, W,
                             _cuda.stream_of(distances))
    _cuda.check(rc, "custom_order")
    LAUNCHES["custom_order"] += 1
    return out


def rank_from_flat_order(order_flat: torch.Tensor) -> torch.Tensor:
    """(B, HW) flat order -> (B, HW) rank of each pixel, same dtype."""
    B, HW = order_flat.shape
    pos = torch.arange(HW, dtype=order_flat.dtype, device=order_flat.device)
    return torch.empty_like(order_flat).scatter_(1, order_flat.long(),
                                                 pos.expand(B, HW))


def order_flat_to_coords(order_flat: torch.Tensor, W: int) -> torch.Tensor:
    """(B, HW) -> (B, HW, 2) [row, col]."""
    return torch.stack([order_flat // W, order_flat % W], dim=-1)


def orders_and_masks_device(distances: torch.Tensor, k: int = 3,
                            max_dilation: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 distances -> (order (B, HW, 2) [row, col] int64,
    masks (B, 3, k*k, HW) f32), on the distances' device, with no copy to
    the host: the device counterpart of ops/orders.py `orders_and_masks`
    (orders_jax.py:135 `orders_and_masks_jax`)."""
    B, H, W = distances.shape
    flat = custom_order_device(distances.to(torch.int32).contiguous()).long()
    masks = masks_from_rank(rank_from_flat_order(flat), H=H, W=W, k=k,
                            max_dilation=max_dilation)
    return order_flat_to_coords(flat, W), masks
