"""Generation orders (host heap) and kernel masks (device) for the
locally-masked PixelCNN.

The greedy order pops HW pixels one at a time, each pop depending on the
last -- inherently sequential, and on the card it would cost thousands of
tiny launches per view.  So it runs on the host with a heap, the shape of
the reference's Cython routine (get_custom_order.pyx:50-82) and of the JAX
package's host backend (native/custom_order.cpp, ported here to Python's
heapq): start at the first row-major maximum of the distances (scaled by
10000), then repeatedly push the unvisited 4-neighbours of the last popped
pixel and pop the heap minimum of (-distance, r, c).  The kernel masks are
rank-grid shift comparisons on the device.  Both match
pixelsynth_tpu/ops/orders_jax.orders_and_masks_jax bit for bit.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BIG_RANK = 1 << 30


def custom_order_one(dist: np.ndarray) -> np.ndarray:
    """(H, W) int distances -> (H*W,) flat generation order."""
    H, W = dist.shape
    d = dist.astype(np.int64).reshape(-1) * 10000
    best = int(np.argmax(d))
    r, c = divmod(best, W)
    used = np.zeros(H * W, bool)
    used[best] = True
    heap = []
    order = [best]
    while len(order) < H * W:
        for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= nr < H and 0 <= nc < W:
                idx = nr * W + nc
                if not used[idx]:
                    used[idx] = True
                    heapq.heappush(heap, (-int(d[idx]), nr, nc))
        _, r, c = heapq.heappop(heap)
        order.append(r * W + c)
    return np.asarray(order, np.int64)


def custom_order(distances: np.ndarray) -> np.ndarray:
    """(B, H, W) int distances -> (B, H*W) flat orders."""
    return np.stack([custom_order_one(d) for d in np.asarray(distances)])


def masks_from_rank(rank: torch.Tensor, *, H: int, W: int, k: int = 3,
                    max_dilation: int = 2) -> torch.Tensor:
    """Rank grid (B, HW) -> mask triple (B, 3, k*k, HW) f32: [A dil 1,
    B dil 1, B dil max_dilation].  Tap (dr, dc) of pixel p is on iff
    rank[p + (dr, dc)*dil] < rank[p]; out-of-bounds taps are 0; B-type
    masks re-enable the center tap."""
    B = rank.shape[0]
    half = k // 2
    rg = rank.reshape(B, H, W)

    def taps(dilation):
        pad = half * dilation
        padded = F.pad(rg, (pad, pad, pad, pad), value=_BIG_RANK)
        out = []
        for dr in range(-half, half + 1):
            for dc in range(-half, half + 1):
                nbr = padded[:, pad + dr * dilation:pad + dr * dilation + H,
                             pad + dc * dilation:pad + dc * dilation + W]
                out.append(((nbr < rg) & (nbr != _BIG_RANK)).reshape(B, H * W))
        return torch.stack(out, dim=1).float()

    center = (k * k) // 2
    t1 = taps(1)
    mask_a = t1.clone()
    mask_a[:, center] = 0.0
    mask_b = t1.clone()
    mask_b[:, center] = 1.0
    mask_d = taps(max_dilation) if max_dilation != 1 else t1.clone()
    mask_d[:, center] = 1.0
    return torch.stack([mask_a, mask_b, mask_d], dim=1)


def orders_and_masks(distances: torch.Tensor, k: int = 3,
                     max_dilation: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int distances -> (order (B, HW, 2) [row, col] int64,
    masks (B, 3, k*k, HW) f32), both on the distances' device.  The order
    is computed on the host (one device->host copy of B*HW ints)."""
    B, H, W = distances.shape
    dev = distances.device
    flat = torch.as_tensor(custom_order(distances.cpu().numpy()), device=dev)
    rank = torch.empty_like(flat)
    rank.scatter_(1, flat, torch.arange(H * W, device=dev).expand(B, -1))
    masks = masks_from_rank(rank, H=H, W=W, k=k, max_dilation=max_dilation)
    order = torch.stack([flat // W, flat % W], dim=-1)
    return order, masks
