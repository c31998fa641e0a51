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

The training side's orders and masks (pixelsynth_tpu/ops/orders.py:68-300)
are numpy on the host, bit for bit the JAX package's: the raster,
s-curve and Hilbert orders, their 8 symmetry variants, and the compact
(k*k, H*W) mask triple of an order (`masks_for_order`), stacked over a
batch by `masks_for_orders_batch`; `rank_from_flat_order` is
orders_jax.py:83's.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# training orders and masks (numpy, host)
# ---------------------------------------------------------------------------


def raster_scan_order(rows: int, cols: int) -> np.ndarray:
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([r.reshape(-1), c.reshape(-1)], -1)


def s_curve_order(rows: int, cols: int) -> np.ndarray:
    idx = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        idx.extend([r, c] for c in cs)
    return np.array(idx)


def hilbert_order(rows: int, cols: int) -> np.ndarray:
    """Hilbert-curve order of a power-of-two square grid (masking.py:38-48),
    (row, col) as the reference stores it."""
    assert rows == cols and rows > 0 and (rows & (rows - 1)) == 0
    out = np.empty((rows * cols, 2), np.int64)
    for d in range(rows * cols):
        x = y = 0
        t, s = d, 1
        while s < rows:
            rx = 1 & (t // 2)
            ry = 1 & (t ^ rx)
            if ry == 0:
                if rx == 1:
                    x, y = s - 1 - x, s - 1 - y
                x, y = y, x
            x += s * rx
            y += s * ry
            t //= 4
            s *= 2
        out[d] = (y, x)
    return out.astype(np.int32)


def augment_orders(order: np.ndarray, rows: int, cols: int) -> List[np.ndarray]:
    """The 8 symmetry variants of an order (masking.py:133-143)."""
    o = np.asarray(order)
    t = o[:, ::-1]
    return [
        o,
        np.stack([rows - 1 - o[:, 0], o[:, 1]], -1),
        np.stack([o[:, 0], cols - 1 - o[:, 1]], -1),
        np.stack([rows - 1 - o[:, 0], cols - 1 - o[:, 1]], -1),
        t,
        np.stack([rows - 1 - t[:, 0], t[:, 1]], -1),
        np.stack([t[:, 0], cols - 1 - t[:, 1]], -1),
        np.stack([rows - 1 - t[:, 0], cols - 1 - t[:, 1]], -1),
    ]


def rank_grid_from_order(order: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows, cols) int32 grid of each pixel's position in the order."""
    order = np.asarray(order)
    rank = np.empty((rows, cols), np.int32)
    rank[order[:, 0], order[:, 1]] = np.arange(order.shape[0], dtype=np.int32)
    return rank


def rank_from_flat_order(order_flat: np.ndarray, HW: int) -> np.ndarray:
    """(B, HW) flat order -> (B, HW) int32 rank of each pixel."""
    order_flat = np.asarray(order_flat)
    B = order_flat.shape[0]
    rank = np.zeros((B, HW), np.int32)
    rank[np.arange(B)[:, None], order_flat] = np.arange(HW, dtype=np.int32)[None]
    return rank


def kernel_masks_from_order(order: np.ndarray, rows: int, cols: int, k: int = 3,
                            dilation: int = 1, mask_type: str = "B",
                            observed: Optional[np.ndarray] = None) -> np.ndarray:
    """(rows*cols, k, k) {0, 1} kernel masks in row-major pixel order
    (masking.py:287-341): tap (dr, dc) of pixel p is 1 iff the pixel at
    p + (dr, dc) * dilation comes strictly earlier in the order (or is
    `observed`), 0 over the padding; type B turns the centre tap on, type A
    off.  observed (rows, cols) bool counts as generated first when looked
    up as a neighbour; the centre keeps its own rank."""
    assert k % 2 == 1
    half = k // 2
    rank = rank_grid_from_order(order, rows, cols).astype(np.int64)
    nb_rank = np.where(observed, np.int64(-1), rank) if observed is not None else rank
    big = np.int64(1 << 60)
    pad = half * dilation
    padded = np.full((rows + 2 * pad, cols + 2 * pad), big, np.int64)
    padded[pad:pad + rows, pad:pad + cols] = nb_rank
    masks = np.zeros((rows * cols, k, k), np.float32)
    center = rank.reshape(-1)
    for i, dr in enumerate(range(-half, half + 1)):
        for j, dc in enumerate(range(-half, half + 1)):
            nb = padded[pad + dr * dilation:pad + dr * dilation + rows,
                        pad + dc * dilation:pad + dc * dilation + cols].reshape(-1)
            masks[:, i, j] = (nb < center) & (nb != big)
    masks[:, half, half] = 1.0 if mask_type == "B" else 0.0
    return masks


def masks_for_order(order: np.ndarray, rows: int, cols: int, k: int = 3,
                    max_dilation: int = 2, observed: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mask_init A, mask_undilated B, mask_dilated B at max_dilation), each
    (k*k, rows*cols) float32 (masking.py:343-370)."""

    def unfold(m):
        return m.reshape(rows * cols, k * k).T.copy()

    a = unfold(kernel_masks_from_order(order, rows, cols, k, 1, "A", observed))
    b = unfold(kernel_masks_from_order(order, rows, cols, k, 1, "B", observed))
    if max_dilation == 1:
        return a, b, b
    d = unfold(kernel_masks_from_order(order, rows, cols, k, max_dilation, "B",
                                       observed))
    return a, b, d


def masks_for_orders_batch(orders: Sequence[np.ndarray], rows: int, cols: int,
                           k: int = 3, max_dilation: int = 2
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """masks_for_order over a batch -> three (B, k*k, rows*cols)."""
    a, b, d = zip(*(masks_for_order(o, rows, cols, k, max_dilation) for o in orders))
    return np.stack(a), np.stack(b), np.stack(d)
