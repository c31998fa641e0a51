"""The port's order builders against the JAX package's, bit for bit: the
device builder's plain version (ops/orders_device.py) against
`custom_order_jax` / `orders_and_masks_jax` and the host heap;
`generation_order`, `custom_order`'s (rows*cols, 2) form, the native heap
and `foreground_mass_center` against ops/orders.py and
ops/distance_transform.py of the JAX package; `masks_for_background`
under both `lmconv.masks_backend` values; and `lmconv.weight_norm`, which
neither package reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops import orders as jax_orders
from pixelsynth_tpu.ops.distance_transform import (
    foreground_mass_center as jax_mass_center,
)
from pixelsynth_tpu.ops.orders_jax import custom_order_jax, orders_and_masks_jax
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops import orders as O
from pixelsynth_tpu_torch.ops import orders_device as D
from pixelsynth_tpu_torch.ops.distance_transform import foreground_mass_center
from pixelsynth_tpu_torch.pipeline import PixelSynth
from torch_threads import _few_torch_threads  # noqa: F401


def _grids(B, H, W, seed):
    """Signed-distance-like grids with many ties: small integers, a
    plateau of equal maxima and a negative band."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-3, 4, (B, H, W)).astype(np.int32)
    d[:, H // 4:H // 2, W // 4:W // 2] = 5
    d[:, -1] = -6
    return d


@pytest.mark.parametrize("H,W", [(8, 8), (16, 16), (32, 32)])
def test_device_builder_matches_jax_and_the_heap(H, W):
    dist = _grids(3, H, W, seed=H)
    calls = D.PLAIN_CALLS["custom_order"]
    flat = D.custom_order_device(torch.as_tensor(dist))
    assert D.PLAIN_CALLS["custom_order"] == calls + 1 and D.LAUNCHES["custom_order"] == 0
    assert flat.dtype == torch.int32 and flat.shape == (3, H * W)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(custom_order_jax(jnp.asarray(dist))))
    np.testing.assert_array_equal(flat.numpy(), O.custom_order_flat(dist))
    order, masks = D.orders_and_masks_device(torch.as_tensor(dist), 3, 2)
    order_j, masks_j = orders_and_masks_jax(jnp.asarray(dist), 3, 2)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(masks_j))
    host_order, host_masks = O.orders_and_masks(torch.as_tensor(dist), 3, 2)
    assert torch.equal(order, host_order) and torch.equal(masks, host_masks)


def test_device_builder_keeps_the_fused_key_bound():
    with pytest.raises(AssertionError, match="fused tie-break"):
        D.custom_order_device(torch.zeros((1, 100, 100), dtype=torch.int32))


@pytest.mark.parametrize("name", ["raster_scan", "s_curve", "hilbert",
                                  "s_curve_center_quarter_last", "custom"])
def test_generation_order_matches_jax(name):
    rows = cols = 8
    dist = _grids(1, rows, cols, seed=3)[0]
    kw = {"distances": dist} if name == "custom" else {}
    want = jax_orders.generation_order(name, rows, cols, **kw)
    got = O.generation_order(name, rows, cols, **kw)
    np.testing.assert_array_equal(got, want)
    assert sorted(map(tuple, got.tolist())) == [(r, c) for r in range(rows)
                                                for c in range(cols)]
    with pytest.raises(ValueError, match="unknown order"):
        O.generation_order("spiral", rows, cols)


def test_custom_order_coordinate_form_matches_jax():
    """(rows*cols, 2) for one grid, (B, rows*cols, 2) for a batch; the
    mass centre changes nothing, as in the reference's shipped code."""
    batch = _grids(2, 6, 9, seed=5)
    one = O.custom_order(batch[0], mass_center=np.array([4, 3]))
    assert one.shape == (54, 2) and one.dtype == np.int32
    np.testing.assert_array_equal(one, jax_orders.custom_order(batch[0]))
    np.testing.assert_array_equal(O.custom_order(batch), jax_orders.custom_order(batch))
    np.testing.assert_array_equal(O._custom_order_py(6, 9, batch[1]),
                                  jax_orders._custom_order_py(6, 9, batch[1]))


def test_native_heap_matches_the_python_heap(monkeypatch):
    """native/custom_order.cpp, built by g++ into build/native/, and the
    heapq fallback give the same orders; HOST_ORDER_PATH names the path."""
    dist = _grids(4, 16, 16, seed=7)
    assert O._load_native() is not None
    native = O.custom_order(dist)
    assert O.HOST_ORDER_PATH == "native"
    monkeypatch.setattr(O, "_load_native", lambda: None)
    heap = O.custom_order(dist)
    assert O.HOST_ORDER_PATH == "heap"
    np.testing.assert_array_equal(native, heap)
    for b in range(4):
        np.testing.assert_array_equal(native[b], O._custom_order_py(16, 16, dist[b]))


def test_foreground_mass_center_matches_jax():
    rng = np.random.default_rng(9)
    fg = (rng.random((3, 32, 32)) > 0.6).astype(np.float32)
    fg[1] = 0.0
    got = foreground_mass_center(torch.as_tensor(fg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mass_center(jnp.asarray(fg))))


def _tiny_cfg(W=64):
    cfg = Config()
    cfg.model.W = W
    cfg.model.unet_num_filters = 4
    cfg.model.ngf = 8
    cfg.model.ndf = 8
    cfg.model.vqvae.channel = 16
    cfg.model.vqvae.n_res_channel = 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    cfg.model.lmconv.compute_dtype = "float32"
    return cfg


def test_masks_for_background_backends_agree():
    cfg = _tiny_cfg()
    ps = PixelSynth(cfg, device="cpu")
    rng = np.random.default_rng(1)
    bg = torch.zeros((2, 64, 64), dtype=torch.bool)
    bg[0, :, 40:] = True
    bg[1] = torch.as_tensor(rng.random((64, 64)) > 0.7)
    bg[1, 8:40, 8:24] = True
    calls = D.PLAIN_CALLS["custom_order"]
    dev = ps.masks_for_background(bg)                       # masks_backend "jax"
    assert D.PLAIN_CALLS["custom_order"] == calls + 1
    host = ps.masks_for_background(bg, host=True)
    assert D.PLAIN_CALLS["custom_order"] == calls + 1
    cfg.model.lmconv.masks_backend = "host"
    by_field = ps.masks_for_background(bg)
    again = ps.masks_for_background(bg, host=False)
    assert D.PLAIN_CALLS["custom_order"] == calls + 2
    for a, b, c, d in zip(dev, host, by_field, again):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    cfg.model.lmconv.masks_backend = "triton"
    with pytest.raises(NotImplementedError, match="masks_backend"):
        ps.masks_for_background(bg)


def test_weight_norm_is_not_read():
    """The JAX package reads lmconv.weight_norm nowhere (its only mention
    is config.py:92): the port builds the same PixelCNN with it on, and
    gives the same logits."""
    logits = []
    for weight_norm in (False, True):
        cfg = _tiny_cfg()
        cfg.model.lmconv.weight_norm = weight_norm
        ps = PixelSynth(cfg, device="cpu", seed=3)
        codes = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (2, 8, 8)))
        bg = torch.zeros((2, 64, 64), dtype=torch.bool)
        bg[:, :, 32:] = True
        _, masks, _ = ps.masks_for_background(bg)
        fn = ps.make_sampling_logits_fn(masks)
        logits.append(fn(codes, torch.zeros((2, 8, 8))))
    assert torch.isfinite(logits[0]).all()
    assert torch.equal(logits[0], logits[1])


def _bitonic_desc(keys):
    """csrc/custom_order.cu's sort: the bitonic network over n = 2^k keys,
    pair q of a stage comparing i = 2q - (q & (j - 1)) with i + j,
    descending where i & k is 0."""
    keys = keys.copy()
    n = keys.size
    q = np.arange(n // 2)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            i = 2 * q - (q & (j - 1))
            a, b = keys[i], keys[i + j]
            swap = np.where((i & k) == 0, a < b, a > b)
            keys[i[swap]], keys[i[swap] + j] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return keys


def _counting_ranks(dist):
    """csrc/custom_order.cu's counting sort by d, descending: a histogram
    of hi - d, its exclusive scan, then 32 pixels at a time in index order,
    each taking its value's next rank after the lanes below it with the
    same value (__match_any_sync) -> pixel_of_rank."""
    flat = dist.reshape(-1).astype(np.int64)
    v = flat.max() - flat
    start = np.concatenate([[0], np.cumsum(np.bincount(v))[:-1]])
    pix = np.empty(flat.size, np.int64)
    for p0 in range(0, flat.size, 32):
        vals = v[p0:p0 + 32]
        for lane, val in enumerate(vals):
            pix[start[val] + np.count_nonzero(vals[:lane] == val)] = p0 + lane
        for val in np.unique(vals):
            start[val] += np.count_nonzero(vals == val)
    return pix


def _rank_bitmask_order(dist):
    """The order kernel's design on one (H, W) grid, step for step: rank
    by the counting sort where the span of distances fits the table, else
    by the bitonic sort, each rank's neighbours' ranks as one row, the
    frontier and visited sets as rank-ordered 32-bit words with lane l
    holding words l*K .. l*K + K - 1, the push by the owner lane, the pop
    as ballot (the lowest lane with a non-empty word) -> that lane's lowest
    set rank, the owner clearing its bit.  -> (H*W,) flat order."""
    H, W = dist.shape
    HW = H * W
    n = 1 << max(0, (HW - 1).bit_length())
    scores = dist.reshape(-1).astype(np.int64) * 10000 - np.arange(HW)
    if int(dist.max()) - int(dist.min()) + 1 <= max(n, 2 * HW):   # the table's ints
        pix = _counting_ranks(dist)
    else:
        keys = _bitonic_desc(np.concatenate([scores, np.full(n - HW, np.iinfo(np.int32).min)]))
        assert np.all(np.diff(keys[:HW]) < 0) and np.all(keys[HW:] == np.iinfo(np.int32).min)
        pix = (-keys[:HW]) % 10000
    assert np.all(np.diff(scores[pix]) < 0)
    rank = np.empty(HW, np.int64)
    rank[pix] = np.arange(HW)
    row, col = pix // W, pix % W
    nbr = np.stack([np.where(row > 0, rank[np.maximum(pix - W, 0)], -1),
                    np.where(row < H - 1, rank[np.minimum(pix + W, HW - 1)], -1),
                    np.where(col > 0, rank[np.maximum(pix - 1, 0)], -1),
                    np.where(col < W - 1, rank[np.minimum(pix + 1, HW - 1)], -1)], 1)
    need = -(-(-(-HW // 32)) // 32)
    K = next(k for k in (1, 2, 4, 10) if k >= need)
    F = [[0] * K for _ in range(32)]
    V = [[0] * K for _ in range(32)]
    V[0][0] = 1
    cur, order = 0, [int(pix[0])]
    for _ in range(1, HW):
        for q in nbr[cur]:
            if q < 0:
                continue
            lane, i = divmod(int(q) >> 5, K)
            bit = 1 << (int(q) & 31)
            if not V[lane][i] & bit:
                V[lane][i] |= bit
                F[lane][i] |= bit
        L = next(lane for lane in range(32) if any(F[lane]))   # ballot, __ffs
        i = next(i for i in range(K) if F[L][i])
        cur = ((L * K + i) << 5) | ((F[L][i] & -F[L][i]).bit_length() - 1)   # shuffle
        F[L][i] &= F[L][i] - 1
        order.append(int(pix[cur]))
    return np.asarray(order)


@pytest.mark.parametrize("B,H,W,span", [(2, 32, 32, 0), (2, 16, 16, 0), (1, 40, 48, 0),
                                        (1, 64, 64, 0), (1, 1, 1, 0), (1, 3, 1, 0),
                                        (2, 16, 16, 3000)])
def test_rank_bitmask_design_matches_jax_and_the_heap(B, H, W, span):
    """The redesigned order kernel's arithmetic (csrc/custom_order.cu),
    emulated: bit-equal to custom_order_jax, the host heap and the plain
    version on grids with ties, one word a lane (32x32, 16x16: lanes left
    empty), two (40x48, non-square) and four (64x64), and 1-pixel-wide
    grids, ranked by the counting sort; and, by the bitonic sort, grids
    whose distances span more values than its table holds (3x1, and 16x16
    with a span of 6001)."""
    dist = _grids(B, H, W, seed=H * W)
    if span:
        dist = np.random.default_rng(span).integers(-span, span + 1, (B, H, W)).astype(np.int32)
    got = np.stack([_rank_bitmask_order(d) for d in dist])
    np.testing.assert_array_equal(got, np.asarray(custom_order_jax(jnp.asarray(dist))))
    np.testing.assert_array_equal(got, O.custom_order_flat(dist))
    np.testing.assert_array_equal(got, D.custom_order_plain(torch.as_tensor(dist)).numpy())
