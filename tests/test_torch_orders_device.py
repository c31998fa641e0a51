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
