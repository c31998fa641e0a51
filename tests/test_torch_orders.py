"""Generation orders, kernel masks and the distance field: the port (host
heap + device masks) against the JAX package, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops.distance_transform import signed_distance_field as jax_sdf
from pixelsynth_tpu.ops.orders_jax import orders_and_masks_jax
from pixelsynth_tpu.pipeline import binarize_trunc as jax_bin
from pixelsynth_tpu.pipeline import downsample_mask as jax_ds
from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
from pixelsynth_tpu_torch.pipeline import binarize_trunc, downsample_mask
from torch_threads import _few_torch_threads  # noqa: F401


def _background(B=2, W=128, seed=0):
    """Blobby background masks: a rotated-view-like band plus random discs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:W, :W]
    bg = np.zeros((B, W, W), bool)
    for b in range(B):
        bg[b, :, W - W // (3 + b):] = True
        for _ in range(4):
            cy, cx, r = rng.integers(0, W, 2).tolist() + [int(rng.integers(6, 20))]
            bg[b] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return bg


@pytest.mark.parametrize("dt_mode", ["exact", "chamfer"])
def test_orders_masks_distances_bit_exact(dt_mode):
    bg = _background()
    fg_ds, bg_ds = jax_ds(jnp.asarray(~bg)), jax_ds(jnp.asarray(bg))
    want_dist = np.asarray(jax_sdf(jax_bin(fg_ds), jax_bin(bg_ds), mode=dt_mode))

    tbg = torch.as_tensor(bg)
    tfg_ds, tbg_ds = downsample_mask(~tbg), downsample_mask(tbg)
    np.testing.assert_array_equal(tbg_ds.numpy(), np.asarray(bg_ds))
    dist = signed_distance_field(binarize_trunc(tfg_ds), binarize_trunc(tbg_ds),
                                 mode=dt_mode)
    np.testing.assert_array_equal(dist.numpy(), want_dist)

    want_order, want_masks = orders_and_masks_jax(jnp.asarray(want_dist), 3, 2)
    order, masks = orders_and_masks(dist, 3, 2)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want_masks))
    assert masks.dtype == torch.float32 and masks.shape == (2, 3, 9, 256)
