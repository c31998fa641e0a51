"""K2 and the splat around it: the port's binning (bit-equal) and plain
blend against the JAX splat."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.ops.splat import _bin_points_batched as jax_bin
from pixelsynth_tpu.ops.splat import splat as jax_splat
from pixelsynth_tpu_torch.config import SplatConfig
from pixelsynth_tpu_torch.ops import splat as K2


def _points(B=2, N=600, W=32, C=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, W + 5, (B, N)), rng.uniform(-6, W + 5, (B, N)),
                    rng.uniform(0.5, 10.0, (B, N))], -1).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    return pts, feats, valid


def _cfgs(**kw):
    kw = dict(max_points_per_tile=128, tile_size=16, tile_group=4,
              background_smoothing_kernel_size=5, **kw)
    return SplatConfig(**kw), JaxSplatConfig(**kw)


def test_binning_bit_equal():
    pts, _, valid = _points()
    cfg, jcfg = _cfgs()
    want_idx, want_valid = jax_bin(jnp.asarray(pts), jnp.asarray(valid), 32, jcfg)
    idx, slot_valid = K2._bin_points_batched(torch.as_tensor(pts),
                                             torch.as_tensor(valid), 32, cfg)
    np.testing.assert_array_equal(slot_valid.numpy(), np.asarray(want_valid))
    # invalid slots hold whatever the clipped gather read; compare valid ones
    np.testing.assert_array_equal(np.where(want_valid, idx.numpy(), -1),
                                  np.where(want_valid, np.asarray(want_idx), -1))


@pytest.mark.parametrize("accumulation", ["alphacomposite", "wsum", "wsumnorm"])
def test_plain_splat_matches_jax(accumulation):
    pts, feats, valid = _points(N=120, seed=1)
    cfg, jcfg = _cfgs(accumulation=accumulation)
    want, bg_want = jax_splat(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(valid), W=32, cfg=jcfg)
    got, bg = K2.splat(torch.as_tensor(pts), torch.as_tensor(feats),
                       torch.as_tensor(valid), W=32, cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_want))
    assert bg.any() and not bg.all()
    # the dense O(W^2 N) oracle agrees with the binned path
    dense, bg_dense = K2.splat_dense(torch.as_tensor(pts), torch.as_tensor(feats),
                                     torch.as_tensor(valid), W=32, cfg=cfg)
    np.testing.assert_allclose(dense.numpy(), got.numpy(), atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(bg_dense.numpy(), bg.numpy())


def test_k_cap():
    """pp_pixel=1 keeps only the nearest covering point of a pixel."""
    W = 32
    pts = torch.tensor([[[16.0, 16.0, 5.0], [16.0, 16.0, 1.0]]])
    feats = torch.tensor([[[1.0], [2.0]]])
    cfg1, jcfg1 = _cfgs(accumulation="wsum", pp_pixel=1)
    cfg2 = dataclasses.replace(cfg1, pp_pixel=2)
    out1, _ = K2.splat(pts, feats, W=W, cfg=cfg1)
    out2, _ = K2.splat(pts, feats, W=W, cfg=cfg2)
    want1, _ = jax_splat(jnp.asarray(pts.numpy()), jnp.asarray(feats.numpy()),
                         W=W, cfg=jcfg1)
    np.testing.assert_allclose(out1.numpy(), np.asarray(want1), atol=1e-6)
    # the near point (depth 1, feature 2) alone at pp_pixel=1, both at 2
    assert abs(float(out1[0, 16, 16, 0]) - 2.0 * float(out2[0, 16, 16, 0]) / 3.0) < 1e-5


def test_blend_wrapper_counts_no_launch_on_cpu():
    pts, feats, valid = _points(B=1, N=200)
    cfg, _ = _cfgs()
    before = dict(K2.LAUNCHES)
    idx, sv = K2._bin_points_batched(torch.as_tensor(pts), torch.as_tensor(valid),
                                     32, cfg)
    out, cov = K2.blend_slots(torch.as_tensor(pts), torch.as_tensor(feats), idx, sv,
                              32, cfg)
    assert out.shape == (1, 32, 32, 3) and cov.dtype == torch.bool
    assert cov.shape == (1, 32, 32)
    assert K2.LAUNCHES == before


@pytest.mark.parametrize("accumulation", ["alphacomposite", "wsum", "wsumnorm"])
def test_blend_slots_matches_jax_splat(accumulation):
    """K2's entry on CPU tensors (its plain version: the slot gather, then
    the tile blend) from the binner's tables, against the JAX splat at
    W = 32: fp32 both sides, summed in other orders (atol 5e-4, rtol
    1e-3, as the card's check); the background masks equal."""
    pts, feats, valid = _points(N=100, seed=2)
    cfg, jcfg = _cfgs(accumulation=accumulation)
    want, bg_want = jax_splat(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(valid), W=32, cfg=jcfg)
    p, f, v = (torch.as_tensor(a) for a in (pts, feats, valid))
    idx, sv = K2._bin_dispatch(p, v, 32, cfg)
    out, cov = K2.blend_slots(p, f, idx, sv, 32, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    bg = K2.dilate_mask(~cov, cfg.background_smoothing_kernel_size)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_want))
    assert cov.any() and not cov.all()
