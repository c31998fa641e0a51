"""K1: the port's fused PixelCNN forward (plain version on the CPU) against
the JAX fused forward (Pallas kernels in interpret mode), same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops.lmconv_fused import make_fused_logits_fn as jax_fused_fn
from pixelsynth_tpu.ops.orders import custom_order, masks_for_orders_batch
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops import lmconv_fused as K1
from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
from pixelsynth_tpu_torch.weights import unflatten_tree
from torch_threads import _few_torch_threads  # noqa: F401

B, H, W, NC, F = 2, 8, 8, 16, 16


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    dist = rng.integers(-10, 10, (B, H, W)).astype(np.int32)
    a, b, d = masks_for_orders_batch(list(custom_order(dist)), H, W, 3, 2)
    masks = np.stack([a, b, d], 1).astype(np.float32)
    codes = rng.integers(0, NC, (B, H, W)).astype(np.int32)
    filled = (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)
    # one set of Flax-named weights (the LMPixelCNN tree) for both sides.
    # The skip stack is bf16 even at f32 compute: the two frameworks' f32
    # sums differ in the last bit, and where one straddles a bf16 rounding
    # boundary a stack entry differs by one bf16 ulp, which moves logits by
    # up to ~1e-3 (seen on other seeds).  This seed has no such straddle,
    # so it holds the f32 arithmetic itself to 1e-4.
    cfg = Config()
    cfg.model.lmconv.nr_filters = F
    cfg.model.lmconv.input_channels = cfg.model.lmconv.num_classes = NC
    params = random_pixelcnn_params(cfg, torch.Generator().manual_seed(0))
    vs = {"params": unflatten_tree({k: jnp.asarray(v.numpy())
                                    for k, v in params.items()})}
    pos = rng.integers(0, H * W, (B, 5)).astype(np.int32)
    return vs, params, masks, codes, filled, pos


def _port_fn(params, masks, compute_dtype):
    packed = K1.pack_lmconv_params(params, nr_resnet=2,
                                   compute_dtype=compute_dtype)
    return K1.make_fused_logits_fn(packed, torch.as_tensor(masks), nr_resnet=2,
                                   max_dilation=2, num_classes=NC,
                                   compute_dtype=compute_dtype)


def test_plain_fused_matches_jax_f32(setup):
    vs, params, masks, codes, filled, pos = setup
    want_fn = jax_fused_fn(vs, jnp.asarray(masks), nr_resnet=2, max_dilation=2,
                           num_classes=NC, compute_dtype="float32")
    fn = _port_fn(params, masks, "float32")
    ct, ft = torch.as_tensor(codes), torch.as_tensor(filled)
    want = np.asarray(want_fn(jnp.asarray(codes), jnp.asarray(filled)))
    got = fn(ct, ft).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # .at (elu + nin on the gathered rows only) against the JAX rows
    want_at = np.take_along_axis(want.reshape(B, H * W, NC), pos[..., None],
                                 axis=1)
    got_at = fn.at(ct, ft, torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(got_at, want_at, atol=1e-4, rtol=0)
    got_one = fn.at(ct, ft, torch.as_tensor(pos[:, 0])).numpy()
    np.testing.assert_allclose(got_one, got_at[:, 0], atol=1e-6, rtol=0)


def test_plain_fused_matches_jax_bf16(setup):
    vs, params, masks, codes, filled, _ = setup
    want_fn = jax_fused_fn(vs, jnp.asarray(masks), nr_resnet=2, max_dilation=2,
                           num_classes=NC, compute_dtype="bfloat16")
    want = np.asarray(want_fn(jnp.asarray(codes), jnp.asarray(filled)))
    got = _port_fn(params, masks, "bfloat16")(
        torch.as_tensor(codes), torch.as_tensor(filled)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.97, f"argmax agreement {agree}"


def test_wrappers_take_plain_version_on_cpu(setup):
    _, params, masks, codes, filled, _ = setup
    packed = K1.pack_lmconv_params(params, nr_resnet=2, compute_dtype="bfloat16")
    m = torch.as_tensor(masks)
    mu = K1.fold_boundary_masks(m[:, 1], H, W, 3, 1)
    md = K1.fold_boundary_masks(m[:, 2], H, W, 3, 2)
    u0 = K1.embed_input(packed, torch.as_tensor(codes), torch.as_tensor(filled),
                        m[:, 0], num_classes=NC)
    before = dict(K1.LAUNCHES)
    kw = dict(H=H, W=W, nr=2, dilation=2, compute_dtype="bfloat16")
    stack = K1.up(u0, mu, md, packed, **kw)
    assert stack.dtype == torch.bfloat16 and stack.shape == (B, 9, H * W, F)
    torch.testing.assert_close(
        stack, K1.up_plain(u0, mu, md, packed, W=W, nr=2, dilation=2,
                           compute_dtype="bfloat16"), rtol=0, atol=0)
    out = K1.down(stack, mu, md, packed, **kw)
    assert out.dtype == torch.float32 and out.shape == (B, H * W, F)
    assert K1.LAUNCHES == before        # no kernel launch on the CPU
    # the folded masks zero every tap that leaves the image
    assert not mu[:, 0, 0].any() and not md[:, W + 1, 0].any()
