"""The port's `LMPixelCNN` module and per-layer kernel engine against the
Flax module, with weights bridged from a Flax `init`; and the port's three
engines (the fused forward's plain version, the module, the per-layer
engine) against each other from one parameter set.  Size and tolerances of
tests/test_lmconv_fast.py (B 2, 8x8, 16 filters, 16 classes; atol 3e-4,
rtol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.models.lmconv import LMPixelCNN as JaxLMPixelCNN
from pixelsynth_tpu.models.lmconv_fast import pixelcnn_forward_fast as jax_fast
from pixelsynth_tpu.ops.orders import custom_order, masks_for_orders_batch
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN, flax_named_params
from pixelsynth_tpu_torch.models.lmconv_fast import (
    fast_logits_fn, pixelcnn_forward_fast,
)
from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4
from pixelsynth_tpu_torch.ops import lmconv_fused as K1
from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
from torch_threads import _few_torch_threads  # noqa: F401

B, H, W, NC, F = 2, 8, 8, 16, 16
TOL = dict(atol=3e-4, rtol=1e-3)


def _data(seed):
    rng = np.random.default_rng(seed)
    dist = rng.integers(-10, 10, (B, H, W)).astype(np.int32)
    a, b, d = masks_for_orders_batch(list(custom_order(dist)), H, W, 3, 2)
    masks = np.stack([a, b, d], 1).astype(np.float32)
    codes = rng.integers(0, NC, (B, H, W)).astype(np.int32)
    filled = (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)
    return masks, codes, filled


def _flax(seed, **kw):
    masks, codes, filled = _data(seed)
    model = JaxLMPixelCNN(nr_resnet=2, nr_filters=F, input_channels=NC,
                          num_classes=NC, **kw)
    m = jnp.asarray(masks)
    oh = jax.nn.one_hot(jnp.asarray(codes), NC) * jnp.asarray(filled)[..., None]
    vs = model.init({"params": jax.random.PRNGKey(seed)}, oh, m[:, 0], m[:, 1],
                    m[:, 2], train=False)
    want = model.apply(vs, oh, m[:, 0], m[:, 1], m[:, 2], train=False)
    return vs, np.asarray(want), np.array(oh), masks, codes, filled


def _port(vs, backend="xla", **kw):
    model = LMPixelCNN(nr_resnet=2, nr_filters=F, input_channels=NC,
                       num_classes=NC, backend=backend, **kw)
    with torch.no_grad():
        model.load_flax(jax.device_get(vs["params"]))
    return model.eval()


@pytest.mark.parametrize("feature_norm", ["pono", "order_rescale"])
@pytest.mark.parametrize("conv_mask_weight", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_module_matches_flax(feature_norm, conv_mask_weight, backend):
    kw = dict(feature_norm=feature_norm, conv_mask_weight=conv_mask_weight)
    vs, want, oh, masks, codes, filled = _flax(0, **kw)
    model = _port(vs, backend, compute_dtype="float32", **kw)
    m = torch.as_tensor(masks)
    with torch.no_grad():
        got_x = model(torch.as_tensor(oh), m[:, 0], m[:, 1], m[:, 2])
        before = K3.PLAIN_CALLS["masked_conv"]
        got_c = model(None, m[:, 0], m[:, 1], m[:, 2],
                      codes=torch.as_tensor(codes), filled=torch.as_tensor(filled))
    # "pallas" puts every masked conv (28 + 4) through K3's wrapper, with or
    # without the mask_weight term; "xla" none
    assert (K3.PLAIN_CALLS["masked_conv"] - before
            == (32 if backend == "pallas" else 0))
    np.testing.assert_allclose(got_x.numpy(), want, **TOL)   # one-hot path
    # codes path: the embedding-gather first layer has no mask_weight term
    # (in either package), so with conv_mask_weight it is held to Flax's own
    # codes path
    if conv_mask_weight:
        jm = JaxLMPixelCNN(nr_resnet=2, nr_filters=F, input_channels=NC,
                           num_classes=NC, **kw)
        mj = jnp.asarray(masks)
        want = np.asarray(jm.apply(vs, None, mj[:, 0], mj[:, 1], mj[:, 2],
                                   codes=jnp.asarray(codes),
                                   filled=jnp.asarray(filled), train=False))
    np.testing.assert_allclose(got_c.numpy(), want, **TOL)


def test_module_state_dict_round_trips_flax_names():
    vs, *_ = _flax(0)
    model = _port(vs)
    flat = flax_named_params(model)
    tree = jax.device_get(vs["params"])
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(flat) == n_leaves == len(model.state_dict())
    np.testing.assert_array_equal(
        flat["GatedResnet_7/Nin_0/Dense_0/kernel"].numpy(),
        tree["GatedResnet_7"]["Nin_0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(flat["LMConv_3/weight"].numpy(),
                                  tree["LMConv_3"]["weight"])
    other = LMPixelCNN(nr_resnet=2, nr_filters=F, input_channels=NC, num_classes=NC)
    other.load_state_dict(model.state_dict())


def test_module_random_init_bias_not_zero():
    model = LMPixelCNN(nr_resnet=1, nr_filters=F, input_channels=NC, num_classes=NC)
    with torch.no_grad():
        model.reset(torch.Generator().manual_seed(0))
    conv = model.GatedResnet_0.LMConv_0
    bound = 1.0 / np.sqrt(2 * F * 9)
    assert float(conv.bias.abs().max()) > 0 and float(conv.bias.abs().max()) <= bound
    assert float(conv.weight.abs().max()) <= bound


def test_fast_engine_matches_jax():
    vs, want, _, masks, codes, filled = _flax(0)
    m = jnp.asarray(masks)
    want_fast = jax_fast(vs["params"], jnp.asarray(codes), jnp.asarray(filled),
                         m[:, 0], m[:, 1], m[:, 2], nr_resnet=2, max_dilation=2,
                         num_classes=NC, compute_dtype="float32")
    params = flax_named_params(_port(vs))
    mt = torch.as_tensor(masks)
    before = (K4.PLAIN_CALLS["gated_resnet"], K3.PLAIN_CALLS["masked_conv"])
    got = pixelcnn_forward_fast(params, torch.as_tensor(codes),
                                torch.as_tensor(filled), mt[:, 0], mt[:, 1],
                                mt[:, 2], nr_resnet=2, max_dilation=2,
                                num_classes=NC, compute_dtype="float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fast), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # 14 gated resnets through K4's wrapper, 4 dilated convs through K3's
    assert K4.PLAIN_CALLS["gated_resnet"] - before[0] == 14
    assert K3.PLAIN_CALLS["masked_conv"] - before[1] == 4


def test_three_engines_agree_from_one_parameter_set():
    vs, want, _, masks, codes, filled = _flax(1)
    model = _port(vs, "pallas", compute_dtype="float32")
    params = flax_named_params(model)
    mt, ct, ft = (torch.as_tensor(a) for a in (masks, codes, filled))
    before = K3.PLAIN_CALLS["masked_conv"]
    with torch.no_grad():
        module = model(None, mt[:, 0], mt[:, 1], mt[:, 2], codes=ct, filled=ft)
    assert K3.PLAIN_CALLS["masked_conv"] - before == 32   # 28 + 4 masked convs
    fast = fast_logits_fn(params, mt, model)(ct, ft)
    packed = K1.pack_lmconv_params(params, nr_resnet=2, compute_dtype="float32")
    fused = K1.make_fused_logits_fn(packed, mt, nr_resnet=2, max_dilation=2,
                                    num_classes=NC, compute_dtype="float32")(ct, ft)
    np.testing.assert_allclose(module.numpy(), want, **TOL)
    np.testing.assert_allclose(fast.numpy(), module.numpy(), **TOL)
    # the fused forward rounds its skip stack to bf16 even at f32 compute:
    # the tolerance of tests/test_lmconv_fast.py:67 for it
    np.testing.assert_allclose(fused.numpy(), module.numpy(), atol=2e-2, rtol=1e-2)


def test_fast_engine_bf16_argmax_agreement():
    vs, want, _, masks, codes, filled = _flax(1)
    model = _port(vs, compute_dtype="bfloat16")
    mt, ct, ft = (torch.as_tensor(a) for a in (masks, codes, filled))
    got = fast_logits_fn(flax_named_params(model), mt, model)(ct, ft).numpy()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > 0.97, f"argmax agreement {agree}"
