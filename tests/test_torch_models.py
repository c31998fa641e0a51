"""The view step's networks through the weight bridge: the port's modules
against the Flax modules on one tiny config, and the stitched checkpoint's
load."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.models.classifier import ResNet18 as JaxResNet18
from pixelsynth_tpu.models.classifier import (
    preprocess_for_classifier as jax_preprocess,
)
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.classifier import preprocess_for_classifier
from pixelsynth_tpu_torch.models.layers import concat_elu, pono
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.weights import (
    flatten_tree, from_jax_params, load_stitched_npz,
)
from torch_threads import _few_torch_threads  # noqa: F401

W = 32
STITCHED = os.path.join(os.path.dirname(__file__), "..", "evidence", "relay",
                        "stitched.npz")


def tiny(cfg):
    cfg.model.W = W
    cfg.model.unet_num_filters = 4
    cfg.model.ngf = 8
    cfg.model.ndf = 8
    cfg.model.vqvae.channel = 16
    cfg.model.vqvae.n_res_channel = 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    return cfg


def _fill(tree, rng, name=""):
    """Random values for a Flax variable tree of shapes (jax.eval_shape of
    init: no compile): conv/dense kernels ~ N(0, 1/fan_in), positive BN
    variances and scales, nonzero BN means, random spectral vectors."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, k) for k, v in tree.items()}
    shape = tree.shape
    if name in ("var", "stored_var", "scale", "gain"):
        x = rng.uniform(0.5, 1.5, shape)
    elif name in ("mean", "stored_mean", "bias"):
        x = rng.normal(0, 0.3, shape)
    elif name in ("kernel", "gain_kernel", "bias_kernel"):
        x = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ("u", "v") or name.startswith(("u_", "v_")):
        x = rng.normal(0, 1, shape)
        x = x / np.linalg.norm(x)           # unit spectral vectors
    else:                                   # embed, ...
        x = rng.normal(0, 1, shape)
    return jnp.asarray(x.astype(np.float32))


def _converge_spectral(variables):
    """Give every stored spectral pair the top singular vectors of its
    weight, as the JAX init's power iteration does (layers.py:53-63).
    Random unit vectors would divide by a sigma far below the largest
    singular value and blow activations up to ~1e4, where the two
    frameworks' f32 rounding no longer agrees to 1e-5."""
    kernel_of = {"v": "kernel", "v_gain": "gain_kernel", "v_bias": "bias_kernel"}

    def walk(stats, params):
        out = {}
        for k, val in stats.items():
            if isinstance(val, dict):
                out[k] = walk(val, params[k])
            elif k in kernel_of:
                w = np.asarray(params[kernel_of[k]], np.float64)
                mat = w.reshape(-1, w.shape[-1])
                U, _, Vt = np.linalg.svd(mat, full_matrices=False)
                out[k] = jnp.asarray(U[:, 0].astype(np.float32))
                out["u" + k[1:]] = jnp.asarray(Vt[0].astype(np.float32))
            elif k not in out:
                out[k] = val
        return out

    return {tree: ({**v, "spectral_stats": walk(v["spectral_stats"], v["params"])}
                   if "spectral_stats" in v else v)
            for tree, v in variables.items()}


@pytest.fixture(scope="module")
def nets():
    jps = JaxPixelSynth(tiny(JaxConfig()))
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(-1, 1, (2, W, W, 3)).astype(np.float32))
    mask = jnp.asarray(rng.random((2, W, W)) < 0.4)
    k = jax.random.split(jax.random.PRNGKey(0), 5)
    cls = JaxResNet18(num_classes=10)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k[0]}, img,
                                                     train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k[1], "noise": k[1]}, img, mask, train=False)),
        "vqvae": jax.eval_shape(lambda: jps.vqvae.init({"params": k[2]}, img,
                                                       train=False)),
        "disc": jax.eval_shape(lambda: jps.disc.init({"params": k[3]}, img,
                                                     train=False)),
        "classifier": jax.eval_shape(lambda: cls.init(
            k[4], jnp.zeros((1, 224, 224, 3)))),
    }
    variables = _converge_spectral(_fill(shapes, rng))
    ps = PixelSynth(tiny(Config()), device="cpu",
                    state_dicts=from_jax_params(variables, tiny(Config())))
    return jps, cls, variables, ps, np.array(img), np.array(mask)


def test_unet_depth(nets):
    jps, _, v, ps, img, _ = nets
    want, _ = jps.regress_depth(v["unet"], jnp.asarray(img))
    got = ps.regress_depth(torch.as_tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_vqvae_codes_and_decode(nets):
    jps, _, v, ps, img, _ = nets
    want_codes, _ = jps.vq_encode(v["vqvae"], jnp.asarray(img))
    codes = ps.vq_encode(torch.as_tensor(img))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    want = jps.vq_decode(v["vqvae"], want_codes)
    got = ps.vq_decode(codes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_refinement_decoder_zero_noise(nets):
    jps, _, v, ps, img, mask = nets
    want, _ = jps.decode_image(v["projector"], jnp.asarray(img), jnp.asarray(mask),
                               noise_scale=0.0)
    got = ps.decode_image(torch.as_tensor(img), torch.as_tensor(mask),
                          noise_scale=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_discriminator(nets):
    jps, _, v, ps, img, _ = nets
    want = jps.disc.apply(v["disc"], jnp.asarray(img), train=False)
    got = ps.disc(torch.as_tensor(img))
    for ws, gs in zip(want, got):
        for w, g in zip(ws, gs):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_classifier(nets):
    _, cls, v, ps, img, _ = nets
    x01 = img * 0.5 + 0.5
    want_in = np.array(jax_preprocess(jnp.asarray(x01)))
    got_in = preprocess_for_classifier(torch.as_tensor(x01))
    np.testing.assert_allclose(got_in.numpy(), want_in, atol=1e-5, rtol=1e-5)
    want = cls.apply(v["classifier"], jnp.asarray(want_in))
    got = ps.classifier(torch.as_tensor(want_in))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_lmconv_primitives():
    """The module path's concat_elu (jax.nn.elu) and two-pass pono."""
    from pixelsynth_tpu.models.layers import concat_elu as jax_concat_elu
    from pixelsynth_tpu.models.layers import pono as jax_pono

    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(concat_elu(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_concat_elu(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(pono(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_pono(jnp.asarray(x))), atol=1e-5)


def test_stitched_checkpoint_round_trip():
    """Every key of the stitched npz comes back (fp16 widened to f32), the
    config round-trips, and every tree loads into the port's modules."""
    cfg, variables, meta = load_stitched_npz(STITCHED)
    flat = flatten_tree(variables)
    with np.load(STITCHED) as raw:
        keys = {k for k in raw.files if not k.startswith("__")}
        assert set(flat) == keys
        for k in ("unet/params/SNConv_0/kernel", "pixelcnn/params/LMConv_0/weight"):
            np.testing.assert_array_equal(flat[k], raw[k].astype(np.float32))
    assert Config.from_json(cfg.to_json()).to_dict() == cfg.to_dict()
    assert cfg.override(**{"sample.temperature": 0.5}).sample.temperature == 0.5
    with pytest.raises(KeyError):
        cfg.override(**{"sample.no_such_knob": 1})
    assert cfg.model.W == 128 and cfg.sample.speculative == 3
    cfg.refresh_splat_perf_knobs()
    assert (cfg.model.splat.max_points_per_tile, cfg.model.splat.tile_group,
            cfg.sample.speculative) == (1024, 16, 12)
    sd = from_jax_params(variables, cfg)
    assert set(sd) == {"unet", "projector", "vqvae", "disc", "classifier", "pixelcnn"}
    # conv HWIO -> OIHW with the spectral norm folded (sigma = |mat^T v|)
    k = flat["unet/params/SNConv_0/kernel"]
    sigma = np.linalg.norm(k.reshape(-1, k.shape[-1]).T
                           @ flat["unet/spectral_stats/SNConv_0/v"])
    np.testing.assert_allclose(sd["unet"]["SNConv_0.weight"].numpy(),
                               k.transpose(3, 2, 0, 1) / sigma, rtol=1e-5, atol=1e-7)
    assert sd["classifier"]["Dense_0.weight"].shape == (32, 512)
    assert len(sd["pixelcnn"]) == len(flatten_tree(variables["pixelcnn"]["params"]))
