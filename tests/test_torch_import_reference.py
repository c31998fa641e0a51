"""The reference-checkpoint importer (tools/import_reference_ckpt.py) against
the JAX package's: each converter is given one reference-layout state dict
(torch tensors from a numpy seed, tests/torch_reference_dicts.py: OIHW
kernels, weight-norm weight_g/weight_v, spectral-norm
weight_orig/weight_u/weight_v, BN running stats), the JAX converter maps it onto a Flax tree that
`weights.from_jax_params` (or `from_jax_module`) carries into the port,
and the port's converter maps it straight onto the port's module.  The two
state dicts must be equal, key for key and bit for bit: both are
transposes, reshapes and the same float32 operations on the same numbers.
The JAX converter checks every leaf's shape against a fresh Flax tree, so
a wrongly built dict fails there, whatever the port does.  Then one
forward of each model loaded from the port's dict against the JAX model
on the JAX-converted variables, at the tolerances of the existing module
tests (tests/test_torch_models.py, test_torch_lmconv_module.py,
test_torch_vqvae2.py, test_torch_encoder.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.models.encoderdecoder import get_resnet_arch
from pixelsynth_tpu.models.lmconv import LMPixelCNN as JaxLMPixelCNN
from pixelsynth_tpu.models.vqvae import VQVAE as JaxVQVAE
from pixelsynth_tpu.ops.orders import custom_order, masks_for_orders_batch
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.tools import import_reference_ckpt as jimp
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN
from pixelsynth_tpu_torch.models.vqvae import VQVAE
from pixelsynth_tpu_torch.pipeline import PixelSynth, build_modules
from pixelsynth_tpu_torch.tools import import_reference_ckpt as imp
from pixelsynth_tpu_torch.weights import from_jax_module, from_jax_params
from test_torch_models import tiny
from torch_reference_dicts import random_reference_state_dict
from torch_threads import _few_torch_threads  # noqa: F401

W = 32


def _zeros(shapes):
    """A Flax variable tree of zeros in the shapes of jax.eval_shape."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def assert_equal_state_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


# ---------------------------------------------------------------------------
# the view step's trees at the tiny config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """Zero Flax templates of the tiny config's unet, projector, vqvae and
    disc, and the reference-layout state dicts of each, built from the
    port's serving modules' shapes."""
    jcfg, cfg = tiny(JaxConfig()), tiny(Config())
    jps = JaxPixelSynth(jcfg)
    img = jnp.zeros((1, W, W, 3))
    k = jax.random.PRNGKey(0)
    templates = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, img, train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, img, jnp.zeros((1, W, W), bool), train=False)),
        "vqvae": jax.eval_shape(lambda: jps.vqvae.init({"params": k}, img, train=False)),
        "disc": jax.eval_shape(lambda: jps.disc.init({"params": k}, img, train=False)),
    }
    templates = {n: _zeros(t) for n, t in templates.items()}
    mods = build_modules(cfg)
    plans = {"unet": imp.plan_unet(mods["unet"].levels),
             "projector": imp.plan_resnet_blocks(mods["projector"], "eblocks"),
             "vqvae": imp.plan_vqvae(cfg.model.vqvae.n_res_block),
             "disc": imp.plan_discriminator()}
    rng = np.random.default_rng(0)
    refs = {n: random_reference_state_dict(p, mods[n], rng) for n, p in plans.items()}
    return jcfg, cfg, jps, templates, refs


def _jax_convert(name, sd, template, jcfg):
    mc = jcfg.model
    if name == "unet":
        return jimp.convert_unet(sd, template, levels=int(np.log2(mc.W)))
    if name == "projector":
        arch = get_resnet_arch(mc.refine_model_type, mc.ngf)
        return jimp.convert_resnet_decoder(sd, template, arch, channels_in=4)
    if name == "vqvae":
        return jimp.convert_vqvae(sd, template, n_res_block=mc.vqvae.n_res_block)
    return jimp.convert_discriminator(sd, template)


PORT_CONVERT = {"unet": imp.convert_unet, "projector": imp.convert_resnet_decoder,
                "vqvae": imp.convert_vqvae, "disc": imp.convert_discriminator}


# the VQ-VAE has one build (no spectral norm, no trainer state)
@pytest.mark.parametrize("name,trainable", [
    ("unet", False), ("unet", True), ("projector", False), ("projector", True),
    ("vqvae", False), ("disc", False), ("disc", True)])
def test_converter_equals_jax_through_from_jax_params(trees, name, trainable):
    """The serving build folds each spectral norm by |mat^T v| with the
    permuted v; the trainable build keeps weight_orig with u and v."""
    jcfg, cfg, _, templates, refs = trees
    jvars = _jax_convert(name, refs[name], templates[name], jcfg)
    want = from_jax_params({name: jvars}, cfg, trainable=trainable)[name]
    module = build_modules(cfg, trainable=trainable)[name]
    got = PORT_CONVERT[name](refs[name], module)
    assert_equal_state_dicts(got, want)


def test_converted_view_networks_match_jax(trees):
    """The U-Net's depth, the VQ-VAE's codes and decode, the refinement
    decoder at zero noise and the discriminator, from the port's converted
    dicts, against the JAX models on the JAX-converted variables."""
    jcfg, cfg, jps, templates, refs = trees
    mods = build_modules(cfg)
    sds = {n: PORT_CONVERT[n](refs[n], mods[n]) for n in refs}
    jv = {n: _jax_convert(n, refs[n], templates[n], jcfg) for n in refs}
    ps = PixelSynth(cfg, device="cpu", state_dicts=sds)
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, W, W, 3)).astype(np.float32)
    mask = rng.random((2, W, W)) < 0.4
    want, _ = jps.regress_depth(jv["unet"], jnp.asarray(img))
    np.testing.assert_allclose(ps.regress_depth(torch.as_tensor(img)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    want_codes, _ = jps.vq_encode(jv["vqvae"], jnp.asarray(img))
    codes = ps.vq_encode(torch.as_tensor(img))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(ps.vq_decode(codes).numpy(),
                               np.asarray(jps.vq_decode(jv["vqvae"], want_codes)),
                               atol=1e-5, rtol=1e-4)
    want, _ = jps.decode_image(jv["projector"], jnp.asarray(img), jnp.asarray(mask),
                               noise_scale=0.0)
    got = ps.decode_image(torch.as_tensor(img), torch.as_tensor(mask), noise_scale=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    want = jps.disc.apply(jv["disc"], jnp.asarray(img), train=False)
    got = ps.disc(torch.as_tensor(img))
    for ws, gs in zip(want, got):
        for w, g in zip(ws, gs):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_converter_refuses_a_wrong_shape_and_a_missing_key(trees):
    _, cfg, _, _, refs = trees
    module = build_modules(cfg)["unet"]
    bad = dict(refs["unet"])
    bad["conv1.bias"] = torch.zeros(bad["conv1.bias"].shape[0] + 1)
    with pytest.raises(ValueError, match="shape mismatch at SNConv_0.bias"):
        imp.convert_unet(bad, module)
    bad = dict(refs["unet"])
    del bad["batch_norm2_0.running_var"]
    with pytest.raises(KeyError, match="batch_norm2_0.running_var"):
        imp.convert_unet(bad, module)


# ---------------------------------------------------------------------------
# the encoder, the two-level VQ-VAE and the PixelCNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trainable", [False, True], ids=["serving", "trainable"])
def test_resnet_encoder_equals_jax(trainable):
    from pixelsynth_tpu_torch.models.encoderdecoder import ResNetEncoder

    jcfg, cfg = tiny(JaxConfig()), tiny(Config())
    for c in (jcfg, cfg):
        c.model.use_rgb_features, c.model.predict_residual = False, False
    jps = JaxPixelSynth(jcfg)
    k = jax.random.PRNGKey(0)
    img = jnp.zeros((1, W, W, 3))
    template = _zeros(jax.eval_shape(lambda: jps.encoder.init(
        {"params": k, "noise": k}, img, train=False)))
    mc = cfg.model

    def module():
        return ResNetEncoder(mc.refine_model_type, mc.ngf, True, trainable=trainable)

    ref = random_reference_state_dict(imp.plan_resnet_blocks(module(), "gblocks"),
                                          module(), np.random.default_rng(2))
    jvars = jimp.convert_resnet_encoder(ref, template,
                                        get_resnet_arch(mc.refine_model_type, mc.ngf))
    want = from_jax_module(module(), jvars)
    got = imp.convert_resnet_encoder(ref, module())
    assert_equal_state_dicts(got, want)
    if trainable:
        return
    enc = module()
    enc.load_state_dict(got)
    x = np.random.default_rng(3).uniform(-1, 1, (2, W, W, 3)).astype(np.float32)
    want = jps.encoder.apply(jvars, jnp.asarray(x), train=False, noise_scale=0.0)
    with torch.no_grad():
        out = enc.eval()(torch.as_tensor(x), noise_scale=0.0)
    want = np.asarray(want)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_two_level_vqvae_equals_jax():
    args = dict(in_channel=3, channel=16, n_res_block=2, n_res_channel=8, embed_dim=8,
                n_embed=32, decay=0.99)
    img = np.random.default_rng(4).uniform(-1, 1, (2, W, W, 3)).astype(np.float32)
    jm = JaxVQVAE(**args)
    template = _zeros(jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                                     jnp.asarray(img), train=False)))
    ref = random_reference_state_dict(imp.plan_vqvae(2), VQVAE(**args),
                                          np.random.default_rng(5))
    jvars = jimp.convert_vqvae(ref, template, top_only=False)
    want = from_jax_module(VQVAE(**args), jvars)
    got = imp.convert_vqvae(ref, VQVAE(**args))
    assert_equal_state_dicts(got, want)
    m = VQVAE(**args).eval()
    m.load_state_dict(got)
    want_dec, _ = jm.apply(jvars, jnp.asarray(img), train=False)
    with torch.no_grad():
        dec = m(torch.as_tensor(img))[0]
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec), atol=1e-4, rtol=1e-4)


B, H, NC, F = 2, 8, 16, 16


@pytest.mark.parametrize("conv_mask_weight", [False, True])
def test_lmconv_equals_jax(conv_mask_weight):
    """Weight-normed and plain layers mixed (the reference keeps its convs
    plain and nin_out weight-normed); with conv_mask_weight the (O, k*k)
    mask weights too.  Logits to the module tests' 3e-4."""
    kw = dict(nr_resnet=2, nr_filters=F, input_channels=NC, num_classes=NC,
              conv_mask_weight=conv_mask_weight)
    rng = np.random.default_rng(6)
    dist = rng.integers(-10, 10, (B, H, H)).astype(np.int32)
    a, b, d = masks_for_orders_batch(list(custom_order(dist)), H, H, 3, 2)
    masks = np.stack([a, b, d], 1).astype(np.float32)
    codes = rng.integers(0, NC, (B, H, H))
    oh = np.eye(NC, dtype=np.float32)[codes]
    jm = JaxLMPixelCNN(**kw)
    m = jnp.asarray(masks)
    template = _zeros(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(oh), m[:, 0], m[:, 1], m[:, 2],
        train=False)))
    port = LMPixelCNN(compute_dtype="float32", **kw)
    ref = random_reference_state_dict(imp.plan_lmconv(2), port, rng)
    assert any(k.endswith("weight_g") for k in ref) and any(
        k.endswith(".weight") for k in ref)
    jvars = jimp.convert_lmconv(ref, template, nr_resnet=2)
    want = from_jax_module(LMPixelCNN(compute_dtype="float32", **kw), jvars)
    got = imp.convert_lmconv(ref, port, nr_resnet=2)
    assert_equal_state_dicts(got, want)
    port.load_state_dict(got)
    want = jm.apply(jvars, jnp.asarray(oh), m[:, 0], m[:, 1], m[:, 2], train=False)
    mt = torch.as_tensor(masks)
    with torch.no_grad():
        out = port.eval()(torch.as_tensor(oh), mt[:, 0], mt[:, 1], mt[:, 2])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the three files
# ---------------------------------------------------------------------------


def test_import_from_files_equals_jax(trees, tmp_path):
    """pixelsynth.pth ({"state_dict": "model.module."-prefixed keys of the
    U-Net, decoder, discriminator, VQ-VAE and PixelCNN}), vqvae.pth
    ("module."-prefixed) and autoregressive.pth ({"model_state_dict"}),
    written with torch.save: every tree equal to JAX's import_from_files
    through from_jax_params, and the later files' trees win."""
    jcfg, cfg, jps, templates, refs = trees
    ps = PixelSynth(cfg, device="cpu", with_classifier=False)
    lm_plan = imp.plan_lmconv(cfg.model.lmconv.nr_resnet)
    lm_ref = random_reference_state_dict(lm_plan, ps.pixelcnn, np.random.default_rng(7))
    lm_ref2 = random_reference_state_dict(lm_plan, ps.pixelcnn, np.random.default_rng(8))
    vq2 = random_reference_state_dict(imp.plan_vqvae(cfg.model.vqvae.n_res_block),
                                          ps.vqvae, np.random.default_rng(9))
    names = {"unet": "pts_regressor", "projector": "projector", "disc": "netD",
             "vqvae": "vqvae"}
    main = {f"model.module.{names[n]}.{k}": v for n in names for k, v in refs[n].items()}
    main.update({f"model.module.outpaint2.{k}": v for k, v in lm_ref.items()})
    paths = {n: str(tmp_path / f"{n}.pth") for n in ("pixelsynth", "vqvae", "autoregressive")}
    torch.save({"state_dict": main, "epoch": 3}, paths["pixelsynth"])
    torch.save({f"module.{k}": v for k, v in vq2.items()}, paths["vqvae"])
    torch.save({"model_state_dict": lm_ref2, "epoch": 3}, paths["autoregressive"])
    files = dict(pixelsynth_path=paths["pixelsynth"], vqvae_path=paths["vqvae"],
                 autoregressive_path=paths["autoregressive"])
    got = imp.import_from_files(ps, **files)
    l = jcfg.model.lmconv
    oh = jnp.zeros((1, l.obs[1], l.obs[2], l.num_classes))
    mk = jnp.zeros((1, 9, l.obs[1] * l.obs[2]))
    variables = dict(templates)
    variables["pixelcnn"] = _zeros(jax.eval_shape(lambda: jps.pixelcnn.init(
        {"params": jax.random.PRNGKey(0)}, oh, mk, mk, mk, train=False)))
    jvars = jimp.import_from_files(jps, variables, **files)
    want = from_jax_params(jvars, cfg)
    assert sorted(got) == ["disc", "pixelcnn", "projector", "unet", "vqvae"]
    for name in got:
        assert_equal_state_dicts(got[name], want[name])
    # vqvae.pth and autoregressive.pth replaced pixelsynth.pth's trees
    assert_equal_state_dicts(got["vqvae"], imp.convert_vqvae(vq2, ps.vqvae))
    assert_equal_state_dicts(got["pixelcnn"], imp.convert_lmconv(lm_ref2, ps.pixelcnn))
    served = PixelSynth(cfg, device="cpu", state_dicts=got)
    img = torch.zeros((1, W, W, 3))
    assert torch.isfinite(served.regress_depth(img)).all()
