"""The learned-feature path: the port's `ResNetEncoder`, the splat at the
encoder's 64 channels (K2's plain version on the CPU) and its gradient,
and `render_no_outpaint` / `forward_angle` carrying 64-wide features into
a decoder of that width, each against the JAX package on the same seeded
weights and the same NoiseBN draws (tests/torch_noise_bank.py); and the
configurations the port refuses because the JAX package cannot compute
them.

The JAX side of the composition is what the JAX package computes:
`features(rngs=)` -> `splat_view` -> `decode_image` (its own
`render_no_outpaint` and `forward_angle` call `features` without rngs,
which raises InvalidRngError), with a projector initialised inside the
test on 64 (+1 with the mask) input channels (its `init_variables` builds
3 + 1)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.models.encoderdecoder import ResNetEncoder as JaxEncoder
from pixelsynth_tpu.ops.splat import splat as jax_splat
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.utils.camera_paths import nerf_like_circle
from pixelsynth_tpu_torch.config import Config, SplatConfig
from pixelsynth_tpu_torch.models.encoderdecoder import ResNetEncoder
from pixelsynth_tpu_torch.ops import splat as K2
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.scene import SceneGenerator
from pixelsynth_tpu_torch.weights import flatten_tree, from_jax_module, from_jax_params
from test_torch_models import _converge_spectral, _fill, tiny
from test_torch_splat import _points
from torch_noise_bank import NoiseBank
from torch_threads import _few_torch_threads  # noqa: F401

W = 32
N_BLOCKS = 8     # ResNet blocks of the encoder and of the decoder, 2 NoiseBNs each


def _enc_cfg(cfg, no_outpainting=False):
    cfg = tiny(cfg)
    cfg.model.use_rgb_features = False
    cfg.model.predict_residual = False
    cfg.model.no_outpainting = no_outpainting
    return cfg


def _inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, W, W, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    return img, eye


@pytest.mark.parametrize("arch", ["resnet_256W8UpDown3", "resnet_256W8"])
def test_encoder_matches_flax(arch):
    """ResNetEncoder at ngf 8 (256W8 downsamples twice: 32 -> 8) with the
    same draws in its 16 NoiseBNs: fp32 both sides, atol 1e-5 + rtol 1e-4
    (convolutions summed in other orders)."""
    img, _ = _inputs()
    jenc = JaxEncoder(arch, 8, True)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jenc.init({"params": k, "noise": k},
                                              jnp.asarray(img), train=False))
    variables = _converge_spectral({"e": _fill(shapes, np.random.default_rng(1))})["e"]
    enc = ResNetEncoder(arch, 8, True).eval()
    enc.load_state_dict(from_jax_module(ResNetEncoder(arch, 8, True), variables))
    bank = NoiseBank(2 * N_BLOCKS, 2)
    with bank.patch():
        want = jenc.apply(variables, jnp.asarray(img), train=False,
                          rngs={"noise": jax.random.PRNGKey(5)})
        with torch.no_grad():
            got = enc(torch.as_tensor(img), gen=torch.Generator().manual_seed(5))
    assert len(bank.jax_keys) == len(bank.port_keys) == 2 * N_BLOCKS
    side = W // 4 if arch == "resnet_256W8" else W
    assert got.shape == (2, side, side, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_splat_64_channels_matches_jax():
    """K2's entry at C = 64 (the plain version on the CPU; on the card one
    launch of 8 channel groups) against the JAX splat: atol 5e-4, rtol
    1e-3, as at C = 3; the background masks equal."""
    pts, feats, valid = _points(N=150, C=64, seed=4)
    kw = dict(max_points_per_tile=128, tile_size=16, tile_group=4,
              background_smoothing_kernel_size=5)
    want, bg_want = jax_splat(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(valid),
                              W=32, cfg=JaxSplatConfig(**kw))
    got, bg = K2.splat(torch.as_tensor(pts), torch.as_tensor(feats),
                       torch.as_tensor(valid), W=32, cfg=SplatConfig(**kw))
    assert got.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_want))


def test_splat_64_channels_gradient_matches_jax_grad():
    """d points and d feats at C = 64 under a gradient (`_SplatBlendFn`:
    K2's forward, the plain recomputed backward) against jax.grad of the
    JAX splat's sum against a cotangent: to 1e-4 of each gradient's
    scale."""
    pts, feats, valid = _points(N=150, C=64, seed=5)
    kw = dict(max_points_per_tile=128, tile_size=16, tile_group=2,
              background_smoothing_kernel_size=5)
    cot = np.random.default_rng(6).normal(size=(2, 32, 32, 64)).astype(np.float32)
    jcfg = JaxSplatConfig(**kw)
    want_p, want_f = jax.grad(
        lambda p, f: jnp.sum(jax_splat(p, f, jnp.asarray(valid), W=32, cfg=jcfg)[0]
                             * jnp.asarray(cot)), argnums=(0, 1))(
        jnp.asarray(pts), jnp.asarray(feats))
    p = torch.tensor(pts, requires_grad=True)
    f = torch.tensor(feats, requires_grad=True)
    out, _ = K2.splat(p, f, torch.as_tensor(valid), W=32, cfg=SplatConfig(**kw))
    (out * torch.as_tensor(cot)).sum().backward()
    for got, want in ((p.grad, want_p), (f.grad, want_f)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module", params=[False, True], ids=["mask", "no_outpainting"])
def enc_nets(request):
    """Seeded weights for the encoder composition: the JAX trees of the
    U-Net, the encoder and a projector initialised on 64 (+1) channels;
    the port's PixelSynth loaded from them through the weight bridge."""
    no_out = request.param
    jcfg = _enc_cfg(JaxConfig(), no_out)
    cfg = _enc_cfg(Config(), no_out)
    jps = JaxPixelSynth(jcfg)
    img, _ = _inputs()
    k = jax.random.PRNGKey(0)
    fs = jnp.zeros((1, W, W, 64))
    mask = None if no_out else jnp.zeros((1, W, W), bool)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, jnp.asarray(img),
                                                     train=False)),
        "encoder": jax.eval_shape(lambda: jps.encoder.init(
            {"params": k, "noise": k}, jnp.asarray(img), train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, fs, mask, train=False)),
    }
    variables = _converge_spectral(_fill(shapes, np.random.default_rng(2)))
    ps = PixelSynth(cfg, device="cpu", state_dicts=from_jax_params(variables, cfg))
    assert ps.projector.in_channels == (64 if no_out else 65)
    return jps, variables, ps, no_out


def _cams(B, RT):
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    return {"K": eye, "Kinv": eye, "P_in": eye, "Pinv_in": eye,
            "P_out": np.broadcast_to(RT, (B, 4, 4)).copy()}


def _jax_view(jps, v, img, cams, fs, k_dec):
    gen_fs, bg, _ = jps.splat_view(fs, jps.regress_depth(v["unet"], img)[0],
                                   {k: jnp.asarray(a) for k, a in cams.items()})
    mask = None if jps.cfg.model.no_outpainting else bg
    out, _ = jps.decode_image(v["projector"], gen_fs, mask, rngs={"noise": k_dec})
    return out, gen_fs


def test_render_no_outpaint_with_encoder_matches_jax(enc_nets):
    """The port's render_no_outpaint (encoder draws, then the decoder's,
    from one generator) against JAX's features(rngs=) -> splat_view ->
    decode_image: the splatted 64-wide features to 5e-4 (the splat's
    tolerance) and the image to 1e-4."""
    jps, v, ps, _ = enc_nets
    img, _ = _inputs(3)
    cams = _cams(2, nerf_like_circle(4)[1])
    bank = NoiseBank(4 * N_BLOCKS, 2)
    with bank.patch():
        fs, _ = jps.features(v, jnp.asarray(img), rngs={"noise": jax.random.PRNGKey(1)})
        want, want_fs = _jax_view(jps, v, jnp.asarray(img), cams, fs,
                                  jax.random.PRNGKey(2))
        out = ps.render_no_outpaint(torch.as_tensor(img),
                                    {k: torch.as_tensor(a) for k, a in cams.items()},
                                    gen=torch.Generator().manual_seed(1))
    assert len(bank.jax_keys) == len(bank.port_keys) == 4 * N_BLOCKS
    assert out["FeaturesImg"].shape == (2, W, W, 64)
    np.testing.assert_allclose(out["FeaturesImg"].numpy(), np.asarray(want_fs),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out["PredImg"].numpy(), np.asarray(want), atol=1e-4)


def test_forward_angle_with_encoder_matches_jax(enc_nets):
    """forward_angle over nerf_like_circle(4): one feature pass, then per
    view the splat and the decoder with its noise restarted, against the
    JAX composition with one decoder key for every view (the bank holds
    the encoder's 16 rows and one view's 16); each view to 1e-4."""
    jps, v, ps, _ = enc_nets
    img, eye = _inputs(4)
    RTs = nerf_like_circle(4)
    bank = NoiseBank(4 * N_BLOCKS, 2)
    before = K2.PLAIN_CALLS["splat_blend"]
    with bank.patch():
        fs, _ = jps.features(v, jnp.asarray(img), rngs={"noise": jax.random.PRNGKey(7)})
        want = [_jax_view(jps, v, jnp.asarray(img), _cams(2, RT), fs,
                          jax.random.PRNGKey(8))[0] for RT in RTs]
        got, depth = ps.forward_angle(torch.as_tensor(img), torch.as_tensor(eye),
                                      torch.as_tensor(eye), RTs,
                                      gen=torch.Generator().manual_seed(7),
                                      return_depth=True)
    assert len(bank.jax_keys) == len(bank.port_keys) == 4 * N_BLOCKS
    assert K2.PLAIN_CALLS["splat_blend"] - before == len(RTs)
    assert depth.shape == (2, W, W)
    for g, w in zip(got, want):
        assert g.shape == (2, W, W, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_stitched_checkpoint_with_an_encoder_tree(enc_nets, tmp_path):
    """load_stitched_npz / PixelSynth.from_stitched read a checkpoint with
    an "encoder" tree: the encoder and the 64 + 1-channel projector load,
    and the features equal those of the bridge's modules."""
    _, v, ps, no_out = enc_nets
    flat = {f"{tree}/{k}": a for tree in v for k, a in flatten_tree(v[tree]).items()}
    path = os.path.join(tmp_path, "enc.npz")
    np.savez(path, __config__=np.frombuffer(ps.cfg.to_json().encode(), np.uint8), **flat)
    loaded = PixelSynth.from_stitched(path, device="cpu")
    assert loaded.encoder is not None
    assert loaded.projector.in_channels == (64 if no_out else 65)
    img = torch.as_tensor(_inputs(5)[0])
    with torch.no_grad():
        a = loaded.features(img, noise_scale=0.0)
        b = ps.features(img, noise_scale=0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["trainable", "scene", "modifier", "residual"])
def test_refuses_what_jax_cannot_compute(case):
    """Each configuration the JAX package cannot compute raises
    NotImplementedError naming the field and the JAX package's line."""
    cfg = _enc_cfg(Config())
    if case == "trainable":
        match = "pipeline.py:557"
        make = lambda: PixelSynth(cfg, device="cpu", trainable=True)  # noqa: E731
    elif case == "scene":
        match = "scene.py:153,185,219"
        make = lambda: SceneGenerator(PixelSynth(cfg, device="cpu"))  # noqa: E731
    elif case == "modifier":
        cfg = tiny(Config())
        cfg.model.depth_predictor_type = "unet_modifier"
        match = "depth_predictor_type.*pipeline.py:263-281"
        make = lambda: PixelSynth(cfg, device="cpu")  # noqa: E731
    else:
        cfg.model.predict_residual = True
        match = "predict_residual.*encoderdecoder.py:107-110"
        make = lambda: PixelSynth(cfg, device="cpu")  # noqa: E731
    with pytest.raises(NotImplementedError, match=match):
        make()
