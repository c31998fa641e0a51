"""K2 with bf16 features (`splat.blend_dtype="bfloat16"`): the port's splat
against the JAX package's XLA splat with the same config, its gradient
against `jax.grad`, and one `forward_angle` with a bf16 blend against the
JAX package's.

The function: the features and each slot's weight are rounded to bf16
(nearest even), the products summed in f32; alpha, z and coverage stay f32.
Both sides round the same numbers, but their f32 weights (a cumprod or a
sum taken in another order) can differ by an ulp, and a weight within an
f32 ulp of a bf16 rounding boundary then rounds the other way: such a
pixel differs by one bf16 step of one weight (2^-8 of it).  So the images
are held to 1e-2 of their scale at most and 1e-6 of it on average (the port
measured 8e-8 and 2e-11 here; the port's f32 blend against JAX's bf16 one
is 3e-3 and 2e-4), and the background masks, which never see a bf16 value,
bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.ops.splat import splat as jax_splat
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu_torch.config import Config, SplatConfig
from pixelsynth_tpu_torch.ops import splat as K2
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.utils.camera_paths import nerf_like_circle
from pixelsynth_tpu_torch.weights import from_jax_params
from test_torch_models import _converge_spectral, _fill, tiny
from torch_noise_bank import NoiseBank
from torch_threads import _few_torch_threads  # noqa: F401

W = 32
ACCUMULATIONS = ["alphacomposite", "wsum", "wsumnorm"]


def _points(C, B=2, N=80, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, W + 5, (B, N)), rng.uniform(-6, W + 5, (B, N)),
                    rng.uniform(0.5, 10.0, (B, N))], -1).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    return pts, feats, valid


def _cfgs(**kw):
    kw = dict(max_points_per_tile=256, tile_size=16, tile_group=4, **kw)
    return SplatConfig(**kw), JaxSplatConfig(**kw)


@pytest.mark.parametrize("accumulation", ACCUMULATIONS)
@pytest.mark.parametrize("C", [3, 9, 64])
def test_bf16_splat_matches_jax(C, accumulation):
    """The image to 1e-2 of its scale at most and 1e-6 on average; the
    background mask bit-equal to JAX's bf16 run and to the port's f32
    run; and the bf16 blend is not the f32 one."""
    pts, feats, valid = _points(C, seed=C)
    cfg, jcfg = _cfgs(accumulation=accumulation, blend_dtype="bfloat16")
    want, bg_want = jax_splat(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(valid),
                              W=W, cfg=jcfg)
    args = (torch.as_tensor(pts), torch.as_tensor(feats), torch.as_tensor(valid))
    before = K2.PLAIN_CALLS["splat_blend"]
    got, bg = K2.splat(*args, W=W, cfg=cfg)
    assert K2.PLAIN_CALLS["splat_blend"] == before + 1
    f32, bg32 = K2.splat(*args, W=W, cfg=dataclasses.replace(cfg, blend_dtype="float32"))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, W, W, C)
    err = np.abs(got.numpy() - want)
    scale = float(np.abs(want).max())
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-6 * scale, (err.mean(), scale)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_want))
    np.testing.assert_array_equal(bg.numpy(), bg32.numpy())
    assert bg.any() and not bg.all()
    # the rounding is there: the f32 blend differs, by about a bf16 step
    d32 = float((f32 - got).abs().max())
    assert 1e-5 * scale < d32 <= 2e-2 * scale, d32


@pytest.mark.parametrize("accumulation", ACCUMULATIONS)
def test_bf16_splat_gradient_matches_jax_grad(accumulation):
    """d points and d feats of (splat * g).sum() under the bf16 blend
    against `jax.grad` of the JAX package's bf16 splat, C = 9.  The port's
    backward recomputes the plain bf16 blend under autograd, so d feats
    carries the cast's rounding as jax.grad through `astype(bfloat16)` does
    (each slot's cotangent rounded to bf16).  The two sides sum the slots'
    cotangents in other orders and precisions (JAX's gather transposes into
    a bf16 scatter-add): d feats is held to 1e-2 of its scale at most and
    1e-4 on average (measured 3e-3 and 5e-5), d points to 1e-5 and 1e-7
    (measured 1.4e-6 and 1e-8; an f32 blend is 3e-3 and 2e-4 off)."""
    C = 9
    pts, feats, valid = _points(C, N=200, seed=20)
    g = np.random.default_rng(21).standard_normal((2, W, W, C)).astype(np.float32)
    cfg, jcfg = _cfgs(accumulation=accumulation, blend_dtype="bfloat16")

    def loss(p, f):
        return jnp.sum(jax_splat(p, f, jnp.asarray(valid), W=W, cfg=jcfg)[0] * g)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(feats))
    p = torch.as_tensor(pts).requires_grad_(True)
    f = torch.as_tensor(feats).requires_grad_(True)
    out, _ = K2.splat(p, f, torch.as_tensor(valid), W=W, cfg=cfg)
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), (p, f))
    for name, a, b, tol_max, tol_mean in zip(("points", "feats"), got, want,
                                             (1e-5, 1e-2), (1e-7, 1e-4)):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        err = np.abs(a.numpy() - b)
        assert scale > 0
        assert err.max() <= tol_max * scale, (name, err.max(), scale)
        assert err.mean() <= tol_mean * scale, (name, err.mean(), scale)


@pytest.fixture(scope="module")
def bf16_nets():
    """The tiny config with a bf16 blend: seeded U-Net and refinement
    decoder (3 + 1 input channels) in both packages."""
    jcfg, cfg = tiny(JaxConfig()), tiny(Config())
    jcfg.model.splat.blend_dtype = cfg.model.splat.blend_dtype = "bfloat16"
    jps = JaxPixelSynth(jcfg)
    img = jnp.zeros((1, W, W, 3))
    k = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, img, train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, img, jnp.zeros((1, W, W), bool), train=False)),
    }
    variables = _converge_spectral(_fill(shapes, np.random.default_rng(0)))
    ps = PixelSynth(cfg, device="cpu", state_dicts=from_jax_params(variables, cfg))
    return jps, variables, ps


def test_forward_angle_bf16_matches_jax(bf16_nets):
    """forward_angle over nerf_like_circle(3) with the bf16 blend against
    the JAX package's, batch 2, the same NoiseBN draws: one splat a view;
    every view to 2e-3 at most and 1e-5 on average (measured 2.3e-4 and
    2e-7: a bf16 step of a weight that rounds the other way, through the
    decoder; the port's f32 blend is 3e-3 and 3e-4 off)."""
    jps, v, ps = bf16_nets
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, W, W, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    RTs = nerf_like_circle(3)
    bank = NoiseBank(16, 2)
    before = K2.PLAIN_CALLS["splat_blend"]
    with bank.patch():
        want = jps.forward_angle(v, jnp.asarray(img), jnp.asarray(eye), jnp.asarray(eye),
                                 RTs, rng=jax.random.PRNGKey(3))
        got = ps.forward_angle(torch.as_tensor(img), torch.as_tensor(eye),
                               torch.as_tensor(eye), RTs,
                               gen=torch.Generator().manual_seed(3))
    assert K2.PLAIN_CALLS["splat_blend"] - before == len(RTs)
    assert len(got) == len(want) == 3
    for gv, wv in zip(got, want):
        assert gv.shape == (2, W, W, 3) and float(gv.abs().max()) <= 1.0
        err = np.abs(gv.numpy() - np.asarray(wv))
        assert err.max() <= 2e-3 and err.mean() <= 1e-5, (err.max(), err.mean())
