"""The trainer's layers in train mode, its losses and its synthetic data,
against the JAX package on the CPU: each train-mode layer's output, its
updated `batch_stats` / `spectral_stats` and its gradients (to the
parameters and the input) against the Flax module applied with mutable
collections."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.data.synthetic import synthetic_pair_batch as jax_synthetic
from pixelsynth_tpu.geometry import cameras as jax_cameras
from pixelsynth_tpu.models import layers as JL
from pixelsynth_tpu.models import losses as jax_losses
from pixelsynth_tpu.pipeline import _softmax_xent as jax_xent
from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
from pixelsynth_tpu_torch.geometry import cameras
from pixelsynth_tpu_torch.models import layers as L
from pixelsynth_tpu_torch.models import losses
from pixelsynth_tpu_torch.models.discriminators import MultiscaleDiscriminator
from pixelsynth_tpu_torch.pipeline import softmax_xent
from pixelsynth_tpu_torch.weights import merge_collections

from test_torch_models import _converge_spectral, _fill
from torch_train_ref import _few_torch_threads, flat, jax_float64, to64  # noqa: F401


def _layer(kind):
    """(Flax module, port module, apply kwargs) at 8 -> 16 channels."""
    if kind == "snconv":
        return JL.SNConv(16, 3, 1, 1), L.Conv(8, 16, 3, 1, 1, spectral=True,
                                              trainable=True), {}
    if kind == "syncbn":
        return JL.SyncBatchNorm(), L.SyncBatchNorm(8, trainable=True), {}
    if kind == "standingbn":
        return JL.StandingStatsBN(8), L.StandingStatsBN(8, trainable=True), {}
    if kind == "noisebn":
        return JL.NoiseBN(8), L.NoiseBN(8, trainable=True), {"noise": True}
    return (JL.ResNetBlock(16, "Down"), L.ResNetBlock(8, 16, "Down", True, trainable=True),
            {"noise_scale": 0.0})


def _max_rel(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale)


@pytest.mark.parametrize("kind", ["snconv", "syncbn", "standingbn", "noisebn",
                                  "resnetblock"])
def test_train_mode_layer_matches_flax(kind):
    """Output, collection updates and gradients to <= 1e-5 of their own
    scale (the largest entry of the output, of each collection leaf, and of
    all the gradients together: a bias in front of a BatchNorm has an
    analytic gradient of 0, so its own scale is rounding)."""
    rng = np.random.default_rng(0)
    jm, tm, kw = _layer(kind)
    x = rng.normal(0.3, 1.0, (2, 8, 8, 8)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("noise"):
        noise = rng.normal(size=(2, 20)).astype(np.float32)
        jkw["noise"], tkw["noise"] = jnp.asarray(noise), torch.as_tensor(noise)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False, **jkw))
    v = _converge_spectral({"t": _fill(shapes, rng)})["t"]
    out_shape = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), train=False, **jkw)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def f(params, xx):
        out, upd = jm.apply({**v, "params": params}, xx, train=True,
                            mutable=["batch_stats", "spectral_stats"], **jkw)
        return jnp.sum(out * cot), (out, upd)

    (_, (jout, jupd)), (jg, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))

    with torch.no_grad():
        tm.load_flax(merge_collections(v))
    tm.train()
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = tm(xt, **tkw)
    named = list(tm.named_parameters())
    grads = torch.autograd.grad((out.permute(0, 2, 3, 1) * torch.as_tensor(cot)).sum(),
                                [p for _, p in named] + [xt], allow_unused=True)

    jo = np.asarray(jout)
    assert _max_rel(out.detach().permute(0, 2, 3, 1).numpy(), jo,
                    np.abs(jo).max()) <= 1e-5
    # updated collections, leaf by leaf (u/v, running / stored stats)
    mine = L.collections(tm)
    for col, tree in jupd.items():
        flat_j = {k: np.asarray(a) for k, a in flat(tree).items()}
        flat_t = {k: a.numpy() for k, a in flat(mine[col]).items()}
        assert set(flat_j) == set(flat_t), col
        for k, a in flat_j.items():
            assert _max_rel(flat_t[k], a, np.abs(a).max()) <= 1e-5, (col, k)
    # gradients: the JAX ones in the port's layouts through the bridge
    ref = copy.deepcopy(tm)
    with torch.no_grad():
        ref.load_flax(merge_collections({**v, "params": jg}))
    want = dict(ref.named_parameters())
    scale = max(np.abs(np.asarray(a)).max() for a in jax.tree_util.tree_leaves(jg))
    scale = max(scale, np.abs(np.asarray(jgx)).max())
    for (name, _), g in zip(named, grads[:-1]):
        got = np.zeros(want[name].shape, np.float32) if g is None else g.numpy()
        assert _max_rel(got, want[name].detach().numpy(), scale) <= 1e-5, name
    assert _max_rel(grads[-1].permute(0, 2, 3, 1).numpy(), jgx, scale) <= 1e-5


def test_noisebn_zero_noise_still_advances_spectral_vectors():
    """At noise_scale 0 the output is the plain BatchNorm, and train mode
    still runs the power iterations of both kernels (as the JAX layer)."""
    rng = np.random.default_rng(1)
    m = L.NoiseBN(8, trainable=True)
    with torch.no_grad():
        m.reset(torch.Generator().manual_seed(0))
        m.u_gain.copy_(torch.as_tensor(rng.normal(size=8)))
    before = m.u_gain.clone()
    m.train()
    x = torch.as_tensor(rng.normal(size=(2, 8, 4, 4)).astype(np.float32))
    out = m(x, noise_scale=0.0)
    assert not torch.equal(before, m.u_gain)
    m2 = L.BatchNorm(8, scale=False, bias=False)
    m2.train()
    torch.testing.assert_close(out, m2(x), rtol=0, atol=0)


def test_serving_build_folds_what_the_trainable_build_divides():
    """Eval of the trainable Conv (w / |mat^T v| at every forward) equals
    the serving Conv, which folds the same division at load."""
    rng = np.random.default_rng(2)
    node = {"kernel": rng.normal(size=(3, 3, 4, 6)).astype(np.float32) / 6,
            "bias": rng.normal(size=6).astype(np.float32),
            "u": rng.normal(size=6).astype(np.float32),
            "v": rng.normal(size=36).astype(np.float32)}
    serving, trainable = (L.Conv(4, 6, 3, 1, 1, spectral=True),
                          L.Conv(4, 6, 3, 1, 1, spectral=True, trainable=True))
    with torch.no_grad():
        serving.load_flax(node)
        trainable.load_flax(node)
    trainable.eval()
    x = torch.as_tensor(rng.normal(size=(1, 4, 5, 5)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(trainable(x), serving(x), rtol=1e-6, atol=1e-6)


def test_vgg_perceptual_and_synthesis_losses_match_jax():
    """Features and every loss key in float32 (1e-5 relative); the
    gradient to the prediction in float64 on both sides (1e-6 of its
    scale).  In float32 the JAX package's CPU convolutions through the
    sixteen VGG layers sit ~1% of the gradient's scale away from float64,
    the port's ~1e-6 (tests/torch_train_ref.py)."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jvgg = jax_losses.VGG19Features()
    shapes = jax.eval_shape(lambda: jvgg.init(jax.random.PRNGKey(0), jnp.asarray(pred)))
    v = _fill(shapes, rng)
    vgg = losses.VGG19Features()
    with torch.no_grad():
        vgg.load_flax(merge_collections(v))
    feats = vgg(torch.as_tensor(pred))
    for a, b in zip(feats, jvgg.apply(v, jnp.asarray(pred))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(b)).max()))

    def jloss(p, g, vv):
        out = jax_losses.synthesis_loss(p, g, vgg_apply=lambda im: jvgg.apply(vv, im))
        return out["Total Loss"], out

    want = jax.jit(jloss)(jnp.asarray(pred), jnp.asarray(gt), v)[1]
    got = losses.synthesis_loss(torch.as_tensor(pred), torch.as_tensor(gt), vgg=vgg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)

    with jax_float64():
        jgrad = np.asarray(jax.jit(jax.grad(lambda p, g, vv: jloss(p, g, vv)[0]))(
            jnp.asarray(pred, jnp.float64), jnp.asarray(gt, jnp.float64), to64(v)))
    pt = torch.tensor(pred, dtype=torch.float64, requires_grad=True)
    total = losses.synthesis_loss(pt, torch.as_tensor(gt).double(),
                                  vgg=vgg.double())["Total Loss"]
    (g,) = torch.autograd.grad(total, pt)
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=0, atol=1e-6 * np.abs(jgrad).max())


def test_gan_losses_and_discriminator_scores_match_jax():
    """hinge_g (with feature matching) and hinge_d on the discriminator's
    multiscale scores, and the gradient of the G loss to the fake images."""
    from pixelsynth_tpu.models.discriminators import MultiscaleDiscriminator as JD

    rng = np.random.default_rng(4)
    fake = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jd = JD(ndf=8)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.asarray(fake),
                                            train=False))
    v = _converge_spectral({"d": _fill(shapes, rng)})["d"]
    d = MultiscaleDiscriminator(8, trainable=True)
    with torch.no_grad():
        d.load_flax(merge_collections(v))
    d.eval()

    def jg(f):
        pf, pr = jax_losses.discriminator_scores(
            lambda x, train: jd.apply(v, x, train=False), f, jnp.asarray(real),
            train=False)
        out = jax_losses.hinge_g_loss(pf, pr)
        return out["Total Loss"], (out, jax_losses.hinge_d_loss(pf, pr))

    (_, (want_g, want_d)), jgrad = jax.jit(jax.value_and_grad(jg, has_aux=True))(
        jnp.asarray(fake))
    ft = torch.tensor(fake, requires_grad=True)
    pf, pr = losses.discriminator_scores(d, ft, torch.as_tensor(real))
    got_g = losses.hinge_g_loss(pf, pr)
    got_d = losses.hinge_d_loss(pf, pr)
    (g,) = torch.autograd.grad(got_g["Total Loss"], ft)
    for got, want in ((got_g, want_g), (got_d, want_d)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jgrad)).max()))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 4, 4, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 16, (2, 4, 4))
    np.testing.assert_allclose(
        float(softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels))),
        float(jax_xent(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_cameras_and_synthetic_batch_match_jax():
    theta = np.random.default_rng(6).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(cameras.euler_to_rotation_matrix(theta).numpy(),
                               np.asarray(jax_cameras.euler_to_rotation_matrix(theta)),
                               atol=1e-6)
    RT = np.asarray(jax_cameras.euler_to_rotation_matrix(theta))
    RT = np.concatenate([np.concatenate([RT, theta[:, :, None]], -1),
                         np.broadcast_to([[[0, 0, 0, 1]]], (5, 1, 4))], 1).astype(np.float32)
    np.testing.assert_allclose(cameras.invert_RT(torch.as_tensor(RT)).numpy(),
                               np.asarray(jax_cameras.invert_RT(jnp.asarray(RT))),
                               atol=1e-6)
    got = synthetic_pair_batch(np.random.default_rng(7), 3, 64)
    want = jax_synthetic(np.random.default_rng(7), 3, 64)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
