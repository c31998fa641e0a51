"""The port's G+D step (train/dpr.py) against a JAX step assembled from the
JAX package's public pieces in the order of its `make_dpr_train_step`
(dpr.py:122-185), on the tiny config of tests/test_train_loops.py at W=32
(XLA:CPU's float64 convolutions are slow; the values given as measured
below were taken at W=64): the G loss with D scored in eval, Adam on G
with G's batch / spectral statistics merged, the D hinge loss on the
detached prediction, Adam on D, then one train forward of D on fake ||
real that only advances D's spectral vectors.  Both sides in float64 end to end.

Both packages take STEPS consecutive steps from one initial state, each
from the state it carried out of the step before, with the NoiseBN noise
on: each step's (B, 20) draws come from a numpy bank, which the JAX
layers' one `jax.random.normal` call (models/layers.py:216) reads in the
jitted step and the port's `NoiseBN.forward` takes through its `noise=`
argument.  The first step, from a fresh Adam, is held leaf by leaf (the
gradients each optimizer is given, the parameters, statistics and metrics
after it); after every step, the parameters, Adam's moments and count,
G's batch statistics and spectral vectors, and D's spectral vectors.
The bound is 1e-9 of each leaf's largest value for the U-Net, the decoder
and D.  Where it is looser, the test names the leaves and says why:
  * the PixelCNN stays float32 (its plain masked conv computes in the
    dtype of its operands, ops/masked_conv.py), so its gradients sit
    ~1e-6 of their scale from JAX's float64 ones (measured 1.0e-6), and
    Adam's division turns that into up to ~lr on small-gradient elements;
  * leaves whose gradient is zero in exact arithmetic carry float64
    rounding alone: every U-Net leaf (<= 1.5e-15 in both packages; the
    depth reaches the loss only through the splat's point positions) and
    the bias of each ResNet block's first conv, which a BatchNorm follows
    (<= 7.1e-15).  They are held to 1e-13 absolute; the parameters they
    move are held to the common bound.
The JAX package blends the splat's features in `splat.blend_dtype` and
returns the contraction in float32 (`preferred_element_type`,
ops/splat.py:441-442): its reference runs with blend_dtype "float64", so
that its one rounding is the contraction's output, and the port's plain
blend output is rounded to float32 at the same place.

Also: the port's optimizer against optax (the `niter` decay and the
`num_accumulations` MultiSteps), and the port's own step with noise."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsynth_tpu.data.synthetic import synthetic_pair_batch
from pixelsynth_tpu.models import layers as jax_layers
from pixelsynth_tpu.models.losses import (
    discriminator_scores, hinge_d_loss, hinge_g_loss,
)
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.train.dpr import (
    _merge_updates, _params_of, _with_params, create_dpr_state as jax_create_state,
)
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models import layers as port_layers
from pixelsynth_tpu_torch.models.layers import collections
from pixelsynth_tpu_torch.ops import splat as port_splat
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.train.dpr import (
    TRAINABLE, Adam, create_dpr_state, make_dpr_eval_step, make_dpr_train_step,
)
from pixelsynth_tpu_torch.train.schedulers import niter_schedule
from pixelsynth_tpu_torch.weights import from_jax_params

from test_train_loops import tiny_cfg
from torch_train_ref import (  # noqa: F401
    _few_torch_threads, flat, grads_in_port_layout, jax_float64, tiny_variables, to64,
)

STEPS = 4
NOISE_SZ = 20
REL = 1e-9            # of a leaf's largest value: the U-Net, the decoder, D
ROUNDOFF = 1e-13      # absolute, on the gradients of `_roundoff_leaf`
# the metrics that no float32 part computes (the PixelCNN feeds
# autoreg_loss, Total Loss and G_total; the ssim metrics are float32 in
# both packages)
EXACT_METRICS = ("L1", "Perceptual", "GAN", "GAN_Feat", "D_Fake", "D_real",
                 "D_total", "psnr", "psnr_std")
_BANK = {"rows": None, "i": 0}


def _roundoff_leaf(tree, name):
    """A gradient that is zero but for float64 rounding (module docstring)."""
    return tree == "unet" or (tree == "projector" and name.endswith(".SNConv_0.bias"))


class _Random:
    """jax.random with `normal` reading the bank (only NoiseBN draws from
    it inside a step)."""

    def __getattr__(self, name):
        return getattr(jax.random, name)

    @staticmethod
    def normal(key, shape, dtype=None):
        row = _BANK["rows"][_BANK["i"]]
        _BANK["i"] += 1
        assert tuple(shape) == row.shape, (shape, row.shape)
        return row.astype(dtype) if dtype is not None else row


class _Jax:
    random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_step(jps, tx_g, tx_d):
    """dpr.py's step body with the NoiseBN draws from `bank`; returns the
    state it carries, the gradients it gives each optimizer and the
    metrics."""
    cfg = jps.cfg

    def disc_apply(disc_vars):
        def apply(x, train=True):
            out = jps.disc.apply(disc_vars, x, train=train,
                                 mutable=["spectral_stats"] if train else False)
            return out[0] if train else out
        return apply

    def step(gen_vars, disc_vars, frozen_vars, opt_g, opt_d, batch, bank):
        _BANK["rows"], _BANK["i"] = bank, 0

        def g_loss_fn(gen_params):
            total, (losses, outputs, updates) = jps.train_forward(
                _with_params(gen_vars, gen_params), frozen_vars, batch,
                {"noise": jax.random.PRNGKey(1)})
            pf, pr = discriminator_scores(disc_apply(disc_vars), outputs["PredImg"],
                                          outputs["OutputImg"], train=False)
            g = hinge_g_loss(pf, pr, lambda_feat=cfg.loss.lambda_feat,
                             feat_match=not cfg.loss.no_ganFeat_loss)
            losses.update({k: v for k, v in g.items() if k != "Total Loss"})
            return total + g["Total Loss"], (losses, outputs, updates)

        gen_params = _params_of(gen_vars)
        (g_total, (losses, outputs, updates)), grads = jax.value_and_grad(
            g_loss_fn, has_aux=True)(gen_params)
        upd, opt_g = tx_g.update(grads, opt_g, gen_params)
        gen_vars = _with_params(_merge_updates(gen_vars, updates),
                                optax.apply_updates(gen_params, upd))
        pred = jax.lax.stop_gradient(outputs["PredImg"])
        gt = outputs["OutputImg"]

        def d_loss_fn(dp):
            pf, pr = discriminator_scores(disc_apply({**disc_vars, "params": dp}),
                                          pred, gt, train=False)
            d = hinge_d_loss(pf, pr)
            return d["Total Loss"], d

        (d_total, d_losses), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
            disc_vars["params"])
        upd, opt_d = tx_d.update(d_grads, opt_d, disc_vars["params"])
        disc_vars = {**disc_vars, "params": optax.apply_updates(disc_vars["params"], upd)}
        _, disc_upd = jps.disc.apply(disc_vars, jnp.concatenate([pred, gt], 0),
                                     train=True, mutable=["spectral_stats"])
        disc_vars = {**disc_vars, **disc_upd}
        metrics = dict(losses)
        metrics.update({k: v for k, v in d_losses.items() if k != "Total Loss"})
        metrics["G_total"], metrics["D_total"] = g_total, d_total
        return gen_vars, disc_vars, opt_g, opt_d, grads, d_grads, metrics

    return step


def _blend_rounded_like_jax(forward):
    """The plain blend's output rounded to float32, as the JAX package's
    contraction returns it."""
    def blend(*args):
        out, cov = forward(*args)
        return out.float().to(out.dtype), cov
    return blend


def _port64(cfg, variables):
    ps = PixelSynth(cfg, device="cpu", trainable=True,
                    state_dicts=from_jax_params(variables, cfg, trainable=True))
    for tree in ps.trees:
        if tree != "pixelcnn":
            getattr(ps, tree).double()
    return ps


def _spy(state, seen):
    """Record the gradients each optimizer is given."""
    for name, tx in (("g", state.tx_g), ("d", state.tx_d)):
        def spy(grads, _name=name, _update=tx.update):
            seen[_name] = [g.detach().clone() for g in grads]
            return _update(grads)
        tx.update = spy


def _named_grads(ps, seen):
    g_iter = iter(seen["g"])
    out = {t: {n: next(g_iter) for n, _ in getattr(ps, t).named_parameters()}
           for t in TRAINABLE}
    assert next(g_iter, None) is None
    out["disc"] = dict(zip((n for n, _ in ps.disc.named_parameters()), seen["d"],
                           strict=True))
    return out


def _carried(ps, state):
    """What the port carries out of a step: every tree's parameters, Adam's
    moments and count, and the collections, as float64 numpy."""
    out = {}
    for t in TRAINABLE + ("disc",):
        mod = getattr(ps, t)
        tx = state.tx_d if t == "disc" else state.tx_g
        named = list(mod.named_parameters())
        out[t] = {
            "params": {n: p.detach().double().numpy().copy() for n, p in named},
            "mu": {n: tx.opt.state[p]["exp_avg"].double().numpy().copy() for n, p in named},
            "nu": {n: tx.opt.state[p]["exp_avg_sq"].double().numpy().copy()
                   for n, p in named},
            "steps": {float(tx.opt.state[p]["step"]) for _, p in named},
            "count": tx.count,
            "stats": jax.tree_util.tree_map(lambda a: a.detach().double().numpy().copy(),
                                            collections(mod)),
        }
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_cfg(32)
    cfg = Config.from_json(jcfg.to_json())
    jcfg.model.splat.blend_dtype = "float64"
    jps = JaxPixelSynth(jcfg)
    variables = tiny_variables(jps, cfg, seed=1)
    rng = np.random.default_rng(1)
    batches = [synthetic_pair_batch(rng, 2, jcfg.model.W) for _ in range(STEPS)]
    n_noise = sum(k.endswith("gain_kernel") for k in flat(variables["projector"]))
    banks = [rng.normal(size=(n_noise, 2, NOISE_SZ)) for _ in range(STEPS)]

    # ---- JAX: one compile, STEPS carried steps ----
    jax_runs = []
    with jax_float64(), mock.patch.object(jax_layers, "jax", _Jax()):
        state, tx_g, tx_d = jax_create_state(jps, to64(variables))
        step = jax.jit(_jax_step(jps, tx_g, tx_d))
        carry = (state.gen_vars, state.disc_vars, state.frozen_vars, state.opt_g,
                 state.opt_d)
        for b, bank in zip(batches, banks):
            # the carry through numpy, so that every call has the first's
            # signature (one compile)
            out = step(*to64(carry), to64(b), jnp.asarray(bank))
            assert _BANK["i"] == n_noise   # every row was drawn, once
            carry = (out[0], out[1], carry[2], out[2], out[3])
            jax_runs.append(jax.tree_util.tree_map(np.asarray, out))

    # ---- the port: the same STEPS steps with the bank's draws ----
    ps = _port64(cfg, variables)
    before = {t: {n: p.detach().clone() for n, p in getattr(ps, t).named_parameters()}
              for t in TRAINABLE + ("disc",)}
    pstate = create_dpr_state(ps)
    seen = {}
    _spy(pstate, seen)
    pstep = make_dpr_train_step(ps, pstate)
    rows = []
    forward = port_layers.NoiseBN.forward

    def noise_from_bank(self, x, *, noise_scale=1.0, gen=None, noise=None):
        if noise is None and noise_scale != 0.0:
            noise = rows.pop(0)
        return forward(self, x, noise_scale=noise_scale, gen=gen, noise=noise)

    port_runs = []
    blend = _blend_rounded_like_jax(port_splat._blend_forward)
    with mock.patch.object(port_splat, "_blend_forward", blend), \
            mock.patch.object(port_layers.NoiseBN, "forward", noise_from_bank):
        for b, bank in zip(batches, banks):
            rows.extend(torch.tensor(r) for r in bank)
            m = pstep({k: torch.tensor(v, dtype=torch.float64) for k, v in b.items()},
                      torch.Generator())
            assert not rows
            port_runs.append((_carried(ps, pstate), {k: float(v) for k, v in m.items()},
                              _named_grads(ps, seen)))
    return dict(cfg=cfg, variables=variables, before=before, jax_runs=jax_runs,
                port_runs=port_runs, n_noise=n_noise)


def _assert_leaves(got, want, label, *, rel=REL, atol=0.0):
    assert set(got) == set(want), label
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, (label, k)
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()) + atol, (label, k, err)


@pytest.mark.parametrize("tree", TRAINABLE + ("disc",))
def test_step_gradients_match_jax(setup, tree):
    """The gradients the step gives its optimizers, against the JAX step's:
    G's of the whole G loss (synthesis, perceptual, AR, hinge and feature
    matching through D in eval), D's of the hinge D loss on the detached
    prediction; each leaf to 1e-9 of its max |g| (measured: the decoder
    1.2e-12, D 6.5e-14), the leaves of `_roundoff_leaf` to 1e-13 absolute
    (measured 8.0e-15), the PixelCNN's to 1e-4 x its max |g| + 1e-6
    (float32; measured 1.0e-6 of its max)."""
    cfg, variables = setup["cfg"], setup["variables"]
    _, _, _, _, grads, d_grads, _ = setup["jax_runs"][0]
    g_tree = d_grads if tree == "disc" else grads[tree]
    want = grads_in_port_layout(cfg, variables, g_tree, tree)
    got = {n: g.double().numpy() for n, g in setup["port_runs"][0][2][tree].items()}
    if tree == "pixelcnn":
        _assert_leaves(got, want, tree, rel=1e-4, atol=1e-6)
        return
    for name in want:
        if _roundoff_leaf(tree, name):
            _assert_leaves({name: got[name]}, {name: want[name]}, tree, rel=0.0,
                           atol=ROUNDOFF)
        else:
            _assert_leaves({name: got[name]}, {name: want[name]}, tree)


def _adam_first(g, lr):
    """Adam's first update with beta1 = 0: -lr g / (|g| + eps)."""
    return -lr * g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("tree", TRAINABLE + ("disc",))
def test_step_parameters_match_jax(setup, tree):
    """Each parameter after the step against the JAX step's, to 1e-9 of the
    leaf's largest value (measured: decoder 1.3e-10, U-Net 5.0e-11, D
    6.3e-13).  The PixelCNN's update lies in the band that its gradient
    tolerance (1e-4 x the leaf's max |g| + 1e-6) spans through Adam's first
    update, and so does the JAX step's."""
    cfg, variables = setup["cfg"], setup["variables"]
    gen_vars, disc_vars, _, _, grads, _, _ = setup["jax_runs"][0]
    new = disc_vars["params"] if tree == "disc" else gen_vars[tree]["params"]
    want_new = grads_in_port_layout(cfg, variables, new, tree)
    got = setup["port_runs"][0][0][tree]["params"]
    if tree != "pixelcnn":
        _assert_leaves(got, want_new, tree)
        return
    lr = cfg.train.lr_g
    g = grads_in_port_layout(cfg, variables, grads[tree], tree)
    for name, p in got.items():
        old = setup["before"][tree][name].double().numpy()
        moved, moved_jax = p - old, want_new[name] - old
        tol = 1e-4 * np.abs(g[name]).max() + 1e-6
        lo, hi = _adam_first(g[name] + tol, lr), _adam_first(g[name] - tol, lr)
        slack = 1e-6 * lr + 1e-7 * np.abs(old)
        for m in (moved, moved_jax):
            assert np.all(m >= lo - slack) and np.all(m <= hi + slack), name
        assert np.abs(moved).max() <= lr * (1 + 1e-6) + 1e-7 * np.abs(old).max(), name


@pytest.mark.parametrize("tree", ["unet", "projector", "disc"])
def test_step_statistics_match_jax(setup, tree):
    """G's batch statistics and spectral vectors after its train forward,
    and D's spectral vectors after the one advance, to 1e-9 of each leaf's
    largest value (measured <= 4.9e-14)."""
    gen_vars, disc_vars = setup["jax_runs"][0][:2]
    want_tree = disc_vars if tree == "disc" else gen_vars[tree]
    mine = setup["port_runs"][0][0][tree]["stats"]
    for col in ("batch_stats", "spectral_stats"):
        if col not in want_tree:
            assert col not in mine
            continue
        _assert_leaves(flat(mine[col]), flat(want_tree[col]), (tree, col))


def test_step_metrics_match_jax(setup):
    """Every metric to rtol 1e-9 (measured <= 2.8e-15), but for those a
    float32 part computes, held to rtol 1e-5: autoreg_loss and the totals
    that add it (the PixelCNN; measured 3.8e-8), the ssim metrics (float32
    in both packages; 2.4e-7)."""
    want = setup["jax_runs"][0][6]
    got = setup["port_runs"][0][1]
    assert set(got) == set(want)
    for k, w in want.items():
        rtol = 1e-9 if k in EXACT_METRICS else 1e-5
        np.testing.assert_allclose(float(got[k]), float(w), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_carried_state_matches_jax(setup, i):
    """After step i of STEPS with the noise on, each side from the state it
    carried out of the step before: the parameters, Adam's moments (mu and
    nu) and its count, G's batch statistics and spectral vectors and D's
    spectral vectors, to 1e-9 of each leaf's largest value for the U-Net,
    the decoder and D (measured: parameters <= 4.3e-10, statistics <=
    3.3e-11, moments <= 2.3e-12); the moments of the leaves of
    `_roundoff_leaf` to 1e-13 absolute (their squares 1e-26; measured
    3.2e-14); the PixelCNN's parameters within 2 lr_g a step of JAX's
    (float32: a sign flip of a small gradient moves an element by up to 2
    lr; measured 5.4e-6 = 0.07 lr) and its moments to 1e-4 of their max
    (measured 3.8e-6)."""
    cfg, variables = setup["cfg"], setup["variables"]
    gen_vars, disc_vars, opt_g, opt_d, _, _, jm = setup["jax_runs"][i]
    carried, pm, _ = setup["port_runs"][i]
    for k in EXACT_METRICS:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-9, err_msg=(i, k))
    for tree in TRAINABLE + ("disc",):
        c = carried[tree]
        var = variables["disc"] if tree == "disc" else variables[tree]
        adam = (opt_d if tree == "disc" else opt_g)[0]
        mu = adam.mu if tree == "disc" else adam.mu[tree]
        nu = adam.nu if tree == "disc" else adam.nu[tree]
        new = disc_vars["params"] if tree == "disc" else gen_vars[tree]["params"]
        assert int(adam.count) == c["count"] == i + 1 and c["steps"] == {float(i + 1)}
        want = {"params": grads_in_port_layout(cfg, {tree: var}, new, tree),
                "mu": grads_in_port_layout(cfg, {tree: var}, mu, tree),
                "nu": grads_in_port_layout(cfg, {tree: var}, nu, tree)}
        if tree == "pixelcnn":
            _assert_leaves(c["params"], want["params"], (i, tree), rel=0.0,
                           atol=2 * cfg.train.lr_g * (i + 1))
            for part in ("mu", "nu"):
                _assert_leaves(c[part], want[part], (i, tree, part), rel=1e-4)
            continue
        _assert_leaves(c["params"], want["params"], (i, tree))
        for part, atol in (("mu", ROUNDOFF), ("nu", ROUNDOFF ** 2)):
            for name in want[part]:
                exact = not _roundoff_leaf(tree, name)
                _assert_leaves({name: c[part][name]}, {name: want[part][name]},
                               (i, tree, part), rel=REL if exact else 0.0,
                               atol=0.0 if exact else atol)
        want_tree = disc_vars if tree == "disc" else gen_vars[tree]
        for col in ("batch_stats", "spectral_stats"):
            if col in want_tree:
                _assert_leaves(flat(c["stats"][col]), flat(want_tree[col]), (i, tree, col))
    assert setup["n_noise"] > 0


def test_port_step_with_noise_changes_every_tree():
    """The port's own step at noise_scale 1 (NoiseBN draws from the
    generator): finite losses; every trainable tree's parameters, the
    batch statistics and D's parameters move, and each tree's spectral
    vectors (a vector converged at init to the last bit may stay); the eval
    step leaves everything as it was."""
    cfg = Config.from_json(tiny_cfg().to_json())
    ps = PixelSynth(cfg, device="cpu", seed=3, trainable=True)
    state = create_dpr_state(ps)
    step = make_dpr_train_step(ps, state)
    evaluate = make_dpr_eval_step(ps)
    from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch as batch_of

    b = batch_of(np.random.default_rng(4), 2, cfg.model.W)
    trees = TRAINABLE + ("disc",)
    snap = {t: {k: v.clone() for k, v in getattr(ps, t).state_dict().items()}
            for t in trees}
    gen = torch.Generator().manual_seed(0)
    evaluate(b, gen)
    for t in trees:
        for k, v in getattr(ps, t).state_dict().items():
            assert torch.equal(v, snap[t][k]), (t, k)
    m = step(b, gen)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert state.step == 1 and state.tx_g.count == 1 and state.tx_d.count == 1
    for t in trees:
        now = getattr(ps, t).state_dict()
        params = [k for k, _ in getattr(ps, t).named_parameters()]
        assert any(not torch.equal(now[k], snap[t][k]) for k in params), t
        for k in now:
            if k.split(".")[-1] in ("mean", "var"):
                assert not torch.equal(now[k], snap[t][k]), (t, k)
        us = [k for k in now if k.split(".")[-1] in ("u", "u_gain", "u_bias")]
        assert not us or any(not torch.equal(now[k], snap[t][k]) for k in us), t


@pytest.mark.parametrize("k,niter", [(1, None), (2, 1), (3, 0)])
def test_adam_matches_optax(k, niter):
    """The port's Adam (betas (0, 0.9), eps outside the root) with the niter
    linear decay and k-step gradient averaging against
    optax.MultiSteps(optax.adam(join_schedules(...)), k) over 7 steps."""
    rng = np.random.default_rng(k)
    p0 = rng.normal(size=(5, 3))
    grads = [rng.normal(size=(5, 3)) * 10.0 ** rng.uniform(-9, 0) for _ in range(7)]
    peak, spe, decay = 1e-3, 2, 2
    if niter is None:
        sched = peak
    else:
        sched = optax.schedules.join_schedules(
            [optax.constant_schedule(peak),
             optax.linear_schedule(peak, 0.0, decay * spe)], [niter * spe])
    tx = optax.adam(sched, b1=0.0, b2=0.9)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    with jax.enable_x64(True):
        params = jnp.asarray(p0)
        st = tx.init(params)
        for g in grads:
            upd, st = tx.update(jnp.asarray(g), st, params)
            params = optax.apply_updates(params, upd)
        want = np.asarray(params)
    p = torch.nn.Parameter(torch.as_tensor(p0))
    lr = peak if niter is None else niter_schedule(peak, niter * spe, decay * spe)
    opt = Adam([p], lr, (0.0, 0.9), k=k)
    for g in grads:
        opt.update([torch.as_tensor(g)])
    # optax evaluates a schedule's learning rate in float32: 7 updates of
    # <= 1e-3 each move by up to ~7 x 6e-11 from the float64 rate's
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-9)
    assert opt.count == len(grads) // k
