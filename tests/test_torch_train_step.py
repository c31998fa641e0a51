"""One whole G+D step of the port (train/dpr.py) against a JAX step
assembled from the JAX package's public pieces in the order of its
`make_dpr_train_step` (dpr.py:122-185) at noise_scale 0, on the tiny config
of tests/test_train_loops.py: the G loss with D scored in eval, Adam on G
with G's batch / spectral statistics merged, the D hinge loss on the
detached prediction, Adam on D, then one train forward of D on fake ||
real that only advances D's spectral vectors.  Both sides in float64 (the
PixelCNN's plain masked conv in float32; tests/torch_train_ref.py).

Also: the port's optimizer against optax (the `niter` decay and the
`num_accumulations` MultiSteps), and the port's own step with noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsynth_tpu.data.synthetic import synthetic_pair_batch
from pixelsynth_tpu.models.losses import (
    discriminator_scores, hinge_d_loss, hinge_g_loss,
)
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.train.dpr import (
    _merge_updates, _params_of, _with_params, create_dpr_state as jax_create_state,
)
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.layers import collections
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


def _jax_step(jps, tx_g, tx_d):
    """dpr.py's step body with noise_scale=0.0 in train_forward."""
    cfg = jps.cfg

    def disc_apply(disc_vars):
        def apply(x, train=True):
            out = jps.disc.apply(disc_vars, x, train=train,
                                 mutable=["spectral_stats"] if train else False)
            return out[0] if train else out
        return apply

    def step(state, batch):
        def g_loss_fn(gen_params):
            gen_vars = _with_params(state.gen_vars, gen_params)
            total, (losses, outputs, updates) = jps.train_forward(
                gen_vars, state.frozen_vars, batch, {"noise": jax.random.PRNGKey(1)},
                noise_scale=0.0)
            pf, pr = discriminator_scores(disc_apply(state.disc_vars),
                                          outputs["PredImg"], outputs["OutputImg"],
                                          train=False)
            g = hinge_g_loss(pf, pr, lambda_feat=cfg.loss.lambda_feat,
                             feat_match=not cfg.loss.no_ganFeat_loss)
            losses.update({k: v for k, v in g.items() if k != "Total Loss"})
            return total + g["Total Loss"], (losses, outputs, updates)

        gen_params = _params_of(state.gen_vars)
        (g_total, (losses, outputs, updates)), grads = jax.value_and_grad(
            g_loss_fn, has_aux=True)(gen_params)
        upd, _ = tx_g.update(grads, state.opt_g, gen_params)
        gen_vars = _with_params(_merge_updates(state.gen_vars, updates),
                                optax.apply_updates(gen_params, upd))
        pred = jax.lax.stop_gradient(outputs["PredImg"])
        gt = outputs["OutputImg"]

        def d_loss_fn(dp):
            pf, pr = discriminator_scores(disc_apply({**state.disc_vars, "params": dp}),
                                          pred, gt, train=False)
            d = hinge_d_loss(pf, pr)
            return d["Total Loss"], d

        (d_total, d_losses), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
            state.disc_vars["params"])
        upd, _ = tx_d.update(d_grads, state.opt_d, state.disc_vars["params"])
        disc_vars = {**state.disc_vars,
                     "params": optax.apply_updates(state.disc_vars["params"], upd)}
        _, disc_upd = jps.disc.apply(disc_vars, jnp.concatenate([pred, gt], 0),
                                     train=True, mutable=["spectral_stats"])
        disc_vars = {**disc_vars, **disc_upd}
        metrics = dict(losses)
        metrics.update({k: v for k, v in d_losses.items() if k != "Total Loss"})
        metrics["G_total"], metrics["D_total"] = g_total, d_total
        return gen_vars, disc_vars, grads, d_grads, metrics

    return step


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_cfg()
    cfg = Config.from_json(jcfg.to_json())
    jps = JaxPixelSynth(jcfg)
    variables = tiny_variables(jps, cfg, seed=1)
    batch = synthetic_pair_batch(np.random.default_rng(1), 2, jcfg.model.W)
    with jax_float64():
        state, tx_g, tx_d = jax_create_state(jps, to64(variables))
        out = jax.jit(_jax_step(jps, tx_g, tx_d))(state, to64(batch))
        out = jax.tree_util.tree_map(np.asarray, out)

    ps = PixelSynth(cfg, device="cpu", trainable=True,
                    state_dicts=from_jax_params(variables, cfg, trainable=True))
    for tree in ps.trees:
        if tree != "pixelcnn":
            getattr(ps, tree).double()
    before = {t: {n: p.detach().clone() for n, p in getattr(ps, t).named_parameters()}
              for t in TRAINABLE + ("disc",)}
    state = create_dpr_state(ps)
    # the gradients the step hands each optimizer: d G_total / d G's
    # parameters and d D_total / d D's, in the optimizers' parameter order
    seen = {}
    for name, tx in (("g", state.tx_g), ("d", state.tx_d)):
        def spy(grads, _name=name, _update=tx.update):
            seen[_name] = [g.detach().clone() for g in grads]
            return _update(grads)
        tx.update = spy
    step = make_dpr_train_step(ps, state, noise_scale=0.0)
    metrics = step({k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()})
    port_grads = {}
    g_iter = iter(seen["g"])
    for t in TRAINABLE:
        port_grads[t] = {n: next(g_iter) for n, _ in getattr(ps, t).named_parameters()}
    assert next(g_iter, None) is None
    port_grads["disc"] = dict(zip((n for n, _ in ps.disc.named_parameters()),
                                  seen["d"], strict=True))
    return dict(cfg=cfg, variables=variables, jax=out, ps=ps, before=before,
                metrics=metrics, grads=port_grads)


@pytest.mark.parametrize("tree", TRAINABLE + ("disc",))
def test_step_gradients_match_jax(setup, tree):
    """The gradients the step gives its optimizers, against the JAX step's:
    G's of the whole G loss (synthesis, perceptual, AR, hinge and feature
    matching through D in eval), D's of the hinge D loss on the detached
    prediction; every leaf to <= 1e-4 x its max |g| + 1e-6, the bound of
    test_torch_train_forward's gradients."""
    cfg, variables = setup["cfg"], setup["variables"]
    _, _, grads, d_grads, _ = setup["jax"]
    g_tree = d_grads if tree == "disc" else grads[tree]
    want = grads_in_port_layout(cfg, variables, g_tree, tree)
    got = setup["grads"][tree]
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].double().numpy()
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (name, err)


def _adam_first(g, lr):
    """Adam's first update with beta1 = 0: -lr g / (|g| + eps)."""
    return -lr * g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("tree", TRAINABLE + ("disc",))
def test_step_parameters_match_jax(setup, tree):
    """Each parameter's update against the JAX step's gradient: within the
    band that the gradient tolerance of test_torch_train_forward (1e-4 x
    the leaf's max |g| + 1e-6) spans through Adam's first update, and the
    JAX step's own update inside that band."""
    cfg, variables = setup["cfg"], setup["variables"]
    gen_vars, disc_vars, grads, d_grads, _ = setup["jax"]
    if tree == "disc":
        lr, g_tree, new = cfg.train.lr_d, d_grads, disc_vars["params"]
    else:
        lr, g_tree, new = cfg.train.lr_g, grads[tree], gen_vars[tree]["params"]
    g = grads_in_port_layout(cfg, variables, g_tree, tree)
    want_new = grads_in_port_layout(cfg, variables, new, tree)
    ps = setup["ps"]
    for name, p in getattr(ps, tree).named_parameters():
        old = setup["before"][tree][name].double().numpy()
        moved = p.detach().double().numpy() - old
        moved_jax = want_new[name] - old
        tol = 1e-4 * np.abs(g[name]).max() + 1e-6
        lo, hi = _adam_first(g[name] + tol, lr), _adam_first(g[name] - tol, lr)
        slack = 1e-6 * lr + 1e-7 * np.abs(old)
        for m in (moved, moved_jax):
            assert np.all(m >= lo - slack) and np.all(m <= hi + slack), name
        assert np.abs(moved).max() <= lr * (1 + 1e-6) + 1e-7 * np.abs(old).max(), name


@pytest.mark.parametrize("tree", ["unet", "projector", "disc"])
def test_step_statistics_match_jax(setup, tree):
    """G's batch statistics and spectral vectors after its train forward,
    and D's spectral vectors after the one advance, to 1e-5 of each leaf."""
    gen_vars, disc_vars, _, _, _ = setup["jax"]
    want_tree = disc_vars if tree == "disc" else gen_vars[tree]
    mine = collections(getattr(setup["ps"], tree))
    for col in ("batch_stats", "spectral_stats"):
        if col not in want_tree:
            assert col not in mine
            continue
        want, got = flat(want_tree[col]), flat(mine[col])
        assert set(got) == set(want), col
        for k, w in want.items():
            err = float(np.abs(got[k].double().numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (col, k, err)


def test_step_metrics_match_jax(setup):
    want = setup["jax"][4]
    got = setup["metrics"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5, err_msg=k)


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
