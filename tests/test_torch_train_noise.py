"""Three consecutive G+D steps of the port (train/dpr.py) against three of
the JAX step with the NoiseBN noise ON: the same (B, 20) draws injected
into both packages, each step from the state each side carried out of
the step before.  The configuration and the JAX step are those of
tests/test_torch_train_step.py (the tiny config at W=32, one initial
state through `weights.from_jax_params(..., trainable=True)`, both sides
in float64, the PixelCNN's plain masked conv in float32).

The noise goes in where each package draws it: the JAX layers' one
`jax.random.normal` call (NoiseBN, models/layers.py:216) takes the next
row of a bank passed to the jitted step, and the port's `NoiseBN.forward`
takes the same row through its `noise=` argument.  After every step:
L1, G_total and D_total; every gradient each optimizer is given, to
1e-4 x the leaf's max |g| + 1e-6 (the bound of
test_step_gradients_match_jax); and the U-Net's and the decoder's batch
statistics (the NoiseBN layers' running mean and variance among them) and
spectral vectors, to 1e-5 of each leaf."""

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
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.train.dpr import TRAINABLE, create_dpr_state, make_dpr_train_step
from pixelsynth_tpu_torch.weights import from_jax_params

from test_train_loops import tiny_cfg
from torch_train_ref import (  # noqa: F401
    _few_torch_threads, flat, grads_in_port_layout, jax_float64, tiny_variables, to64,
)

STEPS = 3
NOISE_SZ = 20
_BANK = {"rows": None, "i": 0}


class _Random:
    """jax.random with `normal` reading the bank (only NoiseBN draws from
    it inside a step)."""

    def __getattr__(self, name):
        return getattr(jax.random, name)

    @staticmethod
    def normal(key, shape, dtype=None):
        i = _BANK["i"]
        _BANK["i"] += 1
        row = _BANK["rows"][i]
        assert tuple(shape) == row.shape, (shape, row.shape)
        return row.astype(dtype) if dtype is not None else row


class _Jax:
    random = _Random()

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_step(jps, tx_g, tx_d):
    """dpr.py:122-185's step at noise_scale 1, returning the state it
    carries and the gradients it gives each optimizer."""
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

        (d_total, _), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
            disc_vars["params"])
        upd, opt_d = tx_d.update(d_grads, opt_d, disc_vars["params"])
        disc_vars = {**disc_vars, "params": optax.apply_updates(disc_vars["params"], upd)}
        _, disc_upd = jps.disc.apply(disc_vars, jnp.concatenate([pred, gt], 0),
                                     train=True, mutable=["spectral_stats"])
        disc_vars = {**disc_vars, **disc_upd}
        metrics = {"L1": losses["L1"], "G_total": g_total, "D_total": d_total}
        return gen_vars, disc_vars, opt_g, opt_d, grads, d_grads, metrics

    return step


@pytest.fixture(scope="module")
def runs():
    jcfg = tiny_cfg(32)
    cfg = Config.from_json(jcfg.to_json())
    jps = JaxPixelSynth(jcfg)
    variables = tiny_variables(jps, cfg, seed=1)
    rng = np.random.default_rng(1)
    batches = [synthetic_pair_batch(rng, 2, jcfg.model.W) for _ in range(STEPS)]
    n_noise = sum(k.endswith("gain_kernel") for k in flat(variables["projector"]))
    banks = [rng.normal(size=(n_noise, 2, NOISE_SZ)) for _ in range(STEPS)]

    jax_out = []
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
            jax_out.append(jax.tree_util.tree_map(np.asarray, (out[0], out[4], out[5],
                                                               out[6])))

    ps = PixelSynth(cfg, device="cpu", trainable=True,
                    state_dicts=from_jax_params(variables, cfg, trainable=True))
    for tree in ps.trees:
        if tree != "pixelcnn":
            getattr(ps, tree).double()
    state = create_dpr_state(ps)
    seen = {}
    for name, tx in (("g", state.tx_g), ("d", state.tx_d)):
        def spy(grads, _name=name, _update=tx.update):
            seen[_name] = [g.detach().clone() for g in grads]
            return _update(grads)
        tx.update = spy
    rows = []
    forward = port_layers.NoiseBN.forward

    def noise_from_bank(self, x, *, noise_scale=1.0, gen=None, noise=None):
        if noise is None and noise_scale != 0.0:
            noise = rows.pop(0)
        return forward(self, x, noise_scale=noise_scale, gen=gen, noise=noise)

    step = make_dpr_train_step(ps, state)
    port_out = []
    with mock.patch.object(port_layers.NoiseBN, "forward", noise_from_bank):
        for b, bank in zip(batches, banks):
            rows.extend(torch.tensor(r) for r in bank)
            m = step({k: torch.tensor(v, dtype=torch.float64) for k, v in b.items()},
                     torch.Generator())
            assert not rows
            g_iter = iter(seen["g"])
            grads = {t: {n: next(g_iter) for n, _ in getattr(ps, t).named_parameters()}
                     for t in TRAINABLE}
            assert next(g_iter, None) is None
            grads["disc"] = dict(zip((n for n, _ in ps.disc.named_parameters()),
                                     seen["d"], strict=True))
            stats = {t: jax.tree_util.tree_map(lambda a: a.detach().clone().numpy(),
                                               collections(getattr(ps, t)))
                     for t in ("unet", "projector")}
            port_out.append((grads, {k: float(m[k]) for k in ("L1", "G_total", "D_total")},
                             stats))
    return dict(cfg=cfg, variables=variables, jax=jax_out, port=port_out,
                n_noise=n_noise)


@pytest.mark.parametrize("i", range(STEPS))
def test_noise_step_metrics_match_jax(runs, i):
    """L1, G_total and D_total of step i (rtol 1e-5, as test_step_metrics)."""
    assert runs["n_noise"] > 0
    _, _, _, want = runs["jax"][i]
    got = runs["port"][i][1]
    for k in ("L1", "G_total", "D_total"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_noise_step_gradients_match_jax(runs, i):
    """Every gradient G's and D's optimizers are given at step i, each leaf
    to <= 1e-4 x its max |g| + 1e-6."""
    cfg, variables = runs["cfg"], runs["variables"]
    _, grads, d_grads, _ = runs["jax"][i]
    for tree in TRAINABLE + ("disc",):
        want = grads_in_port_layout(cfg, variables,
                                    d_grads if tree == "disc" else grads[tree], tree)
        got = runs["port"][i][0][tree]
        assert set(got) == set(want)
        for name, w in want.items():
            err = float(np.abs(got[name].double().numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (i, tree, name, err)


@pytest.mark.parametrize("i", range(STEPS))
def test_noise_step_statistics_match_jax(runs, i):
    """The U-Net's and the decoder's batch statistics (NoiseBN's running
    mean and variance among them) and spectral vectors after step i, to
    1e-5 of each leaf."""
    gen_vars = runs["jax"][i][0]
    stats = runs["port"][i][2]
    for tree in ("unet", "projector"):
        for col in ("batch_stats", "spectral_stats"):
            want, got = flat(gen_vars[tree][col]), flat(stats[tree][col])
            assert set(got) == set(want), (tree, col)
            for k, w in want.items():
                err = float(np.abs(got[k] - w).max())
                assert err <= 1e-5 * float(np.abs(w).max()), (i, tree, col, k, err)
    assert any("NoiseBN" in k for k in flat(stats["projector"]["batch_stats"]))
