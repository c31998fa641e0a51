"""The port's stage-1 trainer (models/vqvae.py in train mode, train/vqvae.py)
against the JAX package's, on a tiny VQ-VAE (channel 16, n_res_channel 8,
embed_dim 8, 32 codes, 32x32 images): the quantizer's train forward and
EMA buffers, the model's (recon, diff) and code ids, one train step's
gradients, parameters and EMA collection, the data-dependent codebook
init given JAX's draws, and the serving encode.  Both sides in float64
(tests/torch_train_ref.py) unless a test says otherwise."""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsynth_tpu.models.vqvae import Quantize as JaxQuantize
from pixelsynth_tpu.models.vqvae import VQVAETop as JaxVQVAETop
from pixelsynth_tpu.train import vqvae as jax_vq
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.vqvae import Quantize, VQVAETop
from pixelsynth_tpu_torch.train.dpr import Adam
from pixelsynth_tpu_torch.train.vqvae import (
    LATENT_LOSS_WEIGHT, VQTrainState, create_vqvae_state, init_codebook_from_batch,
    make_vqvae_train_step,
)
from pixelsynth_tpu_torch.weights import from_jax_params, merge_collections

from test_train_loops import tiny_cfg
from torch_train_ref import _few_torch_threads, flat, to64  # noqa: F401

DIMS = dict(channel=16, n_res_block=2, n_res_channel=8, embed_dim=8, n_embed=32)
W, B = 32, 2


def _img(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (B, W, W, 3))


def _port(variables, dtype=torch.float64):
    m = VQVAETop(3, DIMS["channel"], DIMS["n_res_block"], DIMS["n_res_channel"],
                 DIMS["embed_dim"], DIMS["n_embed"])
    with torch.no_grad():
        m.load_flax(merge_collections(variables))
    return m.to(dtype)


def _np(t):
    return t.detach().double().numpy()


def _close(got, want, rtol=1e-9):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-300), err


@pytest.fixture(scope="module")
def jax_model():
    model = JaxVQVAETop(**DIMS)
    variables = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, W, W, 3)))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def test_quantize_train_forward_and_ema_match_jax():
    """Quantize in train mode: quantized, diff, ids, then cluster_size,
    embed_avg and embed after the EMA update (float64, 1e-9 relative)."""
    q = JaxQuantize(dim=8, n_embed=16)
    x = np.random.default_rng(0).normal(size=(3, 5, 8))
    v32 = q.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8)), train=False)
    with jax.enable_x64(True):
        v = to64(v32)
        (qz, diff, idx), upd = q.apply(v, jnp.asarray(x), train=True, mutable=["ema"])
    port = Quantize(8, 16).double()
    with torch.no_grad():
        port.load_flax(v["ema"])
    xt = torch.tensor(x, requires_grad=True)
    got_q, got_diff, got_idx = port.quantize(xt)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx))
    _close(_np(got_q), qz)
    _close(np.float64(got_diff.detach()), diff)
    for name in ("cluster_size", "embed_avg", "embed"):
        _close(_np(getattr(port, name)), upd["ema"][name])
    # the straight-through gradient reaches x, d(diff)/dx = 2 (x - q) / n
    g = torch.autograd.grad(got_q.sum() + got_diff, xt)[0]
    want_g = 1.0 + 2.0 * (x - np.asarray(qz)) / x.size
    _close(_np(g), want_g)
    # eval mode leaves the buffers as they are
    before = port.embed.clone()
    port.eval()
    port.quantize(xt)
    assert torch.equal(port.embed, before)


def test_forward_and_encode_match_jax(jax_model):
    """(recon, diff) in eval and the full encode's ids (exact) against JAX;
    the serving `encode` gives the same top ids."""
    model, variables = jax_model
    img = _img(1)
    with jax.enable_x64(True):
        v64 = to64(variables)
        # jitted: one compile costs less than the operations one by one
        recon, diff = jax.jit(functools.partial(model.apply, train=False))(
            v64, jnp.asarray(img))
        _, _, _, id_t, id_b = jax.jit(functools.partial(
            model.apply, train=False, method=model.encode))(v64, jnp.asarray(img))
    port = _port(variables).eval()
    with torch.no_grad():
        got_recon, got_diff = port(torch.tensor(img))
        _, _, _, gid_t, gid_b = port.encode_full(torch.tensor(img))
        serving = port.encode(torch.tensor(img))
    _close(_np(got_recon), recon)
    _close(np.float64(got_diff), diff)
    assert np.array_equal(gid_t.numpy(), np.asarray(id_t))
    assert np.array_equal(gid_b.numpy(), np.asarray(id_b))
    assert torch.equal(serving, gid_t)


def _jax_step(model, tx, variables, img):
    """train/vqvae.py:100-115's step body, returning its gradients too."""

    def loss_fn(params):
        (recon, diff), upd = model.apply({**variables, "params": params}, img,
                                         train=True, mutable=["ema"])
        mse = jnp.mean((recon - img) ** 2)
        return mse + jax_vq.LATENT_LOSS_WEIGHT * diff, (mse, diff, upd)

    (loss, (mse, diff, upd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    return dict(loss=loss, mse=mse, latent=diff), grads, params, upd["ema"]


@pytest.fixture(scope="module")
def step_setup(jax_model):
    model, variables = jax_model
    img = _img(2)
    tx = optax.adam(3e-4)
    with jax.enable_x64(True):
        out = jax.jit(lambda v, x: _jax_step(model, tx, v, x))(to64(variables),
                                                               jnp.asarray(img))
        out = jax.tree_util.tree_map(np.asarray, out)
    port = _port(variables).requires_grad_(True)
    state = VQTrainState(port, Adam(port.parameters(), 3e-4, (0.9, 0.999)))
    seen = {}
    update = state.opt.update

    def spy(grads):
        seen["g"] = [g.detach().clone() for g in grads]
        return update(grads)

    state.opt.update = spy
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    metrics = make_vqvae_train_step(port, state)(torch.tensor(img))
    grads = dict(zip((n for n, _ in port.named_parameters()), seen["g"], strict=True))
    return dict(variables=variables, jax=out, port=port, state=state, grads=grads,
                before=before, metrics=metrics)


def _in_port_layout(variables, params_tree):
    m = _port({**variables, "params": params_tree})
    return {n: _np(p) for n, p in m.named_parameters()}


def test_train_step_gradients_match_jax(step_setup):
    """Every gradient leaf of MSE + 0.25 diff to <= 1e-4 x its max|g| +
    1e-6 (the bound of test_torch_train_forward), and the metrics."""
    _, grads, _, _ = step_setup["jax"]
    want = _in_port_layout(step_setup["variables"], grads)
    got = step_setup["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(_np(got[name]) - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (name, err)
    for k, w in step_setup["jax"][0].items():
        np.testing.assert_allclose(float(step_setup["metrics"][k]), float(w), rtol=1e-9)
    assert LATENT_LOSS_WEIGHT == jax_vq.LATENT_LOSS_WEIGHT


def test_train_step_parameters_and_ema_match_jax(step_setup):
    """Adam's first update against the JAX step's, within the band the
    gradient tolerance spans (Adam's first update is -lr g / (|g| + eps));
    the EMA collection after the step to 1e-9 of each leaf."""
    _, grads, params, ema = step_setup["jax"]
    variables = step_setup["variables"]
    g = _in_port_layout(variables, grads)
    new = _in_port_layout(variables, params)
    lr = 3e-4
    for name, p in step_setup["port"].named_parameters():
        old = _np(step_setup["before"][name])
        tol = 1e-4 * np.abs(g[name]).max() + 1e-6
        lo = -lr * (g[name] + tol) / (np.abs(g[name] + tol) + 1e-8)
        hi = -lr * (g[name] - tol) / (np.abs(g[name] - tol) + 1e-8)
        slack = 1e-6 * lr + 1e-7 * np.abs(old)
        for moved in (_np(p) - old, new[name] - old):
            assert np.all(moved >= lo - slack) and np.all(moved <= hi + slack), name
    port = step_setup["port"]
    for q in ("quantize_t", "quantize_b"):
        for leaf in ("cluster_size", "embed_avg", "embed"):
            _close(_np(getattr(getattr(port, q), leaf)), ema[q][leaf])
    assert step_setup["state"].step == 1 and step_setup["state"].opt.count == 1


def test_init_codebook_from_batch_matches_jax(jax_model):
    """Given the JAX init's draws (the fold_in(key, 7) split, then per
    codebook randint ids and normal jitter), both codebooks equal JAX's to
    1e-6, cluster_size ones, embed_avg equal to embed in its own storage."""
    model, variables = jax_model
    img = _img(3)
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        v64 = to64(variables)
        want = jax_vq.init_codebook_from_batch(model, v64, jnp.asarray(img), key)["ema"]
        qt, _ = jax.jit(functools.partial(model.apply, method=model.pre_quantize))(
            v64, jnp.asarray(img))
        k_t, k_b = jax.random.split(jax.random.fold_in(key, 7))
        draws = {}
        for name, sub, n_lat in (("quantize_t", k_t, qt.shape[0] * qt.shape[1] * qt.shape[2]),
                                 ("quantize_b", k_b, B * (W // 4) ** 2)):
            k1, k2 = jax.random.split(sub)
            idx = jax.random.randint(k1, (DIMS["n_embed"],), 0, n_lat)
            noise = jax.random.normal(k2, (DIMS["n_embed"], DIMS["embed_dim"]), jnp.float64)
            draws[name] = (np.asarray(idx), np.asarray(noise))
    port = _port(variables)
    init_codebook_from_batch(port, torch.tensor(img), torch.Generator(), draws=draws)
    for q in ("quantize_t", "quantize_b"):
        mq = getattr(port, q)
        for leaf in ("embed", "embed_avg", "cluster_size"):
            got, w = _np(getattr(mq, leaf)), np.asarray(want[q][leaf])
            assert float(np.abs(got - w).max()) <= 1e-6 * float(np.abs(w).max()), (q, leaf)
        assert torch.equal(mq.embed_avg, mq.embed)
        assert mq.embed_avg.data_ptr() != mq.embed.data_ptr()
        assert torch.all(mq.cluster_size == 1.0)
    # drawn from a generator instead, every code lies near a latent
    state = create_vqvae_state(_port(variables), torch.Generator().manual_seed(0),
                               init_batch=torch.tensor(img))
    e = state.model.quantize_t.embed
    assert torch.isfinite(e).all() and len(torch.unique(e, dim=1).T) == DIMS["n_embed"]


def test_serving_encode_and_bridge_carry_the_ema(jax_model):
    """The serving path in float32: `encode` ids and `decode_code` against
    JAX's (ids exact), the buffers untouched by `encode` in train mode, and
    `from_jax_params` carrying the whole `ema` collection."""
    model, variables = jax_model
    img = _img(5).astype(np.float32)
    ids = np.asarray(jax.jit(functools.partial(model.apply, train=False,
                                               method=model.encode))(
        variables, jnp.asarray(img))[3])
    dec = np.asarray(jax.jit(functools.partial(model.apply, method=model.decode_code))(
        variables, jnp.asarray(ids)))
    port = _port(variables, torch.float32).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port.encode(torch.tensor(img))
        got_dec = port.decode_code(got)
    assert np.array_equal(got.numpy(), ids)
    np.testing.assert_allclose(got_dec.numpy(), dec, atol=1e-5, rtol=1e-5)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k

    cfg = Config.from_json(tiny_cfg(W).to_json())
    v = cfg.model.vqvae
    v.channel, v.n_res_channel, v.embed_dim, v.n_embed = (
        DIMS["channel"], DIMS["n_res_channel"], DIMS["embed_dim"], DIMS["n_embed"])
    sd = from_jax_params({"vqvae": variables}, cfg)["vqvae"]
    for k, w in flat(variables["ema"]).items():
        assert np.array_equal(sd[k.replace("/", ".")].numpy(), np.asarray(w, np.float32)), k
