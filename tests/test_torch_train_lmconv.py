"""The port's stage-3 trainer (train/lmconv.py) and its host pieces against
the JAX package's, on the tiny config of tests/test_train_loops.py
(nr_filters 16, nr_resnet 2, 8x8 codes, 512 classes, batch 2): one step's
loss, gradient norm, gradients, parameters and EMA; clip + Adam +
exponential decay over 5 steps against optax; the training orders and
masks bit for bit; the six schedules; parameter averaging.  The JAX side
in float64, the PixelCNN's plain masked conv in float32
(tests/torch_train_ref.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsynth_tpu.models.lmconv import LMPixelCNN as JaxLMPixelCNN
from pixelsynth_tpu.ops import orders as jax_orders
from pixelsynth_tpu.ops.orders_jax import rank_from_flat_order as jax_rank_from_flat_order
from pixelsynth_tpu.train import average as jax_average
from pixelsynth_tpu.train import lmconv as jax_lm
from pixelsynth_tpu.train import schedulers as jax_sched
from pixelsynth_tpu_torch.checkpoint import CheckpointManager
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN
from pixelsynth_tpu_torch.ops import orders
from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
from pixelsynth_tpu_torch.train import schedulers
from pixelsynth_tpu_torch.train.average import average_checkpoints, average_params
from pixelsynth_tpu_torch.train.lmconv import (
    clip_by_global_norm, create_lmconv_state, make_lmconv_train_step,
)
from pixelsynth_tpu_torch.weights import unflatten_tree

from test_train_loops import tiny_cfg
from torch_train_ref import _few_torch_threads, to64  # noqa: F401

EMA = 0.5


def _masks(rows, cols, n, seed):
    os_ = jax_orders.augment_orders(jax_orders.s_curve_order(rows, cols), rows, cols)
    pick = np.random.default_rng(seed).choice(len(os_), n, replace=False)
    a, b, d = jax_orders.masks_for_orders_batch([os_[i] for i in pick], rows, cols)
    return np.stack([a, b, d], 1)


@pytest.fixture(scope="module")
def step_setup():
    cfg = Config.from_json(tiny_cfg().to_json())
    l = cfg.model.lmconv
    rows, cols = l.obs[1], l.obs[2]
    kw = dict(nr_resnet=l.nr_resnet, nr_filters=l.nr_filters,
              input_channels=l.input_channels, kernel_size=l.kernel_size,
              max_dilation=l.max_dilation, feature_norm=l.feature_norm,
              num_classes=l.num_classes)
    jmodel = JaxLMPixelCNN(**kw)
    params = unflatten_tree({k: v.numpy() for k, v in random_pixelcnn_params(
        cfg, torch.Generator().manual_seed(3)).items()})
    # tx as create_lmconv_state builds it (its own init on a 4x4 grid only
    # gives the parameter shapes)
    _, tx = jax_lm.create_lmconv_state(jmodel, jax.random.PRNGKey(0), rows=4, cols=4,
                                       ema_decay=EMA)
    rng = np.random.default_rng(5)
    codes = rng.integers(0, l.num_classes, (2, rows, cols))
    masks = _masks(rows, cols, 2, 6)

    def jstep(params, codes, masks):
        # train/lmconv.py:74-97's step body, returning its gradients too
        def loss_fn(p):
            oh = jax.nn.one_hot(codes, l.num_classes)
            logits = jmodel.apply({"params": p}, oh, masks[:, 0], masks[:, 1],
                                  masks[:, 2], train=True,
                                  rngs={"dropout": jax.random.PRNGKey(1)})
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -jnp.mean(jnp.take_along_axis(logp, codes[..., None], axis=-1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, upd)
        ema = jax.tree_util.tree_map(lambda e, q: e * EMA + q * (1 - EMA), params, new)
        return loss, optax.global_norm(grads), grads, new, ema

    with jax.enable_x64(True):
        out = jax.jit(jstep)(to64(params), jnp.asarray(codes), jnp.asarray(masks, jnp.float64))
        out = jax.tree_util.tree_map(np.asarray, out)

    model = LMPixelCNN(**kw)
    with torch.no_grad():
        model.load_flax(params)
    state = create_lmconv_state(model, None, ema_decay=EMA)
    seen = {}
    update = state.opt.update

    def spy(grads):
        seen["g"] = [g.detach().clone() for g in grads]
        return update(grads)

    state.opt.update = spy
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_lmconv_train_step(model, state)(
        torch.as_tensor(codes), torch.as_tensor(masks))
    names = [n for n, _ in model.named_parameters()]
    return dict(kw=kw, jax=out, model=model, state=state, metrics=metrics, before=before,
                grads=dict(zip(names, seen["g"], strict=True)))


def _port_layout(kw, tree):
    m = LMPixelCNN(**kw).double()
    with torch.no_grad():
        m.load_flax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree))
    return {n: p.detach().numpy() for n, p in m.named_parameters()}


def test_step_loss_and_gradients_match_jax(step_setup):
    """ce, bpd = ce / ln 2, grad_norm (before clipping) to 1e-5; every
    gradient leaf to <= 1e-4 x its max|g| + 1e-6 (the pixelcnn bound of
    test_torch_train_forward)."""
    loss, gnorm, grads, _, _ = step_setup["jax"]
    m = step_setup["metrics"]
    np.testing.assert_allclose(float(m["ce"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["bpd"]), float(loss) / np.log(2.0), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm), rtol=1e-5)
    want = _port_layout(step_setup["kw"], grads)
    got = step_setup["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name].double().numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (name, err)


def test_step_parameters_and_ema_match_jax(step_setup):
    """Adam's first update (-lr_0 g / (|g| + eps)) within the band the
    gradient tolerance spans, for the port and the JAX step; the EMA
    e d + p (1 - d) after the update, within (1 - d) of that band."""
    _, _, grads, new, ema = step_setup["jax"]
    kw = step_setup["kw"]
    g, want_new, want_ema = (_port_layout(kw, t) for t in (grads, new, ema))
    lr = 2e-4
    state = step_setup["state"]
    for (name, p), e in zip(step_setup["model"].named_parameters(), state.ema_params):
        old = step_setup["before"][name].double().numpy()
        tol = 1e-4 * np.abs(g[name]).max() + 1e-6
        lo = -lr * (g[name] + tol) / (np.abs(g[name] + tol) + 1e-8)
        hi = -lr * (g[name] - tol) / (np.abs(g[name] - tol) + 1e-8)
        slack = 1e-6 * lr + 1e-7 * np.abs(old)
        for moved in (p.detach().double().numpy() - old, want_new[name] - old):
            assert np.all(moved >= lo - slack) and np.all(moved <= hi + slack), name
        for moved in (e.double().numpy() - old, want_ema[name] - old):
            assert np.all(moved >= (1 - EMA) * lo - slack), name
            assert np.all(moved <= (1 - EMA) * hi + slack), name
        np.testing.assert_allclose(e.double().numpy(),
                                   EMA * old + (1 - EMA) * p.detach().double().numpy(),
                                   rtol=0, atol=1e-7)
    assert state.step == 1 and state.opt.count == 1


@pytest.mark.parametrize("clip", [4e6, 0.5])
def test_clip_adam_decay_match_optax(clip):
    """Five updates of clip_by_global_norm(clip) then Adam with
    exponential_decay(lr, 1, rate) against the optax chain the JAX state
    builds, float64: each parameter's move to 1e-6 of itself or of the
    rate (optax keeps the schedule in float32, and five moves can cancel
    to a small sum); with clip 0.5 every step clips."""
    rng = np.random.default_rng(7)
    p0 = [rng.normal(size=(4, 3)), rng.normal(size=(5,))]
    grads = [[rng.normal(size=a.shape) * 10.0 ** rng.uniform(-3, 1) for a in p0]
             for _ in range(5)]
    lr, rate = 2e-4, 0.9
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adam(optax.exponential_decay(lr, transition_steps=1,
                                                        decay_rate=rate)))
    with jax.enable_x64(True):
        params = [jnp.asarray(a) for a in p0]
        st = tx.init(params)
        for g in grads:
            upd, st = tx.update([jnp.asarray(a) for a in g], st, params)
            params = optax.apply_updates(params, upd)
        want = [np.asarray(a) for a in params]
    net = torch.nn.Module()
    net.a = torch.nn.Parameter(torch.tensor(p0[0]))
    net.b = torch.nn.Parameter(torch.tensor(p0[1]))
    state = create_lmconv_state(net, None, lr=lr, lr_decay=rate, clip=clip)
    for g in grads:
        state.opt.update(clip_by_global_norm([torch.tensor(a) for a in g], state.clip))
    for got, w, a0 in zip((net.a, net.b), want, p0):
        np.testing.assert_allclose(got.detach().numpy() - a0, w - a0, rtol=1e-6,
                                   atol=1e-6 * lr)
    assert state.opt.count == 5


@pytest.mark.parametrize("kind", ["raster", "s_curve", "hilbert"])
def test_orders_and_masks_bit_exact(kind):
    """The order, its 8 augmentations, their rank grids and mask triples
    (and type-A masks with observed pixels, and the batch stack) equal the
    JAX package's in value and dtype; rank_from_flat_order equals
    orders_jax's."""
    rows = cols = 8
    fn = {"raster": "raster_scan_order", "s_curve": "s_curve_order",
          "hilbert": "hilbert_order"}[kind]
    want, got = getattr(jax_orders, fn)(rows, cols), getattr(orders, fn)(rows, cols)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    observed = np.random.default_rng(0).random((rows, cols)) < 0.3
    ws, gs = (jax_orders.augment_orders(want, rows, cols),
              orders.augment_orders(got, rows, cols))
    assert len(gs) == len(ws) == 8
    for w, g in zip(ws, gs):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(orders.rank_grid_from_order(g, rows, cols),
                              jax_orders.rank_grid_from_order(w, rows, cols))
        for md in (1, 2):
            for x, y in zip(orders.masks_for_order(g, rows, cols, 3, md),
                            jax_orders.masks_for_order(w, rows, cols, 3, md)):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        x = orders.kernel_masks_from_order(g, rows, cols, 3, 2, "A", observed)
        y = jax_orders.kernel_masks_from_order(w, rows, cols, 3, 2, "A", observed)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(orders.masks_for_orders_batch(gs, rows, cols),
                    jax_orders.masks_for_orders_batch(ws, rows, cols)):
        assert x.shape == (8, 9, rows * cols) and np.array_equal(x, y)
    flat = np.stack([o[:, 0] * cols + o[:, 1] for o in gs])
    assert np.array_equal(orders.rank_from_flat_order(flat, rows * cols),
                          np.asarray(jax_rank_from_flat_order(jnp.asarray(flat), rows * cols)))


@pytest.mark.parametrize("name", ["cycle", "step", "cosine", "linear", "power", "constant"])
def test_schedules_match_optax(name):
    """Each schedule at steps {0, 1, n/3, n/2, n-1, n, 2n} against the
    JAX package's optax schedule: 1e-6 relative, and 1e-6 of the peak
    rate where optax's float32 arithmetic cancels near zero."""
    lr, n = 3e-4, 300
    want, got = jax_sched.get_schedule(name, lr, n), schedulers.get_schedule(name, lr, n)
    for s in (0, 1, n // 3, n // 2, n - 1, n, 2 * n):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=1e-6 * lr,
                                   err_msg=f"{name} at {s}")


def test_average_params_and_checkpoints(tmp_path):
    """average_params equals the JAX package's on the same trees;
    average_checkpoints averages the `variables` of saved steps."""
    rng = np.random.default_rng(8)
    trees = [{"w": rng.normal(size=(3, 2)).astype(np.float32),
              "b": rng.normal(size=(2,)).astype(np.float32)} for _ in range(3)]
    want = jax_average.average_params(trees)
    got = average_params([{k: torch.tensor(v) for k, v in t.items()} for t in trees])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7, atol=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s, t in enumerate(trees, 1):
        mgr.save(s, {"variables": {k: torch.tensor(v) for k, v in t.items()}, "step": s})
    again = average_checkpoints(str(tmp_path), [1, 2, 3])
    for k in got:
        assert torch.equal(again[k], got[k])
