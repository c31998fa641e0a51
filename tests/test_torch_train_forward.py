"""The stage-2 training forward of the port (`PixelSynth.train_forward`)
against `jax.value_and_grad` of the JAX package's, on the tiny config of
tests/test_train_loops.py at W=32 (ngf/ndf 8, nr_filters 16, VQ channel 16,
batch 2) at noise_scale 0 with train_backend "xla": every loss key, every
gradient leaf of the trainable trees (unet, projector, pixelcnn) and every
collection update (the U-Net's and the decoder's batch statistics and
spectral vectors).

Losses are compared in float32.  Gradients and updates are compared with
both sides in float64 (tests/torch_train_ref.py says why), the PixelCNN's
plain masked conv in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.data.synthetic import synthetic_pair_batch
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.train.dpr import split_gen_vars
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.models.layers import collections
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.weights import from_jax_params

from test_train_loops import tiny_cfg
from torch_train_ref import (  # noqa: F401
    _few_torch_threads, flat, grads_in_port_layout, jax_float64, tiny_variables, to64,
)

TRAINABLE = ("unet", "projector", "pixelcnn")


def _port(cfg, variables, float64=False):
    ps = PixelSynth(cfg, device="cpu", trainable=True,
                    state_dicts=from_jax_params(variables, cfg, trainable=True))
    if float64:
        for tree in ps.trees:
            if tree != "pixelcnn":
                getattr(ps, tree).double()
    return ps


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_cfg(32)
    cfg = Config.from_json(jcfg.to_json())
    jps = JaxPixelSynth(jcfg)
    variables = tiny_variables(jps, cfg)
    batch = synthetic_pair_batch(np.random.default_rng(0), 2, jcfg.model.W)
    gen, _, frozen = split_gen_vars(variables)

    def loss(params, gen_vars, frozen_vars, b):
        gv = {k: {**v, "params": params[k]} for k, v in gen_vars.items()}
        return jps.train_forward(gv, frozen_vars, b, {"noise": jax.random.PRNGKey(1)},
                                 noise_scale=0.0)

    params = {k: v["params"] for k, v in gen.items()}
    _, (losses32, _, _) = jax.jit(loss)(params, gen, frozen,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    with jax_float64():
        (_, (losses64, _, updates)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(
            to64(params), to64(gen), to64(frozen), to64(batch))
        losses64 = {k: float(v) for k, v in losses64.items()}
        grads = jax.tree_util.tree_map(np.asarray, grads)
        updates = jax.tree_util.tree_map(np.asarray, updates)
    return dict(cfg=cfg, variables=variables, batch=batch,
                losses32={k: float(v) for k, v in losses32.items()},
                losses64=losses64, grads=grads, updates=updates)


@pytest.fixture(scope="module")
def port64(setup):
    ps = _port(setup["cfg"], setup["variables"], float64=True)
    b = {k: torch.tensor(v, dtype=torch.float64) for k, v in setup["batch"].items()}
    total, losses, outputs, updates = ps.train_forward(b, noise_scale=0.0)
    named = [(t, n, p) for t in TRAINABLE for n, p in getattr(ps, t).named_parameters()]
    grads = torch.autograd.grad(total, [p for _, _, p in named], allow_unused=True)
    return ps, losses, outputs, updates, named, grads


def test_train_forward_losses_match_jax_float32(setup):
    ps = _port(setup["cfg"], setup["variables"])
    _, losses, outputs, _ = ps.train_forward(ps.batch_to_device(setup["batch"]),
                                             noise_scale=0.0)
    want = setup["losses32"]
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, err_msg=k)
    W = setup["cfg"].model.W
    assert outputs["PredImg"].shape == (2, W, W, 3)
    assert bool(torch.isfinite(outputs["PredImg"]).all())


def test_train_forward_losses_match_jax_float64(setup, port64):
    _, losses, _, _, _, _ = port64
    want = setup["losses64"]
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tree", TRAINABLE)
def test_train_forward_gradients_match_jax(setup, port64, tree):
    """Every leaf to <= 1e-4 x its max |g| + 1e-6."""
    _, _, _, _, named, grads = port64
    want = grads_in_port_layout(setup["cfg"], setup["variables"],
                                setup["grads"][tree], tree)
    got = {n: g for (t, n, _), g in zip(named, grads) if t == tree}
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.zeros(w.shape) if got[name] is None else got[name].numpy()
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, (name, err)


@pytest.mark.parametrize("tree", ["unet", "projector"])
def test_train_forward_collection_updates_match_jax(setup, port64, tree):
    """The batch statistics and spectral vectors after the train forward,
    each leaf to 1e-5 of its own scale."""
    _, _, _, updates, _, _ = port64
    for col, want_tree in setup["updates"][tree].items():
        want, got = flat(want_tree), flat(updates[tree][col])
        assert set(got) == set(want), col
        for k, w in want.items():
            err = float(np.abs(got[k].numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (col, k, err)


def test_train_forward_gt_depth_branch(setup):
    """use_gt_depth + train_depth with a `depth_img`: the U-Net does not run
    (its statistics stay), the depth loss is |depth - depth_img| = 0 and
    joins the total."""
    cfg = Config.from_json(setup["cfg"].to_json())
    cfg.model.use_gt_depth = cfg.model.train_depth = True
    ps = _port(cfg, setup["variables"])
    before = {k: v.clone() for k, v in flat(collections(ps.unet)).items()}
    b = ps.batch_to_device(setup["batch"])
    W = cfg.model.W
    b["depth_img"] = torch.full((2, W, W), 3.0)
    total, losses, outputs, updates = ps.train_forward(b, noise_scale=0.0, train_ar=False)
    assert updates["unet"] is None and float(losses["depth_loss"]) == 0.0
    assert "autoreg_loss" not in losses
    for k, v in flat(collections(ps.unet)).items():
        assert torch.equal(v, before[k]), k
    torch.testing.assert_close(outputs["PredDepthImg"], torch.full((2, W, W), 3.0 / 5 - 1))
