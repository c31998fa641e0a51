"""The port's relay training chain on the CPU, against the JAX package
where both compute the same thing: the exported shards and the batches
read from them, the inverse weight bridge (`weights.to_jax_params`) on
every network of a tiny config, a port-written stitched.npz loaded by the
JAX package, one scene-classifier Adam step against optax, and
`tools/run_relay.py` end to end at a size below --smoke."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsynth_tpu import demo as jax_demo
from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.data.habitat import PreRenderedEpisodes as JaxEpisodes
from pixelsynth_tpu.models.classifier import ResNet18 as JaxResNet18
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.tools import export_habitat_shards as jax_export
from pixelsynth_tpu.train.loop import make_batch_source as jax_batch_source
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.habitat import PreRenderedEpisodes
from pixelsynth_tpu_torch.data.loader import PrefetchLoader
from pixelsynth_tpu_torch.models.classifier import classifier_from_variables
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.tools import export_habitat_shards as export
from pixelsynth_tpu_torch.tools import run_relay as relay
from pixelsynth_tpu_torch.tools.stitch_checkpoint import save_stitched_npz
from pixelsynth_tpu_torch.tools.train_scene_classifier import (
    classifier_variables, make_optimizer, train_step,
)
from pixelsynth_tpu_torch.train.loop import make_batch_source
from pixelsynth_tpu_torch.weights import flatten_tree, from_jax_params, to_jax_params
from test_torch_models import _fill
from torch_threads import _few_torch_threads  # noqa: F401


def _arrays_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("world", ["plane", "pano"])
def test_export_synthetic_matches_jax(tmp_path, world):
    kw = dict(num_pairs=5, shard_size=2, W=32, max_rotation=30.0, seed=4,
              split="train", world=world)
    n = export.export_synthetic(str(tmp_path / "port"), **kw)
    assert n == jax_export.export_synthetic(str(tmp_path / "jax"), **kw) == 3
    for i in range(n):
        name = f"train_{i:05d}.npz"
        with np.load(tmp_path / "port" / name) as p, np.load(tmp_path / "jax" / name) as j:
            _arrays_equal({k: p[k] for k in p.files}, {k: j[k] for k in j.files})
    np.testing.assert_array_equal(export.hfov_intrinsics(75.0), jax_export.hfov_intrinsics(75.0))
    with pytest.raises(SystemExit, match="habitat"):
        export.export_habitat(str(tmp_path), scenes_config="x.yaml", num_pairs=1,
                              shard_size=1, W=32, max_rotation=10.0, seed=0, split="train")


def test_shard_batches_match_jax(tmp_path):
    """PreRenderedEpisodes draws the same batches as JAX's, and
    make_batch_source("habitat") reads each split's own shards with JAX's
    seeds."""
    data = str(tmp_path)
    for split, seed in (("train", 0), ("val", 777)):
        export.export_synthetic(data, num_pairs=6, shard_size=3, W=32, max_rotation=35.0,
                                seed=seed, split=split, world="pano")
    port, jax_eps = PreRenderedEpisodes(data, seed=3), JaxEpisodes(data, seed=3)
    for _ in range(2):
        _arrays_equal(port.batch(3), jax_eps.batch(3))
    for dataset in ("habitat", "mp3d"):
        cfg, jcfg = Config(), JaxConfig()
        for c in (cfg, jcfg):
            c.dataset, c.train_data_path, c.model.W, c.train.batch_size = dataset, data, 32, 2
        for split in ("train", "val"):
            got = make_batch_source(cfg, split)()
            _arrays_equal(got, jax_batch_source(jcfg, split)())
            assert "depth_img" in got
    cfg.dataset = "habitat_live"
    with pytest.raises(NotImplementedError, match="habitat_live"):
        make_batch_source(cfg)


def test_prefetch_loader_skips_failures_and_closes():
    calls = iter(range(100))

    def batch_fn():
        i = next(calls)
        if i % 3 == 1:
            raise ValueError("malformed")
        return {"i": np.array(i)}

    loader = PrefetchLoader(batch_fn, prefetch=2, num_threads=1)
    got = [int(next(loader)["i"]) for _ in range(4)]
    loader.close()
    assert got == [0, 2, 3, 5]


def _classifier_variables(num_classes, seed):
    """Random ResNet18 variables in the JAX package's tree (the shapes of
    its init, no compile)."""
    shapes = jax.eval_shape(lambda: JaxResNet18(num_classes=num_classes).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)), train=False))
    return _fill(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_trees():
    """Every network's variables in the trees of the JAX package's own
    initialiser (tiny config, W=64; shapes by jax.eval_shape, random values),
    plus a 5-class scene classifier."""
    from test_train_loops import tiny_cfg

    jcfg = tiny_cfg()
    shapes = jax.eval_shape(lambda: JaxPixelSynth(jcfg).init_variables(jax.random.PRNGKey(0)))
    variables = _fill(shapes, np.random.default_rng(0))
    variables["classifier"] = _classifier_variables(5, 1)
    return jcfg, jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("tree", ["unet", "projector", "vqvae", "disc", "vgg",
                                  "pixelcnn", "classifier"])
def test_to_jax_params_round_trips_every_network(jax_trees, tree):
    """from_jax_params(trainable=True) then to_jax_params gives the tree
    back: every key of every collection, exact in float32."""
    jcfg, variables = jax_trees
    cfg = Config.from_json(jcfg.to_json())
    if tree == "classifier":
        sd = {tree: classifier_from_variables(variables[tree]).state_dict()}
    else:
        sd = from_jax_params({tree: variables[tree]}, cfg, trainable=True)
    back = to_jax_params(sd, cfg)[tree]
    assert sorted(back) == sorted(variables[tree])
    want, got = flatten_tree(variables[tree]), flatten_tree(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_stitched_npz_loads_in_jax(jax_trees, tmp_path):
    """A stitched.npz written by the port (the trainer's state dicts ->
    to_jax_params -> save_stitched_npz) loads in the JAX package
    (`load_stitched_npz`, `demo.load_model`) and in the port as the trees
    it was written from, each float32 leaf rounded through float16 and
    nothing else, under the same config.  The view such a file renders in
    both packages: test_torch_view_step.py's
    test_port_stitched_npz_renders_the_jax_view."""
    from pixelsynth_tpu.tools.stitch_checkpoint import load_stitched_npz as jax_load
    from pixelsynth_tpu_torch.weights import load_stitched_npz

    jcfg, variables = jax_trees
    cfg = Config.from_json(jcfg.to_json())
    trees = {k: variables[k] for k in ("unet", "projector", "vqvae", "disc", "pixelcnn")}
    npz = str(tmp_path / "stitched.npz")
    save_stitched_npz(npz, to_jax_params(from_jax_params(trees, cfg, trainable=True), cfg),
                      cfg, {"prior": "test"})
    want = {k: v.astype(np.float16).astype(np.float32) if v.dtype == np.float32 else v
            for k, v in flatten_tree(trees).items()}
    jax_cfg, jax_vars, meta = jax_load(npz)
    assert jax_cfg.to_json() == jcfg.to_json() and meta == {"prior": "test"}
    _, loaded = jax_demo.load_model(npz)
    port_cfg, port_vars, _ = load_stitched_npz(npz)
    assert port_cfg.to_json() == cfg.to_json()
    for got in (jax_vars, jax.tree_util.tree_map(np.asarray, loaded), port_vars):
        _arrays_equal(flatten_tree(got), want)
    assert isinstance(PixelSynth.from_stitched(npz, device="cpu"), PixelSynth)


def test_classifier_adam_step_matches_optax():
    """One train-mode step of the scene classifier from the same variables
    in both packages: the loss, every parameter after Adam and the running
    statistics, against the JAX tool's step (optax.adam(1e-3)).  In
    float64 (jax.enable_x64, the port's module .double()): Adam's first
    step moves a parameter by lr * g / (|g| + eps), so in float32 a
    gradient within rounding of zero can take either sign in the two
    frameworks and move its parameter by 2 lr (tests/torch_train_ref.py)."""
    from pixelsynth_tpu.tools.train_scene_classifier import IMAGENET_MEAN, IMAGENET_STD

    model_j = JaxResNet18(num_classes=4)
    variables = _classifier_variables(4, 2)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (6, 32, 32, 3))
    labels = np.array([0, 1, 2, 3, 1, 0])
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    tx = optax.adam(1e-3)

    def loss_fn(p):
        x = (jnp.asarray(imgs) * 0.5 + 0.5 - IMAGENET_MEAN) / IMAGENET_STD
        logits, upd = model_j.apply({"params": p, "batch_stats": v64["batch_stats"]},
                                    x, train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        return ce, upd["batch_stats"]

    @jax.jit
    def step(params):
        (ce, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return ce, stats, optax.apply_updates(params, updates)

    with jax.enable_x64(True):
        ce_j, stats_j, params_j = jax.tree_util.tree_map(np.asarray, step(v64["params"]))

    model = classifier_from_variables(jax.tree_util.tree_map(np.asarray, variables)).double()
    ce, _ = train_step(model, make_optimizer(model, 1e-3), torch.as_tensor(imgs),
                       torch.as_tensor(labels))
    np.testing.assert_allclose(float(ce), float(ce_j), rtol=1e-5)
    got = classifier_variables(model)
    for col, want in (("params", params_j), ("batch_stats", stats_j)):
        want, have = flatten_tree(want), flatten_tree(got[col])
        assert sorted(have) == sorted(want)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=f"{col}/{k}")


TINY_RELAY = dict(n_train=8, n_val=2, shard_size=4, iters_per_epoch=1, val_iters=1,
                  vq_batch=2, vq_epochs=1, dpr_batch=2, dpr_pre_epochs=1, dpr_epochs=1,
                  lm_batch=2, lm_epochs=1, n_orders=8, classifier_steps=1,
                  classifier_size=32, classifier_worlds=2)


@pytest.fixture
def tiny_relay(monkeypatch):
    """run_relay at W=32 with tiny networks and step counts below --smoke
    (relay_config and settings patched); -> the list of stages run."""
    config, settings = relay.relay_config, relay.settings

    def tiny_config(width, data_dir):
        cfg = config(width, data_dir)
        cfg.model.unet_num_filters, cfg.model.ngf, cfg.model.ndf = 4, 8, 8
        cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 16, 8
        cfg.model.lmconv.nr_filters = 16
        cfg.model.splat.max_points_per_tile, cfg.model.splat.tile_group = 1024, 4
        return cfg

    monkeypatch.setattr(relay, "relay_config", tiny_config)
    monkeypatch.setattr(relay, "settings", lambda *a: {**settings(*a), **TINY_RELAY})
    ran = []
    for stage, fn in list(relay.STAGE_FNS.items()):
        monkeypatch.setitem(relay.STAGE_FNS, stage,
                            lambda *a, _s=stage, _f=fn: ran.append(_s) or _f(*a))
    return ran


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_run_relay_end_to_end_on_the_cpu(tmp_path, tiny_relay):
    """All ten stages at W=32 with tiny networks: every marker, a stitched
    npz whose report has the JAX report's keys; a second call skips every
    stage; --force-from purges a stage's state and re-runs it and the rest;
    an evidence directory inside evidence/ is refused."""
    workdir = str(tmp_path / "relay")
    ran = tiny_relay
    kw = dict(width=32, smoke=True, device="cpu")
    results = relay.run_relay(workdir, **kw)
    assert ran == relay.STAGES == list(results)
    for stage in relay.STAGES:
        with open(os.path.join(workdir, f"{stage}.done.json")) as f:
            assert json.load(f)["stage"] == stage
    evidence = os.path.join(workdir, "evidence")
    assert results["stitch"]["classifier_stitched"]
    with open(os.path.join(os.path.dirname(__file__), "..", "evidence", "relay",
                           "relay_report.json")) as f:
        want = set(json.load(f))
    with open(os.path.join(evidence, "relay_report.json")) as f:
        report = json.load(f)
    assert want <= set(report) and report["n_pairs"] == 2
    orders = np.load(os.path.join(workdir, "orders.npy"))
    assert orders.shape == (8, 16, 2)
    assert (np.sort(orders[:, :, 0] * 4 + orders[:, :, 1], 1) == np.arange(16)).all()

    ran.clear()
    again = relay.run_relay(workdir, **kw)
    assert ran == [] and again["stitch"]["prior"] == results["stitch"]["prior"]

    stitched = os.path.join(workdir, "stitched")
    marker = os.path.getmtime(os.path.join(workdir, "stitch.done.json"))
    os.makedirs(os.path.join(stitched, "stale"))
    relay.run_relay(workdir, force_from="stitch", **kw)
    assert ran == ["stitch", "report"]
    assert not os.path.exists(os.path.join(stitched, "stale"))
    assert os.path.getmtime(os.path.join(workdir, "stitch.done.json")) > marker

    with pytest.raises(SystemExit, match="evidence"):
        relay.run_relay(workdir, os.path.join(os.path.dirname(__file__), "..",
                                              "evidence", "relay"), **kw)
