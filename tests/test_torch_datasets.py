"""The port's other datasets against the JAX package's, on synthetic trees
written here: RealEstate10K (frames as real JPEGs, decoded by PIL in both
packages), the custom extraction layout both ways, the three extract tools
(codes equal, orders bit-equal, same weights), the live bridge's process
protocol, and `make_batch_source` / the rotation curriculum of run_dpr.

Tolerances: cameras, splits, sampled frames, codes and orders bit-equal;
an image resized by the port within one uint8 level (2/255) of the JAX
reader's PIL resize on at most 1% of its values, bit-equal where no
resize happens."""

import os
import pickle
import time

import numpy as np
import pytest
import torch

from torch_threads import _few_torch_threads  # noqa: F401

BRIDGE_TIMEOUT = 90.0


def _rot_y(deg):
    r = np.radians(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def make_fixture(base, n_videos=5, n_frames=12, step_deg=6.0, split="train",
                 hw=(24, 40), seed=0):
    """The JAX tests' RealEstate10K tree (tests/test_realestate.py
    `make_fixture`): video_loc.txt, per-video metadata (a header row, then
    [timestamp, fx fy cx cy k1 k2, 12 extrinsics]) and frames -- here
    seeded noise images of `hw` written by PIL as JPEGs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(base, "frames", split)
    os.makedirs(d, exist_ok=True)
    vids = [f"vid{i}" for i in range(n_videos)]
    with open(os.path.join(d, "video_loc.txt"), "w") as f:
        f.write("\n".join(vids) + "\n")
    for vid in vids:
        rows = []
        os.makedirs(os.path.join(d, vid), exist_ok=True)
        for fi in range(n_frames):
            ts = 1000 * (fi + 1)
            ex = np.hstack([_rot_y(step_deg * fi),
                            np.array([[0.01 * fi], [0.0], [0.02 * fi]])]).reshape(-1)
            row = [ts, 0.9, 1.2, 0.5, 0.5, 0.0, 0.0] + list(ex)
            rows.append(" ".join(f"{v:.9g}" for v in row))
            img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(d, vid, f"{ts}.jpg"))
        with open(os.path.join(d, f"{vid}.txt"), "w") as f:
            f.write("https://example.com/video\n" + "\n".join(rows) + "\n")
    return vids


def within_one_level(got, want, frac=0.01):
    levels = np.abs(np.rint((np.asarray(got, np.float64) + 1) * 127.5)
                    - np.rint((np.asarray(want, np.float64) + 1) * 127.5))
    assert got.shape == want.shape
    assert levels.max() <= 1, levels.max()
    assert (levels > 0).mean() <= frac, (levels > 0).mean()


IMAGE_KEYS = ("input_img", "output_img")


def items_match(got, want):
    """Camera and other arrays bit-equal, images within one level."""
    assert list(got) == list(want)
    for k, w in want.items():
        if k in IMAGE_KEYS:
            within_one_level(got[k], w)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def re10k(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("re10k"))
    make_fixture(base, n_videos=10)
    make_fixture(base, n_videos=3, split="test", seed=1)
    return base


def test_realestate_pairs_and_split_match_jax(re10k):
    """Same seed: the same split, the same videos, frames and cameras
    (RandomState draws in the JAX order), images within one level."""
    from pixelsynth_tpu.data.realestate10k import RealEstate10K as JaxRE
    from pixelsynth_tpu_torch.data.realestate10k import RealEstate10K

    for split in ("train", "val", "test"):
        port = RealEstate10K(split, data_path=re10k, W=16, seed=3)
        ref = JaxRE(split, data_path=re10k, W=16, seed=3)
        np.testing.assert_array_equal(port.videos, ref.videos)
        for _ in range(3):
            items_match(port.sample_pair(), ref.sample_pair())
    port = RealEstate10K("train", data_path=re10k, W=16, seed=5)
    ref = JaxRE("train", data_path=re10k, W=16, seed=5)
    items_match(port.batch(3), ref.batch(3))
    port.toval(epoch=2)
    ref.toval(epoch=2)
    np.testing.assert_array_equal(port.videos, ref.videos)
    items_match(port.sample_pair(), ref.sample_pair())


def test_realestate_camera_merge_matches_jax():
    from pixelsynth_tpu.data.realestate10k import _angle_trans as jax_angle_trans
    from pixelsynth_tpu.data.realestate10k import habitat_merge_camera as jax_merge
    from pixelsynth_tpu_torch.data.realestate10k import _angle_trans, habitat_merge_camera

    rng = np.random.default_rng(0)
    for _ in range(4):
        intr = rng.uniform(0.3, 1.5, 6)
        ex = np.hstack([_rot_y(rng.uniform(-40, 40)), rng.normal(size=(3, 1))]).reshape(-1)
        ex2 = np.hstack([_rot_y(rng.uniform(-40, 40)), rng.normal(size=(3, 1))]).reshape(-1)
        for got, want in zip(habitat_merge_camera(intr, ex), jax_merge(intr, ex)):
            np.testing.assert_array_equal(got, want)
        assert _angle_trans(ex, ex2) == jax_angle_trans(ex, ex2)


def test_realestate_bounded_failure_and_rotation_hook(tmp_path, re10k):
    """A tree with no valid pair raises after max_tries (and an empty split
    at once), as the JAX sampler does; set_max_rotation moves the
    threshold: at 100 degrees (threshold 50) no video of the 6-degree
    fixture has six candidates in (50, 60)."""
    from pixelsynth_tpu.data.realestate10k import RealEstate10K as JaxRE
    from pixelsynth_tpu_torch.data.realestate10k import RealEstate10K

    make_fixture(str(tmp_path), n_videos=2, n_frames=2, step_deg=0.0)
    for cls in (RealEstate10K, JaxRE):
        ds = cls("train", data_path=str(tmp_path), W=16, seed=0)
        with pytest.raises(RuntimeError, match="no valid frame pair"):
            ds.sample_pair(max_tries=20)
        ds.videos = ds.videos[:0]
        with pytest.raises(RuntimeError, match="empty video list"):
            ds.sample_pair(max_tries=5)
    port = RealEstate10K("train", data_path=re10k, W=16, seed=0)
    ref = JaxRE("train", data_path=re10k, W=16, seed=0)
    items_match(port.sample_pair(), ref.sample_pair())
    port.set_max_rotation(100)
    ref.set_max_rotation(100)
    assert port.max_rotation == ref.max_rotation == 100
    for ds in (port, ref):
        with pytest.raises(RuntimeError, match="thr=50"):
            ds.sample_pair(max_tries=30)


def test_realestate_fixed_triples_match_jax(re10k, tmp_path):
    from pixelsynth_tpu.data.realestate10k import RealEstate10KFixed as JaxFixed
    from pixelsynth_tpu_torch.data.realestate10k import RealEstate10KFixed

    ipath = str(tmp_path / "realestate_test_indices.npy")
    np.save(ipath, np.array([[0, 0, 5], [2, 1, 7], [1, 3, 9]]))
    port = RealEstate10KFixed(data_path=re10k, indices_path=ipath, W=16)
    ref = JaxFixed(data_path=re10k, indices_path=ipath, W=16)
    assert len(port) == len(ref) == 3
    for i in range(3):
        items_match(port[i], ref[i])


def test_image_loader_without_pil_refuses_other_formats(re10k, monkeypatch):
    """Where PIL is missing (the card's machine), a JPEG frame raises an
    ImportError that names PIL and the file; a PNG still loads."""
    import builtins

    from pixelsynth_tpu_torch.data.realestate10k import load_image
    from pixelsynth_tpu_torch.eval.harness import save_png

    jpg = os.path.join(re10k, "frames", "train", "vid0", "1000.jpg")
    png = save_png(os.path.join(os.path.dirname(re10k), "frame.png"),
                   np.zeros((8, 8, 3), np.float32))
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL") as err:
        load_image(jpg, 16)
    assert "1000.jpg" in str(err.value)
    assert load_image(png, 8).shape == (8, 8, 3)


def _synthetic_cfg(Config, W=32, batch=2):
    cfg = Config()
    cfg.dataset = "synthetic"
    cfg.model.W = W
    cfg.train.batch_size = batch
    return cfg


def test_custom_extraction_loads_in_both_packages(tmp_path):
    """The JAX package's `extract` loads in the port's Custom and the
    port's in the JAX package's Custom (bit-equal at W, within a level
    resized); the two extractions of one synthetic source are the same
    images and the same cameras.pkl; CustomTest and collate agree."""
    from pixelsynth_tpu.config import Config as JaxConfig
    from pixelsynth_tpu.data.custom import Custom as JaxCustom
    from pixelsynth_tpu.data.custom import CustomTest as JaxCustomTest
    from pixelsynth_tpu.tools.extract_vqvae_dataset import extract as jax_extract
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.data.custom import Custom, CustomTest, collate
    from pixelsynth_tpu_torch.eval.harness import load_png
    from pixelsynth_tpu_torch.tools.extract_vqvae_dataset import extract

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_extract(_synthetic_cfg(JaxConfig), jdir, num_train=3, num_val=2)
    assert extract(_synthetic_cfg(Config), pdir, num_train=3, num_val=2) == 5
    for i in range(5):
        np.testing.assert_array_equal(load_png(os.path.join(pdir, "rgb", f"{i}.png")),
                                      load_png(os.path.join(jdir, "rgb", f"{i}.png")))
    with open(os.path.join(pdir, "cameras.pkl"), "rb") as f:
        pc = pickle.load(f)
    with open(os.path.join(jdir, "cameras.pkl"), "rb") as f:
        jc = pickle.load(f)
    assert len(pc) == len(jc) == 5
    for a, b in zip(pc, jc):
        for ca, cb in zip(a, b):
            assert list(ca) == list(cb)
            for k in cb:
                assert type(ca[k]) is type(cb[k]) and ca[k].dtype == cb[k].dtype
                np.testing.assert_array_equal(ca[k], cb[k])
    for folder in (jdir, pdir):
        for W in (32, 16):
            port, ref = Custom(folder, W=W), JaxCustom(folder, W=W)
            assert port.images == ref.images and len(port) == 5
            for i in range(len(ref)):
                items_match(port[i], ref[i])
                if W == 32:
                    np.testing.assert_array_equal(port[i]["input_img"], ref[i]["input_img"])
    # CustomTest: input/ + output/ + directions
    for sub in ("input", "output"):
        os.makedirs(tmp_path / "test" / sub)
        for i in (10, 2, 1):
            os.link(os.path.join(pdir, "rgb", f"{i % 5}.png"),
                    tmp_path / "test" / sub / f"{i}.png")
    with open(tmp_path / "test" / "cameras.pkl", "wb") as f:
        pickle.dump(pc[:3], f)
    np.save(tmp_path / "dirs.npy", np.array([3, 1, 4]))
    port = CustomTest(str(tmp_path / "test"), str(tmp_path / "dirs.npy"), W=16)
    ref = JaxCustomTest(str(tmp_path / "test"), str(tmp_path / "dirs.npy"), W=16)
    assert port.inputs == ref.inputs and len(port) == 3
    items_match(collate([port[i] for i in range(3)]),
                collate([ref[i] for i in range(3)]))


def test_extract_code_matches_jax(tmp_path):
    """extract_code on the same weights (the JAX tool's seeded VQ-VAE,
    carried across by weights.py into a port checkpoint) gives the JAX
    tool's codes, int32 (N, W/8, W/8)."""
    import jax

    from pixelsynth_tpu.config import Config as JaxConfig
    from pixelsynth_tpu.models.vqvae import VQVAETop
    from pixelsynth_tpu.tools.extract_code import extract_codes as jax_codes
    from pixelsynth_tpu.tools.extract_vqvae_dataset import extract as jax_extract
    from pixelsynth_tpu.train.vqvae import create_vqvae_state
    from pixelsynth_tpu_torch.checkpoint import CheckpointManager
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import build_vqvae
    from pixelsynth_tpu_torch.tools.extract_code import extract_codes
    from pixelsynth_tpu_torch.weights import from_jax_module

    def small(cfg):
        cfg.model.W = 32
        cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 16, 8
        return cfg

    folder = str(tmp_path / "extraction")
    jax_extract(_synthetic_cfg(JaxConfig), folder, num_train=4, num_val=1)
    jcfg, cfg = small(JaxConfig()), small(Config())
    v = jcfg.model.vqvae
    model = VQVAETop(in_channel=v.in_channel, channel=v.channel, n_res_block=v.n_res_block,
                     n_res_channel=v.n_res_channel, embed_dim=v.embed_dim,
                     n_embed=v.n_embed, decay=v.decay)
    state, _ = create_vqvae_state(model, jax.random.PRNGKey(0), img_size=32)
    sd = from_jax_module(build_vqvae(cfg), jax.device_get(state.variables))
    ckpt = str(tmp_path / "vqvae")
    CheckpointManager(ckpt).save(1, {"variables": sd}, cfg)
    jax_codes(jcfg, folder, str(tmp_path / "jax.npy"), vqvae_ckpt=None, batch=2)
    got = extract_codes(cfg, folder, str(tmp_path / "port.npy"), ckpt, batch=3,
                        device="cpu")
    want = np.load(tmp_path / "jax.npy")
    assert got.dtype == np.int32 and got.shape == (5, 4, 4)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    np.testing.assert_array_equal(got, want)


def test_extract_pixcnn_orders_matches_jax(tmp_path):
    """extract_pixcnn_orders on one stitched checkpoint (the same weights in
    both packages' demo `load_model`), W=64: orders bit-equal to the JAX
    tool's, (N, 64, 2) int32, each a permutation of the code grid."""
    import jax
    import jax.numpy as jnp

    from pixelsynth_tpu.config import Config as JaxConfig
    from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
    from pixelsynth_tpu.tools.extract_pixcnn_orders import extract_orders as jax_orders
    from pixelsynth_tpu.tools.extract_vqvae_dataset import extract as jax_extract
    from pixelsynth_tpu.tools.stitch_checkpoint import save_stitched_npz
    from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.tools.extract_pixcnn_orders import extract_orders
    from pixelsynth_tpu_torch.weights import unflatten_tree
    from test_torch_models import _fill
    from test_torch_view_step import tiny

    W = 64
    folder = str(tmp_path / "extraction")
    jax_extract(_synthetic_cfg(JaxConfig, W=W, batch=3), folder, num_train=3, num_val=2)
    jps = JaxPixelSynth(tiny(JaxConfig()))
    img, k = jnp.zeros((1, W, W, 3)), jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, img, train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, img, jnp.zeros((1, W, W), bool), train=False)),
        "vqvae": jax.eval_shape(lambda: jps.vqvae.init({"params": k}, img, train=False)),
        "disc": jax.eval_shape(lambda: jps.disc.init({"params": k}, img, train=False)),
    }
    variables = _fill(shapes, np.random.default_rng(1))
    pcnn = random_pixelcnn_params(tiny(Config()), torch.Generator().manual_seed(1))
    variables["pixelcnn"] = {"params": unflatten_tree(
        {n: v.numpy() for n, v in pcnn.items()})}
    npz = str(tmp_path / "stitched.npz")
    save_stitched_npz(npz, jax.tree_util.tree_map(np.asarray, variables), jps.cfg)
    jax_orders(folder, str(tmp_path / "jax.npy"), ckpt_dir=npz, batch=2)
    got = extract_orders(folder, str(tmp_path / "port.npy"), ckpt_dir=npz, batch=3,
                         device="cpu")
    want = np.load(tmp_path / "jax.npy")
    assert got.dtype == np.int32 and got.shape == (5, 64, 2)
    assert (np.sort(got[..., 0] * 8 + got[..., 1], 1) == np.arange(64)).all()
    np.testing.assert_array_equal(got, want)


def test_panorama_generator_matches_jax():
    from pixelsynth_tpu.data.habitat_bridge import PanoramaGenerator as JaxGen
    from pixelsynth_tpu_torch.data.habitat_bridge import PanoramaGenerator

    port = PanoramaGenerator(W=32, max_rotation=30.0, num_worlds=2, seed=3)
    ref = JaxGen(W=32, max_rotation=30.0, num_worlds=2, seed=3)
    for _ in range(2):
        got, want = port.sample_pair(), ref.sample_pair()
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


class _Fixed:
    """A picklable factory: item i of worker seed s holds s and i."""

    def __init__(self, W=4, seed=0):
        self.W, self.seed, self.i = W, seed, 0

    def sample_pair(self):
        self.i += 1
        return {"input_img": np.full((self.W, self.W, 3), self.seed, np.float32),
                "n": np.int64(self.i)}


def test_bridge_batches_and_closes():
    """Two spawned workers (a fake factory, then the panorama worlds) fill
    batches within BRIDGE_TIMEOUT; each worker has its own seed (seed +
    1000 w); close() stops and joins them."""
    from pixelsynth_tpu_torch.data.habitat_bridge import (
        PanoramaGenerator, VectorGeneratorBridge,
    )

    t0 = time.monotonic()
    with VectorGeneratorBridge(_Fixed(), num_workers=2, seed=7) as bridge:
        b = bridge.batch(8, timeout=BRIDGE_TIMEOUT)
        assert set(np.unique(b["input_img"])) <= {7.0, 1007.0}
        assert (b["n"] >= 1).all()
    assert all(not p.is_alive() for p in bridge._procs)
    with VectorGeneratorBridge(PanoramaGenerator(W=32, max_rotation=30.0, num_worlds=2),
                               num_workers=2, seed=11) as bridge:
        b = bridge.batch(4, timeout=BRIDGE_TIMEOUT)
        assert b["input_img"].shape == (4, 32, 32, 3) and b["P_in"].shape == (4, 4, 4)
        assert np.isfinite(b["input_img"]).all()
    assert all(not p.is_alive() for p in bridge._procs)
    assert time.monotonic() - t0 < 2 * BRIDGE_TIMEOUT


def test_make_batch_source_habitat_live():
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.train.loop import make_batch_source

    cfg = _synthetic_cfg(Config)
    cfg.dataset, cfg.train_data_path = "habitat_live", "panorama"
    fn = make_batch_source(cfg, "val")
    try:
        assert fn.split == "val" and len(fn.bridge._procs) == 5
        batch = fn.bridge.batch(2, timeout=BRIDGE_TIMEOUT)
        assert batch["input_img"].shape == (2, 32, 32, 3)
        assert batch["depth_img"].shape == (2, 32, 32)
    finally:
        fn.bridge.close()


def test_make_batch_source_realestate_and_custom_match_jax(re10k, tmp_path):
    """"realestate" (every split on cfg.train.seed) and "custom" (random
    items, cfg.train.seed) draw the JAX factory's batches."""
    from pixelsynth_tpu.config import Config as JaxConfig
    from pixelsynth_tpu.tools.extract_vqvae_dataset import extract as jax_extract
    from pixelsynth_tpu.train.loop import make_batch_source as jax_source
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.train.loop import make_batch_source

    cfgs = []
    for C in (Config, JaxConfig):
        cfg = _synthetic_cfg(C, W=16, batch=3)
        cfg.dataset, cfg.train_data_path, cfg.train.seed = "realestate", re10k, 4
        cfgs.append(cfg)
    for split in ("train", "val"):
        port, ref = make_batch_source(cfgs[0], split), jax_source(cfgs[1], split)
        assert port.split == ref.split == split
        assert port.dataset.rng.get_state()[1][0] == ref.dataset.rng.get_state()[1][0]
        items_match(port(), ref())
    folder = str(tmp_path / "extraction")
    jax_extract(_synthetic_cfg(JaxConfig), folder, num_train=4, num_val=2)
    for cfg in cfgs:
        cfg.dataset, cfg.train_data_path, cfg.model.W = "custom", folder, 32
    port, ref = make_batch_source(cfgs[0]), jax_source(cfgs[1])
    for _ in range(2):
        items_match(port(), ref())


def test_run_dpr_sets_the_curriculum_rotation(re10k, tmp_path, monkeypatch):
    """run_dpr on "realestate" calls set_max_rotation at the start of
    every epoch with the curriculum's angle (train_dpr.py:91-98)."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.data.realestate10k import RealEstate10K
    from pixelsynth_tpu_torch.parallel.dryrun import small_config
    from pixelsynth_tpu_torch.train.loop import run_dpr

    calls = []
    real = RealEstate10K.set_max_rotation

    def record(self, deg):
        calls.append((self.is_train, deg))
        real(self, deg)

    monkeypatch.setattr(RealEstate10K, "set_max_rotation", record)
    cfg = small_config(W=32)
    assert isinstance(cfg, Config)
    cfg.dataset, cfg.train_data_path = "realestate", re10k
    cfg.train.batch_size, cfg.train.seed = 2, 0
    cfg.train.max_rotation, cfg.train.curriculum_every = 10, 1
    cfg.train.curriculum_step, cfg.train.curriculum_max = 15, 20
    logs = []
    m = run_dpr(cfg, str(tmp_path / "run"), epochs=2, iters_per_epoch=1, val_iters=1,
                log_fn=logs.append, device="cpu")
    assert calls == [(True, 10), (True, 20)]
    assert np.isfinite(m["Total Loss"]) and "rot 20" in logs[-1]
