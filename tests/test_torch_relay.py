"""The relay report's numpy-level pieces in the port against the JAX
package's on the same inputs: the panorama worlds and the held-out data,
the PSNR / SSIM metrics, the exact-homography consistency (a warp without
OpenCV against cv2's), the walk's metrics over the committed demo-CLI
PNGs, and the PNG writer and reader (without PIL) against PIL."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.data import panorama as jpano
from pixelsynth_tpu.eval import metrics as jmetrics
from pixelsynth_tpu.eval.relay_report import scene_walk_metrics as jax_walk_metrics
from pixelsynth_tpu.models.losses import ssim as jax_ssim
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data import panorama as pano
from pixelsynth_tpu_torch.eval import harness, metrics
from pixelsynth_tpu_torch.eval.homography import consistency_exact
from pixelsynth_tpu_torch.eval.relay_report import scene_walk_metrics
from pixelsynth_tpu_torch.geometry.paths import get_rt_from_rot
from pixelsynth_tpu_torch.models.losses import ssim
from test_metrics_precision import _np_ssim_f64
from torch_threads import _few_torch_threads  # noqa: F401

RELAY = os.path.join(os.path.dirname(__file__), "..", "evidence", "relay")
SCENE = os.path.join(RELAY, "scene_out")


def _world_equal(a, b):
    assert np.array_equal(a["texture"], b["texture"])
    assert a["base_radius"] == b["base_radius"]
    assert [tuple(w) for w in a["waves"]] == [tuple(w) for w in b["waves"]]


def test_panorama_is_bit_equal_to_jax():
    _world_equal(pano.make_world(np.random.default_rng(3)),
                 jpano.make_world(np.random.default_rng(3)))
    world = jpano.make_world(np.random.default_rng(4))
    P0, P1 = jpano.sample_pair_cameras(np.random.default_rng(5))
    for P in (P0, P1):
        got, want = pano.render_view(world, P, 32), jpano.render_view(world, P, 32)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    got = pano.synthesize_pano_shard(np.random.default_rng(6), 10, 32, 40.0)
    want = jpano.synthesize_pano_shard(np.random.default_rng(6), 10, 32, 40.0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _jax_heldout_search(W):
    """tools/run_relay.py:121-140 on the JAX package's functions."""
    rng = np.random.default_rng(31337)
    P0 = jpano.camera_pose(np.zeros(3), np.zeros(3))
    best = (-1.0, None, None, None)
    for _ in range(64):
        cand = jpano.make_world(rng)
        cimg, cdepth = jpano.render_view(cand, P0, W)
        std = float(np.mean(np.std(cimg, axis=(0, 1))))
        edges = float(np.mean(np.abs(np.diff(cimg, axis=0))) +
                      np.mean(np.abs(np.diff(cimg, axis=1))))
        score = std + 4.0 * edges
        if score > best[0]:
            best = (score, cand, cimg, cdepth)
        if std > 0.3 and edges > 0.015:
            return cand, cimg, cdepth
    return best[1], best[2], best[3]


def test_heldout_world_and_val_pairs():
    world, img, depth = pano.heldout_demo_world(32)
    jworld, jimg, jdepth = _jax_heldout_search(32)
    _world_equal(world, jworld)
    assert np.array_equal(img, jimg) and np.array_equal(depth, jdepth)
    # the relay's validation shard, in memory: items draw in order
    long, short = pano.val_pairs(32, 16), pano.val_pairs(32, 8)
    want = jpano.synthesize_pano_shard(np.random.default_rng(777), 8, 32, 40.0)
    for k in want:
        assert np.array_equal(short[k], want[k]), k
        assert np.array_equal(long[k][:8] if long[k].ndim > 2 else long[k], short[k]), k


def _relay_pngs(n):
    paths = sorted(glob.glob(os.path.join(SCENE, "scene", "*.png")))
    if len(paths) < n:
        pytest.skip("relay scene PNGs not committed")
    return [harness.load_png(p)[..., :3].astype(np.float32) / 255.0 for p in paths[:n]]


def test_psnr_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    b[2] = a[2]   # the clamp at 100
    m = (rng.uniform(size=(3, 16, 16)) > 0.4).astype(np.float32)
    # 1e-6 relative: at ~26 dB one float32 ulp is 1.9e-6, so an absolute
    # 1e-6 would be finer than the type both sides compute in
    got = metrics.psnr_clamped(a, b).numpy()
    want = np.asarray(jmetrics.psnr_clamped(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=0, rtol=1e-6)
    assert got[2] == 100.0
    for mask in (m, np.repeat(m[..., None], 3, -1)):
        got = metrics.psnr_masked(a, b, mask).numpy()
        want = np.asarray(jmetrics.psnr_masked(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, atol=0, rtol=1e-6)


def test_ssim_matches_jax_and_the_float64_reference():
    # noise (as tests/test_metrics_precision.py's range check): within 1e-6
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    got = float(metrics.ssim_metric(a, b))
    assert abs(got - float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))) < 1e-6
    assert -1.0 <= got <= 1.0
    # real views: the moments are taken in float64, so the port sits within
    # 1e-6 of the float64 reference; the JAX package's float32 sums sit up
    # to ~8e-6 from that reference on these pairs, so the port is held to
    # JAX there at 2e-5 (its own float32 error, not a looser port)
    imgs = _relay_pngs(6)
    for x, y in zip(imgs[0::2], imgs[1::2]):
        got = float(ssim(torch.as_tensor(x[None]), torch.as_tensor(y[None])))
        assert abs(got - _np_ssim_f64(x, y)) < 1e-6
        assert abs(got - float(jax_ssim(jnp.asarray(x[None]), jnp.asarray(y[None])))) < 2e-5
    assert abs(float(ssim(torch.as_tensor(imgs[0][None]),
                          torch.as_tensor(imgs[0][None]))) - 1.0) < 1e-6


def test_consistency_exact_matches_cv2_on_committed_pairs():
    pytest.importorskip("cv2")
    from pixelsynth_tpu.eval.homography import consistency_exact as jax_consistency
    from pixelsynth_tpu_torch.data.demo_data import demo_cameras

    P_in = demo_cameras(1.0)["P"][0]
    pairs = [("R", 1, 8), ("L", 5, 8), ("UR", 2, 4), ("D", 3, 4)]
    for direction, i, n in pairs:
        imgs, Ps = [], []
        for k in (i, i + 1):
            p = os.path.join(SCENE, "scene", f"output_image_{direction}_{k:04d}.png")
            if not os.path.exists(p):
                pytest.skip("relay scene PNGs not committed")
            imgs.append(harness.load_png(p)[..., :3].astype(np.float32) / 255.0)
            Ps.append(get_rt_from_rot(direction, P_in, k, n)[1])
        got = consistency_exact(imgs[0], imgs[1], Ps[0], Ps[1])
        want = jax_consistency(imgs[0], imgs[1], Ps[0], Ps[1])
        assert abs(got["PSNR_vis"] - want["PSNR_vis"]) < 1e-3, (direction, got, want)
        assert got["overlap_frac"] == want["overlap_frac"]


def test_scene_walk_metrics_match_jax_on_committed_walk(tmp_path):
    pytest.importorskip("cv2")
    if not os.path.isdir(os.path.join(SCENE, "scene")):
        pytest.skip("relay scene PNGs not committed")
    W = 128
    jworld, _, jdepth = _jax_heldout_search(W)
    np.savez(tmp_path / "demo_world.npz", texture=jworld["texture"],
             base_radius=jworld["base_radius"],
             waves=np.array([list(w) for w in jworld["waves"]], np.float64),
             depth0=jdepth)
    jcfg = JaxConfig()
    jcfg.model.W, jcfg.sample.num_split = W, 8
    want = jax_walk_metrics(jcfg, str(tmp_path), SCENE, str(tmp_path))
    cfg = Config()
    cfg.model.W, cfg.sample.num_split = W, 8
    world, _, _ = pano.heldout_demo_world(W)
    got = scene_walk_metrics(cfg, world, SCENE, str(tmp_path / "port"))
    assert got["n_scene_views_scored"] == want["n_scene_views_scored"] == 40
    for k in ("scene_adjacent_consistency_psnr", "scene_gt_psnr"):
        assert abs(got[k] - want[k]) < 1e-3, k
    for k in ("scene_gt_psnr_by_numerator", "scene_gt_psnr_by_direction"):
        assert sorted(got[k]) == sorted(want[k])
        for key in want[k]:
            assert abs(got[k][key] - want[k][key]) < 1e-3, (k, key)
    # the port's strip holds the same pixels as the JAX package's
    from PIL import Image

    assert np.array_equal(harness.load_png(str(tmp_path / "port" / "scene_strip.png")),
                          np.asarray(Image.open(tmp_path / "scene_strip.png")))


def test_png_writer_and_reader_against_pil(tmp_path):
    from PIL import Image

    from pixelsynth_tpu.eval.harness import save_png as jax_save_png

    rng = np.random.default_rng(1)
    for img in (rng.uniform(-1, 1, (20, 30, 3)), rng.uniform(0, 1, (17, 9, 3))):
        img = img.astype(np.float32)
        harness.save_png(str(tmp_path / "port.png"), img)
        jax_save_png(str(tmp_path / "jax.png"), img)
        got = np.asarray(Image.open(tmp_path / "port.png"))
        assert got.dtype == np.uint8 and got.shape == img.shape
        assert np.array_equal(got, np.asarray(Image.open(tmp_path / "jax.png")))
        assert np.array_equal(harness.load_png(str(tmp_path / "port.png")), got)
    # files PIL wrote (its adaptive row filters), RGB and RGBA
    committed = sorted(glob.glob(os.path.join(RELAY, "**", "*.png"), recursive=True))
    assert committed
    for p in committed[:3] + committed[-2:]:
        assert np.array_equal(harness.load_png(p), np.asarray(Image.open(p)))
    rgba = rng.integers(0, 256, (11, 13, 4), dtype=np.uint8)
    rgba = np.cumsum(rgba, axis=1).astype(np.uint8)   # rows PIL filters
    Image.fromarray(rgba, "RGBA").save(tmp_path / "rgba.png")
    assert np.array_equal(harness.load_png(str(tmp_path / "rgba.png")), rgba)
