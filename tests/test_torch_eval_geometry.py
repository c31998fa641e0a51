"""The consistency metric's geometry against the JAX package and OpenCV:
the z-buffer of ops/depth_splat.py bit for bit, the homography fit of
eval/homography.py against cv2.findHomography, and the pair metric against
the JAX package's (which warps with cv2)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.eval import homography as jhom
from pixelsynth_tpu.eval import metrics as jmet
from pixelsynth_tpu.ops import depth_splat as jds
from pixelsynth_tpu_torch.eval import homography as thom
from pixelsynth_tpu_torch.eval import metrics as tmet
from pixelsynth_tpu_torch.ops import depth_splat as tds
from test_torch_eval_nets import write_torchvision_npz
from torch_threads import _few_torch_threads  # noqa: F401


def _points(seed, B=2, N=3000, W=32):
    """Points over and beyond a W x W image: half on exact pixel centres
    and .5 boundaries (rounding ties), with repeated depths (z ties),
    some behind the camera."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, W + 3, (B, N, 2))
    xy[:, : N // 4] = np.round(xy[:, : N // 4])
    xy[:, N // 4: N // 2] = np.floor(xy[:, N // 4: N // 2]) + 0.5
    z = rng.choice(np.array([-0.5, 0.0, 0.7, 1.0, 1.3, 2.0], np.float32), (B, N))
    z[:, N // 2:] = rng.uniform(-0.2, 3.0, (B, N - N // 2))
    return np.concatenate([xy, z[..., None]], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_project_zbuffer_is_bit_exact_with_jax(seed):
    W = 32
    pts = _points(seed, W=W)
    zj, vj = jds.project_zbuffer(jnp.asarray(pts), W)
    zt, vt = tds.project_zbuffer(torch.as_tensor(pts), W)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # ties: several points win the same pixel
    assert vt.sum() > (zt < tds.BIG).sum()
    pts2 = _points(seed + 10, B=2, N=W * W, W=W)
    np.testing.assert_array_equal(
        tds.visibility_masks(torch.as_tensor(pts), torch.as_tensor(pts2), W).numpy(),
        np.asarray(jds.visibility_masks(jnp.asarray(pts), jnp.asarray(pts2), W)))


def _project(h, p):
    q = np.c_[p, np.ones(len(p))] @ h.T
    return q[:, :2] / q[:, 2:]


def _true_h():
    return np.array([[1.05, 0.04, -9.0], [-0.03, 0.97, 6.0], [2e-4, -1e-4, 1.0]])


def test_fit_homography_on_exact_points_matches_cv2():
    rng = np.random.default_rng(2)
    src = rng.uniform(0, 255, (64, 2))
    dst = _project(_true_h(), src)
    got = thom.fit_homography(src, dst)
    want, _ = cv2.findHomography(src, dst)
    assert got[2, 2] == 1.0
    np.testing.assert_allclose(got, want / want[2, 2], atol=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_fit_homography_on_noisy_points_matches_cv2(sigma):
    """The least-squares refinement lands where cv2's does: reprojections
    within 1e-3 px (a plain DLT is ~0.04 px away at sigma 1)."""
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (64, 2))
    dst = _project(_true_h(), src) + rng.normal(0, sigma, (64, 2))
    got = thom.fit_homography(src, dst)
    want, _ = cv2.findHomography(src, dst)
    assert np.abs(_project(got, src) - _project(want, src)).max() < 1e-3


def test_homography_from_points_matches_jax():
    rng = np.random.default_rng(4)
    p1 = rng.uniform(-0.9, 0.9, (256, 2)).astype(np.float32)
    p2 = (p1 * 0.9 + 0.05 + rng.normal(0, 0.004, p1.shape)).astype(np.float32)
    got = thom.homography_from_points(p1, p2)
    want = jhom.homography_from_points(p1.copy(), p2.copy())
    assert np.abs(_project(got, p1 * 100 + 128) - _project(want, p1 * 100 + 128)).max() < 1e-3


def test_consistency_pair_metrics_match_jax(tmp_path):
    """The same pair, masks and points through both packages: PSNR_vis to
    1e-4 dB (the JAX package warps with cv2), PercSim_vis with the same
    VGG16 weights to 1e-4 relative."""
    W = 48
    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.linspace(0, 1, W), np.linspace(0, 1, W), indexing="ij")
    img1 = np.stack([np.sin(5 * xx + 1) * 0.4 + 0.5, yy, xx * yy], -1).astype(np.float32)
    img2 = np.clip(np.roll(img1, 2, axis=1) + rng.normal(0, 0.02, img1.shape), 0, 1
                   ).astype(np.float32)
    m1 = (rng.uniform(size=(W, W)) > 0.2).astype(np.float32)
    m2 = (rng.uniform(size=(W, W)) > 0.2).astype(np.float32)
    g = np.linspace(-0.9, 0.9, 8)
    p1 = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)[:, ::-1]
    p2 = p1 + np.array([-2 * 2.0 / 255, 0.0]) + rng.normal(0, 1e-3, p1.shape)
    path = write_torchvision_npz(tmet.VGG16Features(), str(tmp_path / "vgg.npz"), 6)
    want = jhom.consistency_pair_metrics(
        img1, img2, m1, m2, p1.copy(), p2.copy(),
        jmet.PercSim(variables=jmet.load_torch_vgg16(path)))
    got = thom.consistency_pair_metrics(
        img1, img2, m1, m2, p1, p2, tmet.PercSim(state_dict=tmet.load_torch_vgg16(path),
                                                 device="cpu"))
    assert sorted(got) == sorted(want) == ["PSNR_vis", "PercSim_vis"]
    assert np.isfinite(got["PSNR_vis"]) and got["PSNR_vis"] > 15
    assert abs(got["PSNR_vis"] - want["PSNR_vis"]) < 1e-4
    assert abs(got["PercSim_vis"] - want["PercSim_vis"]) <= 1e-4 * abs(want["PercSim_vis"])
