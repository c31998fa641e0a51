"""`forward_angle` over a NeRF-like circle, and the camera utilities it
rests on, against the JAX package: the camera functions, `project_points`,
`reproject_cloud` and `nerf_like_circle` on the same inputs, and the
port's forward_angle (RGB features, the JAX init's 3 + 1-channel decoder)
against the JAX package's own `forward_angle` on the same seeded weights
and the same NoiseBN draws (tests/torch_noise_bank.py: the JAX package
hands every view one key, so the port must restart the decoder's noise at
every view to draw the same rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.geometry import cameras as jcam
from pixelsynth_tpu.geometry import projection as jproj
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.utils.camera_paths import nerf_like_circle as jax_circle
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.geometry import cameras, projection
from pixelsynth_tpu_torch.ops import splat as K2
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.utils.camera_paths import nerf_like_circle
from pixelsynth_tpu_torch.weights import from_jax_params
from test_torch_models import _converge_spectral, _fill, tiny
from torch_noise_bank import NoiseBank
from torch_threads import _few_torch_threads  # noqa: F401

W = 32


def _rotations(rng, n):
    """n random rotations (QR of normal matrices, det +1), float32."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _extrinsics(rng, n):
    M = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    M[:, :3, :3] = _rotations(rng, n)
    M[:, :3, 3] = rng.normal(size=(n, 3))
    return M


def test_nerf_like_circle_equals_jax():
    for n in (1, 4, 8, 30):
        got, want = nerf_like_circle(n), jax_circle(n)
        assert len(got) == n
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [3, 4])
def test_invert_k_matches_jax(n):
    """3x3 and 4x4 intrinsics, batched: the same divisions, exact."""
    rng = np.random.default_rng(0)
    K = np.broadcast_to(np.eye(n, dtype=np.float32), (5, n, n)).copy()
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(0.5, 2, 5), rng.uniform(0.5, 2, 5)
    K[:, 0, 2], K[:, 1, 2] = rng.normal(size=5), rng.normal(size=5)
    got = cameras.invert_K(torch.as_tensor(K)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcam.invert_K(jnp.asarray(K))))
    np.testing.assert_allclose(got @ K, np.broadcast_to(np.eye(n), K.shape), atol=1e-6)


def test_camera_matrices_and_deltas_match_jax():
    """get_camera_matrices (exact: a transpose and a 3x3 product), get_deltas
    (angle to 1e-4 degrees: arccos near 1 magnifies float32 rounding; the
    translation to 1e-6) and euler_to_rotation_matrix (1e-6)."""
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(6, 3)).astype(np.float32)
    rot = _rotations(rng, 6)
    P, Pinv = cameras.get_camera_matrices(torch.as_tensor(pos), torch.as_tensor(rot))
    jP, jPinv = jcam.get_camera_matrices(jnp.asarray(pos), jnp.asarray(rot))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=1e-6)
    np.testing.assert_array_equal(Pinv.numpy(), np.asarray(jPinv))
    a, b = _extrinsics(rng, 6), _extrinsics(rng, 6)
    da, dt = cameras.get_deltas(torch.as_tensor(a), torch.as_tensor(b))
    jda, jdt = jcam.get_deltas(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), atol=1e-6)
    theta = rng.uniform(-np.pi, np.pi, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(cameras.euler_to_rotation_matrix(torch.as_tensor(theta)),
                               np.asarray(jcam.euler_to_rotation_matrix(theta)), atol=1e-6)


def test_quaternions_match_jax():
    """_quat_mul exactly; jitter_quaternions with JAX's own draws (the
    normal axis and the uniform under its key) injected: 1e-6."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(7, 4)).astype(np.float32)
    r = rng.normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_array_equal(cameras._quat_mul(torch.as_tensor(q), torch.as_tensor(r)),
                                  np.asarray(jcam._quat_mul(jnp.asarray(q), jnp.asarray(r))))
    quat = q[0] / np.linalg.norm(q[0])
    for seed, angle in ((0, 10.0), (3, 30.0)):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        axis = np.array(jax.random.normal(k1, (3,)))
        u = np.array(jax.random.uniform(k2, ()))
        want = jcam.jitter_quaternions(jnp.asarray(quat), key, angle)
        got = cameras.jitter_quaternions(torch.as_tensor(quat), angle_deg=angle,
                                         axis=axis, u=u)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert abs(float(torch.linalg.vector_norm(got)) - 1) < 1e-5
    drawn = cameras.jitter_quaternions(torch.as_tensor(quat),
                                       torch.Generator().manual_seed(0), 10.0)
    delta = 2 * np.degrees(np.arccos(min(1.0, abs(float(drawn @ torch.as_tensor(quat))))))
    assert delta <= 5.0 + 1e-3   # at most half the jitter angle


def test_project_and_reproject_match_jax():
    """project_points (depth (B, H, W) and (B, N)) and reproject_cloud
    against the JAX functions: points, valid flags and the cloud, 1e-4 of
    the pixel coordinates (products of 4x4 matrices in other orders)."""
    rng = np.random.default_rng(3)
    B = 2
    depth = rng.uniform(1, 5, (B, W, W)).astype(np.float32)
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    RT1, RT2, RT3 = (_extrinsics(rng, B) * np.float32(0.3) + np.eye(4, dtype=np.float32)
                     * np.float32(0.7) for _ in range(3))
    RT1inv = np.linalg.inv(RT1).astype(np.float32)
    for d in (depth, depth.reshape(B, -1)):
        got = projection.project_points(*(torch.as_tensor(a) for a in
                                          (d, K, K, RT1, RT1inv, RT2)), W=W)
        want = jproj.project_points(*(jnp.asarray(a) for a in (d, K, K, RT1, RT1inv, RT2)),
                                    W=W)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    cloud = got[2]
    RT3inv = np.linalg.inv(RT3).astype(np.float32)
    pts, valid = projection.reproject_cloud(cloud, torch.as_tensor(K), torch.as_tensor(RT3),
                                            torch.as_tensor(RT3inv), W)
    jpts, jvalid = jproj.reproject_cloud(jnp.asarray(cloud.numpy()), jnp.asarray(K),
                                         jnp.asarray(RT3), jnp.asarray(RT3inv), W)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def rgb_nets():
    """The tiny config's U-Net and refinement decoder (3 + 1 input
    channels, as the JAX package's init builds it), seeded, in both
    packages."""
    jps = JaxPixelSynth(tiny(JaxConfig()))
    cfg = tiny(Config())
    rng = np.random.default_rng(0)
    img = jnp.zeros((1, W, W, 3))
    k = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, img, train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, img, jnp.zeros((1, W, W), bool), train=False)),
    }
    variables = _converge_spectral(_fill(shapes, rng))
    ps = PixelSynth(cfg, device="cpu", state_dicts=from_jax_params(variables, cfg))
    return jps, variables, ps


def test_forward_angle_matches_jax(rgb_nets):
    """The port's forward_angle over nerf_like_circle(4) against the JAX
    package's forward_angle, batch 2: one splat (K2's entry) a view, the
    same depth, and every view to 1e-4 (fp32 both sides; the splat sums
    in other orders, to ~1e-6 here)."""
    jps, v, ps = rgb_nets
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, W, W, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    RTs = nerf_like_circle(4)
    bank = NoiseBank(16, 2)
    before = K2.PLAIN_CALLS["splat_blend"]
    with bank.patch():
        want, want_depth = jps.forward_angle(v, jnp.asarray(img), jnp.asarray(eye),
                                             jnp.asarray(eye), RTs,
                                             rng=jax.random.PRNGKey(3), return_depth=True)
        got, depth = ps.forward_angle(torch.as_tensor(img), torch.as_tensor(eye),
                                      torch.as_tensor(eye), RTs,
                                      gen=torch.Generator().manual_seed(3),
                                      return_depth=True)
    # one view's 16 NoiseBN rows, drawn again at every view on both sides
    assert len(bank.jax_keys) == len(bank.port_keys) == 16
    assert K2.PLAIN_CALLS["splat_blend"] - before == len(RTs)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth), atol=1e-5, rtol=1e-5)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, W, W, 3) and float(g.abs().max()) <= 1.0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    # the views differ: the path moves the camera
    assert float((got[0] - got[2]).abs().max()) > 1e-2


def test_forward_angle_restarts_the_noise_every_view(rgb_nets):
    """With a generator the views of one call draw the same noise: a call
    over the same RT twice gives two identical views, and a second call
    from the same seed repeats the first."""
    _, _, ps = rgb_nets
    img = torch.as_tensor(np.random.default_rng(6).uniform(-1, 1, (1, W, W, 3)),
                          dtype=torch.float32)
    eye = torch.eye(4)[None]
    RT = nerf_like_circle(4)[1]
    a = ps.forward_angle(img, eye, eye, [RT, RT], gen=torch.Generator().manual_seed(4))
    b = ps.forward_angle(img, eye, eye, [RT], gen=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a[0], a[1], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
