"""The comparison baselines against the JAX package on the same seeded
weights: `grid_sample` (the JAX package's own clamp-to-border bilinear
gather, also held to torch's F.grid_sample), `ViewAppearanceFlow` and
`Tatarchenko` at W=256 (their decoder always emits 256x256), batch 1, in
eval; and `depth_warp_forward`, on a U-Net and on depth ties."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.models import baselines as jbase
from pixelsynth_tpu.models.depth_model import depth_warp_forward as jax_warp
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.geometry.cameras import euler_to_rotation_matrix
from pixelsynth_tpu_torch.models import baselines
from pixelsynth_tpu_torch.models.depth_model import depth_warp_forward
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.weights import from_jax_module, from_jax_params
from test_torch_models import _converge_spectral, _fill, tiny
from torch_threads import _few_torch_threads  # noqa: F401


def _grid(rng, B, H, W, lo, hi):
    return rng.uniform(lo, hi, (B, H, W, 2)).astype(np.float32)


def test_grid_sample_matches_jax_and_torch():
    """Inside [-1, 1] and out to +-1.3: the port against the JAX function
    to 1e-6, and against F.grid_sample(align_corners=True,
    padding_mode="border") to 1e-5 -- the JAX clamp (floor clamped into
    the image, the weight x - floor clipped to [0, 1]) reads the border
    value beyond the edge, as torch's border padding does."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 9, 13, 3)).astype(np.float32)
    for lo, hi in ((-1, 1), (-1.3, 1.3)):
        grid = _grid(rng, 2, 9, 13, lo, hi)   # JAX's takes the image's own size
        got = baselines.grid_sample(torch.as_tensor(img), torch.as_tensor(grid))
        want = jbase.grid_sample(jnp.asarray(img), jnp.asarray(grid))
        assert got.shape == (2, 9, 13, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        ref = F.grid_sample(torch.as_tensor(img).permute(0, 3, 1, 2), torch.as_tensor(grid),
                            mode="bilinear", padding_mode="border", align_corners=True)
        np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["ViewAppearanceFlow", "Tatarchenko"])
def test_baseline_matches_flax(name):
    """Batch 1 at W=256 in eval (running statistics), a small relative
    pose: the decoder's output (the flow, or the image) to 1e-4 (fp32; the
    dense layers of 8192 and 4096 inputs sum in other orders).  The flow
    baseline's warped image is held to 2e-3: a flow error e moves a sample
    by e x 127.5 pixels, and the random test image changes by up to ~2 a
    pixel."""
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    RTinv = np.eye(4, dtype=np.float32)[None]
    RT = np.eye(4, dtype=np.float32)[None].copy()
    RT[0, :3, :3] = euler_to_rotation_matrix(torch.tensor([0.05, -0.1, 0.02])).numpy()
    RT[0, :3, 3] = (0.1, -0.05, 0.2)
    jm = getattr(jbase, name)()
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": k}, jnp.asarray(img),
                                            jnp.asarray(RTinv), jnp.asarray(RT), train=False))
    variables = _fill(shapes, rng)
    want, inter = jax.jit(functools.partial(
        jm.apply, train=False,
        capture_intermediates=lambda mdl, _: isinstance(mdl, jbase._ConvDecoder)))(
        variables, jnp.asarray(img), jnp.asarray(RTinv), jnp.asarray(RT))
    want_dec = np.asarray(inter["intermediates"]["_ConvDecoder_0"]["__call__"][0])
    m = getattr(baselines, name)().eval()
    m.load_state_dict(from_jax_module(getattr(baselines, name)(), variables))
    seen = []
    m._ConvDecoder_0.register_forward_hook(lambda mod, i, o: seen.append(o))
    with torch.no_grad():
        got = m(torch.as_tensor(img), torch.as_tensor(RTinv), torch.as_tensor(RT))
    assert got.shape == (1, 256, 256, 3)
    assert want_dec.std() > 1e-3
    np.testing.assert_allclose(seen[0].numpy(), want_dec, atol=1e-4)
    tol = 2e-3 if name == "ViewAppearanceFlow" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.fixture(scope="module")
def warp_nets():
    jcfg, cfg = tiny(JaxConfig()), tiny(Config())
    jps = JaxPixelSynth(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = {"unet": jax.eval_shape(lambda: jps.unet.init(
        {"params": k}, jnp.zeros((1, 32, 32, 3)), train=False))}
    variables = _converge_spectral(_fill(shapes, np.random.default_rng(2)))
    ps = PixelSynth(cfg, device="cpu", state_dicts=from_jax_params(variables, cfg))
    return jps, variables, ps


def _batch(B, W, RT, seed=3):
    img = np.random.default_rng(seed).uniform(-1, 1, (B, W, W, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    return {"input_img": img, "K": eye, "Kinv": eye, "P_in": eye, "Pinv_in": eye,
            "P_out": np.broadcast_to(RT, (B, 4, 4)).copy()}


def test_depth_warp_matches_jax(warp_nets):
    """depth_warp_forward through the U-Net's depth into a rotated, moved
    camera: the image, the visibility mask and the depth equal the JAX
    function's (the scattered colours exactly, the depth to 1e-5)."""
    jps, v, ps = warp_nets
    RT = np.eye(4, dtype=np.float32)
    RT[:3, :3] = euler_to_rotation_matrix(torch.tensor([0.02, 0.08, 0.0])).numpy()
    RT[:3, 3] = (0.05, 0.0, 0.1)
    batch = _batch(2, 32, RT)
    want = jax_warp(jps, v, {k: jnp.asarray(a) for k, a in batch.items()})
    got = depth_warp_forward(ps, {k: torch.as_tensor(a) for k, a in batch.items()})
    np.testing.assert_allclose(got["PredDepth"].numpy(), np.asarray(want["PredDepth"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["VisMask"].numpy(), np.asarray(want["VisMask"]))
    np.testing.assert_array_equal(got["PredImg"].numpy(), np.asarray(want["PredImg"]))
    assert 0 < got["VisMask"].float().mean() < 1


class _ConstantDepth:
    """A stand-in depth regressor for both packages: every pixel at depth
    2, so points that round to one pixel tie exactly."""

    def __init__(self, W, jax_side):
        self.W, self.jax_side = W, jax_side

    def regress_depth(self, *args):
        img = args[-1]
        if self.jax_side:
            return jnp.full(img.shape[:3], 2.0), None
        return torch.full(img.shape[:3], 2.0)


def test_depth_warp_ties_take_the_highest_point_index():
    """K scaled by one half sends each 2 x 2 block of pixels at one depth
    to one pixel: four winners tie there.  The JAX scatter on the CPU keeps
    the highest point index; the port takes that rule explicitly, so the
    images are equal and each pixel holds its block's last pixel."""
    W = 16
    K = np.diag([0.5, 0.5, 1.0, 1.0]).astype(np.float32)[None]
    batch = _batch(1, W, np.eye(4, dtype=np.float32), seed=4)
    batch["K"] = K        # Kinv stays the identity: the NDC grid shrinks by half
    want = jax_warp(_ConstantDepth(W, True), {"unet": None},
                    {k: jnp.asarray(a) for k, a in batch.items()})
    got = depth_warp_forward(_ConstantDepth(W, False),
                             {k: torch.as_tensor(a) for k, a in batch.items()})
    np.testing.assert_array_equal(got["PredImg"].numpy(), np.asarray(want["PredImg"]))
    np.testing.assert_array_equal(got["VisMask"].numpy(), np.asarray(want["VisMask"]))
    # the pixels reached hold some point's colour; find which
    img = batch["input_img"][0].reshape(-1, 3)
    pred = got["PredImg"][0].numpy().reshape(-1, 3)
    reached = got["VisMask"][0].numpy().reshape(-1)
    assert reached.sum() > 4
    from pixelsynth_tpu_torch.geometry.projection import homogeneous_to_pixels, lift_to_cloud
    c = {k: torch.as_tensor(a) for k, a in batch.items()}
    cloud = lift_to_cloud(torch.full((1, W, W), 2.0), c["K"], c["Kinv"], c["Pinv_in"],
                          c["P_out"], W)
    pts, _ = homogeneous_to_pixels(cloud, W)
    flat = (torch.round(pts[0, :, 1]) * W + torch.round(pts[0, :, 0])).long().numpy()
    ties = 0
    for p in np.flatnonzero(reached):
        owners = np.flatnonzero(flat == p)
        ties += len(owners) > 1
        np.testing.assert_array_equal(pred[p], img[owners.max()])
    assert ties > 0
