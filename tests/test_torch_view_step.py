"""The slice as a whole: the port's view step and one-direction walk
against the JAX package's, same weights, on a tiny config.

The PixelCNN computes in f32, the decoder's noise is zero and the
temperature is 1e-4, so sampling is an argmax chain on both sides (their
random streams differ, but an argmax chain draws nothing); the test first
checks the top-2 logit gap of every sampled cell, so it cannot flake on a
near-tie.

The same view is then driven under the other sampling backends: "xla" (the
module path through the plain masked conv) and "pallas" with
`sort_backend="pallas"` (the module path through K3's wrapper and the K5
binner; on the CPU both wrappers take their plain versions), each against
the JAX view step under the same config, at the tolerances of "fused".
Off the TPU the JAX package itself routes `sort_backend="pallas"` to its
library sort (`_bin_dispatch`); tests/test_torch_sort.py holds the two
binners' tables equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import Config as JaxConfig
from pixelsynth_tpu.geometry.paths import get_rt_from_rot
from pixelsynth_tpu.ops.lmconv_fused import make_fused_logits_fn as jax_fused_fn
from pixelsynth_tpu.pipeline import CloudState as JaxCloudState
from pixelsynth_tpu.pipeline import PixelSynth as JaxPixelSynth
from pixelsynth_tpu.scene import SceneGenerator as JaxSceneGenerator
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
from pixelsynth_tpu_torch.ops import sort_kernel as K5
from pixelsynth_tpu_torch.ops import splat as torch_splat
from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth, random_pixelcnn_params
from pixelsynth_tpu_torch.scene import SceneGenerator
from pixelsynth_tpu_torch.weights import from_jax_params, unflatten_tree
from test_torch_models import _fill
from torch_threads import _few_torch_threads  # noqa: F401

W = 64
CAP = 2 * W * W


def tiny(cfg):
    cfg.model.W = W
    cfg.model.unet_num_filters = 4
    cfg.model.ngf = 8
    cfg.model.ndf = 8
    cfg.model.vqvae.channel = 16
    cfg.model.vqvae.n_res_channel = 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    cfg.model.lmconv.compute_dtype = "float32"
    cfg.model.splat.tile_group = 4
    return cfg


def backends(cfg, sample_backend, sort_backend):
    cfg.model.lmconv.sample_backend = sample_backend
    cfg.model.splat.sort_backend = sort_backend
    return cfg


KW = dict(num_samples=2, temperature=1e-4, noise_mode="zero", cloud_capacity=CAP)


@pytest.fixture(scope="module")
def gens():
    jps = JaxPixelSynth(tiny(JaxConfig()))
    rng = np.random.default_rng(0)
    img = jnp.zeros((1, W, W, 3))
    k = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(lambda: jps.unet.init({"params": k}, img, train=False)),
        "projector": jax.eval_shape(lambda: jps.projector.init(
            {"params": k, "noise": k}, img, jnp.zeros((1, W, W), bool), train=False)),
        "vqvae": jax.eval_shape(lambda: jps.vqvae.init({"params": k}, img, train=False)),
        "disc": jax.eval_shape(lambda: jps.disc.init({"params": k}, img, train=False)),
    }
    variables = _fill(shapes, rng)
    cfg = tiny(Config())
    pcnn = random_pixelcnn_params(cfg, torch.Generator().manual_seed(0))
    variables["pixelcnn"] = {"params": unflatten_tree(
        {n: jnp.asarray(v.numpy()) for n, v in pcnn.items()})}
    jgen = JaxSceneGenerator(jps, variables, **KW)
    ps = PixelSynth(cfg, device="cpu",
                    state_dicts=from_jax_params(jax.device_get(variables), cfg))
    return jps, jgen, SceneGenerator(ps, **KW), variables


def _input(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, W), indexing="ij")
    img = np.stack([np.sin(3 * xx), np.cos(2 * yy), xx * yy], -1)
    return np.clip(0.8 * img + 0.1 * rng.normal(size=img.shape), -1, 1)[None].astype(
        np.float32)


def _check_view(jps, jgen, gen, variables):
    """One view through both packages; returns the port's outputs."""
    img = _input(1)
    I = np.eye(4, dtype=np.float32)[None]
    _, RT = get_rt_from_rot("R", I, 2, 2)
    cams = {"K": I, "Kinv": I, "P_in": I, "Pinv_in": I, "P_out": RT}
    best_j, out_j = jgen.generate_view(
        jnp.asarray(img), {k: jnp.asarray(v) for k, v in cams.items()},
        JaxCloudState.empty(1, CAP, 3), None, jnp.asarray(I), jax.random.PRNGKey(4))
    best, out = gen.generate_view(img, cams, CloudState.empty(1, CAP, 3, "cpu"),
                                  None, I, seed=4)

    np.testing.assert_allclose(out["depth"].numpy(), np.asarray(out_j["depth"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["gen_fs"].numpy(), np.asarray(out_j["gen_fs"]),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(out["bg"].numpy(), np.asarray(out_j["bg"]))
    order_j, masks_j, bg_ds_j = jps.masks_for_background(out_j["bg"])
    np.testing.assert_array_equal(out["order"].numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(out["masks"].numpy(), np.asarray(masks_j))
    codes_j, _ = jps.vq_encode(variables["vqvae"], out_j["gen_fs"])
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(codes_j))

    # the sampled codes are the argmax chain of the JAX model: teacher-forced
    # JAX logits on the port's samples pick every sampled cell, by a margin
    sampled = out["sampled"]
    S = sampled.shape[0]
    bg_cells = np.repeat(np.asarray(bg_ds_j).reshape(1, -1) >= 1 - 1e-6, S, 0)
    assert bg_cells.sum() > 0
    jfn = jax_fused_fn(variables["pixelcnn"], jnp.repeat(masks_j, S, 0),
                       nr_resnet=2, max_dilation=2, num_classes=512,
                       compute_dtype="float32")
    logits = np.asarray(jfn(jnp.asarray(sampled.numpy()), jnp.ones(sampled.shape)))
    logits = logits.reshape(S, -1, 512)[bg_cells]
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    np.testing.assert_array_equal(sampled.numpy().reshape(S, -1)[bg_cells],
                                  logits.argmax(-1))
    np.testing.assert_allclose(best.numpy(), np.asarray(best_j), atol=2e-3)
    return out, int(bg_cells[0].sum())


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_view_step_matches_jax(gens):
    _check_view(*gens)


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_port_stitched_npz_renders_the_jax_view(gens, tmp_path):
    """A stitched.npz written by the port (the fixture's weights as the
    trainer's state dicts -> to_jax_params -> save_stitched_npz, float16
    leaves) loads in the JAX package's demo.load_model and in the port,
    and the two give the same view.  The JAX side reuses the fixture's
    compiled view step: the file's config is the fixture's (load_model
    resets the splat's schedule knobs, whose output is bit-identical:
    JAX's Config.refresh_splat_perf_knobs) and its trees have the
    fixture's structure, shapes and dtypes."""
    import copy

    from pixelsynth_tpu import demo as jax_demo
    from pixelsynth_tpu.utils.devices import put_variables
    from pixelsynth_tpu_torch.tools.stitch_checkpoint import save_stitched_npz
    from pixelsynth_tpu_torch.weights import to_jax_params

    jps, jgen, _, variables = gens
    cfg = tiny(Config())
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)),
                         cfg, trainable=True)
    npz = str(tmp_path / "stitched.npz")
    save_stitched_npz(npz, to_jax_params(sd, cfg), cfg, {"prior": "test"})
    loaded_ps, jvars = jax_demo.load_model(npz)
    assert loaded_ps.cfg.to_json() == copy.deepcopy(jps.cfg).refresh_splat_perf_knobs().to_json()
    assert (jax.tree_util.tree_structure(jvars)
            == jax.tree_util.tree_structure(jgen.variables))
    stitched = copy.copy(jgen)
    stitched.variables = put_variables(jvars)
    _check_view(jps, stitched, SceneGenerator(PixelSynth.from_stitched(npz, device="cpu"),
                                              **KW), jvars)


@pytest.mark.filterwarnings("ignore:SceneGenerator")
@pytest.mark.parametrize("sample_backend,sort_backend",
                         [("xla", "xla"), ("pallas", "pallas")])
def test_view_step_backends_match_jax(gens, sample_backend, sort_backend):
    """The slice of the per-layer engines: without `.at` both packages
    sample one cell per forward through the module."""
    variables = gens[3]
    jps = JaxPixelSynth(backends(tiny(JaxConfig()), sample_backend, sort_backend))
    jgen = JaxSceneGenerator(jps, variables, **KW)
    cfg = backends(tiny(Config()), sample_backend, sort_backend)
    ps = PixelSynth(cfg, device="cpu",
                    state_dicts=from_jax_params(jax.device_get(variables), cfg))
    convs, sorts = K3.PLAIN_CALLS["masked_conv"], K5.PLAIN_CALLS["sort_kv"]
    binners = dict(torch_splat.BINNER_CALLS)
    _, n_bg = _check_view(jps, jgen, SceneGenerator(ps, **KW), variables)
    # which engine ran, by the wrappers' counts: 32 masked convs a forward
    # and one forward per background cell through K3's wrapper, one K5 sort
    # per splat -- or neither
    kernel_path = sample_backend == "pallas"
    assert K3.PLAIN_CALLS["masked_conv"] - convs == (32 * n_bg if kernel_path else 0)
    assert K5.PLAIN_CALLS["sort_kv"] - sorts == int(sort_backend == "pallas")
    took = {k: torch_splat.BINNER_CALLS[k] - binners[k] for k in binners}
    assert took == {"counting": 0, "sort_kernel": int(sort_backend == "pallas"),
                    "batched": int(sort_backend == "xla")}


@pytest.mark.parametrize("field,value", [("sample_backend", "triton"),
                                         ("masks_backend", "triton")])
def test_pixelsynth_raises_on_lmconv_values_the_port_does_not_implement(field, value):
    cfg = tiny(Config())
    setattr(cfg.model.lmconv, field, value)
    with pytest.raises(NotImplementedError, match=field):
        PixelSynth(cfg, device="cpu")


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_one_direction_walk_matches_jax(gens):
    _, jgen, gen, _ = gens
    img = _input(2)
    I = np.eye(4, dtype=np.float32)[None]
    want = jgen.generate_scene(jnp.asarray(img), I, I, I, I, directions=["R"],
                               num_split=1, rng=jax.random.PRNGKey(2))
    got = gen.generate_scene(img, I, I, I, I, directions=["R"], num_split=1, seed=2)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["PredImg_R_1"], want["PredImg_R_1"], atol=2e-3)
    np.testing.assert_array_equal(got["ForegroundImg_R_1"], want["ForegroundImg_R_1"])
    np.testing.assert_array_equal(got["CloudValidCount"], want["CloudValidCount"])
    # The walk's second view renders the carried cloud back at the input
    # pose, where points land on pixel centres exactly at the splat radius
    # and at depths that share 16-bit z buckets: there the last bit of the
    # 4x4 transform (the frameworks round it differently, ~4e-6 px) decides
    # coverage and front-to-back order, and JAX's own splat moves by up to
    # 0.27 under that perturbation.  So this view is held pixel-wise: all
    # but 1% of its values within 2e-3.
    close = np.abs(got["PredImg_R_0"] - want["PredImg_R_0"]) <= 2e-3
    assert close.mean() >= 0.99, close.mean()


def _held_like_the_walk(got, want, views):
    """A walk's views against JAX's as the tests above hold them: a view
    at the input pose (numerator 0) pixel-wise, all but 1% of its values
    within 2e-3; every other view within 2e-3 but at most two values (the
    decoder's saturated-tanh cancellations, test_two_imgs_matches_jax)."""
    for k in views:
        if k.endswith("_0"):
            close = np.abs(got[k] - want[k]) <= 2e-3
            assert close.mean() >= 0.99, (k, close.mean())
        else:
            far = np.abs(got[k] - want[k]) > 2e-3
            assert far.sum() <= 2, (k, np.argwhere(far))


@pytest.mark.filterwarnings("ignore:SceneGenerator")
@pytest.mark.parametrize("mode,direction", [("sequential", "R"), ("two_imgs", "UL")])
def test_walk_modes_match_jax(gens, mode, direction):
    """generate_scene's two other view orders at num_split 2, one direction:
    sequential walks out 0, 1, 2; two_imgs takes gen_two_imgs' split of 2
    and renders 2, 1, 0."""
    _, jgen, gen, _ = gens
    img = _input(5)
    I = np.eye(4, dtype=np.float32)[None]
    kw = {mode: True}
    want = jgen.generate_scene(jnp.asarray(img), I, I, I, I, directions=[direction],
                               num_split=2, rng=jax.random.PRNGKey(6), **kw)
    got = gen.generate_scene(img, I, I, I, I, directions=[direction], num_split=2,
                             seed=6, **kw)
    assert sorted(got) == sorted(want)
    views = sorted(k for k in want if k.startswith("PredImg_"))
    assert views == [f"PredImg_{direction}_{i}" for i in range(3)]
    _held_like_the_walk(got, want, views)
    key = f"ForegroundImg_{direction}_2"
    assert np.mean(got[key] == want[key]) >= 0.99


def test_consistency_fixtures_match_jax(gens):
    """make_fixtures_for_item on the fixture's U-Net: the z-buffer masks of
    the full and half rotation exactly, the reference points to 1e-5."""
    from pixelsynth_tpu.eval.consistency_fixtures import make_fixtures_for_item as jax_fx
    from pixelsynth_tpu_torch.eval.consistency_fixtures import make_fixtures_for_item

    jps, _, gen, variables = gens
    img = _input(6)
    I = np.eye(4, dtype=np.float32)[None]
    want = jax_fx(jps, variables, jnp.asarray(img), *([jnp.asarray(I)] * 4), "UR", grid=8)
    got = make_fixtures_for_item(gen.ps, img, I, I, I, I, "UR", grid=8)
    assert sorted(got) == sorted(want) == ["mask1", "mask2", "pts1", "pts2"]
    for k in ("mask1", "mask2"):
        assert got[k].dtype == np.uint8 and 0 < got[k].mean() < 1
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ("pts1", "pts2"):
        assert got[k].shape == (64, 2)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5)


def _cams_R(num=2, denom=2):
    I = np.eye(4, dtype=np.float32)[None]
    _, RT = get_rt_from_rot("R", I, num, denom)
    return {"K": I, "Kinv": I, "P_in": I, "Pinv_in": I, "P_out": RT}


def test_splat_view_and_render_no_outpaint_match_jax(gens):
    """The no-outpaint path (depth -> lift -> splat -> decoder) and its
    splat, without decoder noise on both sides (their noise streams
    differ)."""
    jps, _, gen, variables = gens
    ps = gen.ps
    img = _input(1)
    cams = _cams_R()
    jcams = {k: jnp.asarray(v) for k, v in cams.items()}
    tcams = {k: torch.as_tensor(v) for k, v in cams.items()}

    @jax.jit
    def jax_side(v, x, c):
        depth, _ = jps.regress_depth(v["unet"], x)
        return jps.splat_view(x, depth, c), jps.render_no_outpaint(
            v, x, c, rngs={"noise": jax.random.PRNGKey(0)}, noise_scale=0.0)

    (fs_j, bg_j, cloud_j), want = jax_side(variables, jnp.asarray(img), jcams)
    with torch.no_grad():
        t_img = torch.as_tensor(img)
        fs, bg, cloud = ps.splat_view(ps.features(t_img), ps.regress_depth(t_img), tcams)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_j), atol=5e-4, rtol=1e-3)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(bg_j))
    np.testing.assert_allclose(cloud.numpy(), np.asarray(cloud_j), atol=1e-4, rtol=1e-5)

    got = ps.render_no_outpaint(t_img, tcams, noise_scale=0.0)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["PredDepth"].numpy(), np.asarray(want["PredDepth"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["Background"].numpy(), np.asarray(want["Background"]))
    np.testing.assert_allclose(got["FeaturesImg"].numpy(), np.asarray(want["FeaturesImg"]),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got["PredImg"].numpy(), np.asarray(want["PredImg"]), atol=2e-3)


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_two_imgs_matches_jax(gens):
    """gen_two_imgs on one item: the full and the half rotation, then back
    at the input pose.  The JAX side runs its `generate_two_imgs` on the
    fixture's generator (same settings, its compiled view step)."""
    from pixelsynth_tpu.scene import TwoImageGenerator as JaxTwoImageGenerator
    from pixelsynth_tpu_torch.scene import TwoImageGenerator

    _, jgen, gen, _ = gens
    img = _input(3)
    I = np.eye(4, dtype=np.float32)[None]
    want = JaxTwoImageGenerator.generate_two_imgs(jgen, jnp.asarray(img), I, I, I, I,
                                                  ["UR"], rng=jax.random.PRNGKey(5))
    got = TwoImageGenerator(gen.ps, **KW).generate_two_imgs(img, I, I, I, I, ["UR"],
                                                            seed=5)
    assert sorted(got) == sorted(want) == ["PredImg_0", "PredImg_1", "PredImg_2"]
    # Every value within 2e-3 but at most two of the 12288 a view: this
    # fixture's random refinement decoder grows its activations to ~1e5
    # (median |pre-tanh| 7e4), so tanh saturates everywhere except at the
    # odd pixel whose pre-tanh value is a near-zero cancellation of such
    # terms, where float32 summation order alone moves the output by up to
    # 0.24 (the decoder on identical inputs in both frameworks; one such
    # value in the half-rotation view of this input, in 2 of 5 inputs tried)
    for k in ("PredImg_2", "PredImg_1"):
        far = np.abs(got[k] - want[k]) > 2e-3
        assert far.sum() <= 2, (k, np.argwhere(far))
    # back at the input pose: float-sensitive in both frameworks, held as
    # test_one_direction_walk_matches_jax holds its input-pose view
    close = np.abs(got["PredImg_0"] - want["PredImg_0"]) <= 2e-3
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.filterwarnings("ignore:SceneGenerator")
def test_relay_evals_match_jax(gens, monkeypatch):
    """The relay report's paired eval and two-image consistency on two
    held-out pairs, in batches of one, against the JAX package's, within
    1e-2 dB.  Decoder noise is zero on both sides (their noise streams
    differ): the paired eval's baseline draws noise at scale 1 in both
    packages, so each side's `render_no_outpaint` is handed noise_scale=0;
    the JAX consistency eval's
    generator is the fixture's (same samples, temperature and zero noise,
    its compiled view step), and the port's config has noise "zero"."""
    import functools
    import types

    import pixelsynth_tpu.scene as jax_scene
    from pixelsynth_tpu.eval import relay_report as jrelay
    from pixelsynth_tpu_torch.data.panorama import val_pairs
    from pixelsynth_tpu_torch.eval import relay_report

    jps, jgen, gen, variables = gens
    batches = relay_report.val_batches(val_pairs(W, 2), 1)
    jps_nop = types.SimpleNamespace(W=jps.W, render_no_outpaint=jax.jit(
        functools.partial(jps.render_no_outpaint, noise_scale=0.0)))
    want = jrelay.paired_eval(jps_nop, variables, jgen, batches)
    ps_nop = types.SimpleNamespace(W=gen.ps.W, device=gen.ps.device,
                                   render_no_outpaint=functools.partial(
                                       gen.ps.render_no_outpaint, noise_scale=0.0))
    got = relay_report.paired_eval(ps_nop, gen, batches)
    assert sorted(got) == sorted(want) and got["n_pairs"] == want["n_pairs"] == 2
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) < 1e-2, (k, got[k], v)

    two_imgs = jax_scene.TwoImageGenerator.generate_two_imgs

    def fixture_generator(ps, variables, *, num_samples, temperature, classifier_vars):
        assert (num_samples, temperature) == (jgen.num_samples, jgen.temperature)
        return types.SimpleNamespace(generate_two_imgs=functools.partial(two_imgs, jgen))

    monkeypatch.setattr(jax_scene, "TwoImageGenerator", fixture_generator)
    want = jrelay.two_image_consistency(jps, variables, batches, 2, 1e-4, max_items=2)
    cfg = tiny(Config())
    cfg.sample.noise_mode = "zero"
    ps = PixelSynth(cfg, device="cpu",
                    state_dicts=from_jax_params(jax.device_get(variables), cfg))
    got = relay_report.two_image_consistency(ps, batches, 2, 1e-4, max_items=2)
    assert got["n_consistency_items"] == want["n_consistency_items"] == 2
    for k in ("consistency_psnr_vis", "consistency_overlap_frac"):
        assert abs(got[k] - want[k]) < 1e-2, (k, got[k], want[k])
