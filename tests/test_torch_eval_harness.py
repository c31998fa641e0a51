"""The slice as a whole on the CPU: the port's paired and consistency evals
write what its generators return, and the JAX package's metric batteries
and the port's score the same folders alike.

A tiny random-weight model (W=32) runs three held-out panorama pairs in
batches of two (the last batch padded).  Both batteries read the same
PNGs and are given the same pieces: PercSim from one seeded
torchvision-layout npz (the JAX side through its loader), one FID feature
function, and the fixtures of the port's `write_fixtures`.  The view step itself is
held to the JAX package's by tests/test_torch_view_step.py."""

import os

import numpy as np
import pytest

from pixelsynth_tpu.eval import calc_errors as jce
from pixelsynth_tpu.eval import calc_errors_consistency as jcec
from pixelsynth_tpu.eval import metrics as jmet
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.panorama import pair_items, val_pairs
from pixelsynth_tpu_torch.eval import metrics as tmet
from pixelsynth_tpu_torch.eval.calc_errors import calc_errors_quality
from pixelsynth_tpu_torch.eval.calc_errors_consistency import calc_errors_consistency
from pixelsynth_tpu_torch.eval.consistency_fixtures import write_fixtures
from pixelsynth_tpu_torch.eval.harness import (
    eval_consistency, eval_quality, load_png, save_png,
)
from pixelsynth_tpu_torch.geometry.paths import DIRECTION_ORDER
from pixelsynth_tpu_torch.pipeline import CloudState, PixelSynth
from pixelsynth_tpu_torch.scene import SceneGenerator, TwoImageGenerator
from test_torch_eval_nets import write_torchvision_npz
from torch_threads import _few_torch_threads  # noqa: F401

W = 32
KW = dict(num_samples=2, temperature=0.5)


def tiny_cfg():
    cfg = Config()
    cfg.model.W, cfg.model.unet_num_filters, cfg.model.ngf, cfg.model.ndf = W, 4, 8, 8
    cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 16, 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.obs = (3, W // 8, W // 8)
    cfg.model.lmconv.compute_dtype = "float32"
    cfg.model.splat.tile_group = 4
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    ps = PixelSynth(tiny_cfg(), device="cpu", seed=3)
    items = pair_items(val_pairs(W, 3), direction_seed=9)
    vgg = write_torchvision_npz(tmet.VGG16Features(), str(root / "vgg16.npz"), 21)
    quality, consistency = str(root / "quality"), str(root / "consistency")
    eval_quality(ps, items, quality, batch_size=2, seed=5, **KW)
    eval_consistency(ps, items, consistency, batch_size=2, seed=7, **KW)
    return ps, items, vgg, quality, consistency, root


def _batch(items, idxs):
    return {k: np.stack([items[i][k] for i in idxs]) for k in items[0] if k != "direction"}


def _same_png(path, img):
    """path holds what save_png writes for img."""
    want = str(path) + ".want.png"
    save_png(want, img)
    np.testing.assert_array_equal(load_png(path), load_png(want))
    os.remove(want)


def test_eval_quality_writes_generate_view_outputs(setup):
    """input/ tgt/ pred/ fs/ per item, the batch from item i drawn from
    seed + i, the tail batch padded by its last item."""
    ps, items, _, quality, _, _ = setup
    for sub in ("input", "tgt", "pred", "fs"):
        assert sorted(os.listdir(os.path.join(quality, sub))) == [
            "0000.png", "0001.png", "0002.png"], sub
    gen = SceneGenerator(ps, cloud_capacity=W * W, **KW)
    for i0, idxs in ((0, [0, 1]), (2, [2, 2])):
        b = _batch(items, idxs)
        cams = {k: b[k] for k in ("K", "Kinv", "P_in", "Pinv_in", "P_out")}
        best, out = gen.generate_view(b["input_img"], cams,
                                      CloudState.empty(2, W * W, 3, "cpu"), None,
                                      b["Pinv_in"], 5 + i0)
        for j, i in enumerate(idxs[: 2 if i0 == 0 else 1]):
            name = f"{i:04d}.png"
            _same_png(os.path.join(quality, "pred", name), best[j].numpy())
            _same_png(os.path.join(quality, "fs", name), out["gen_fs"][j].numpy())
            _same_png(os.path.join(quality, "input", name), items[i]["input_img"])
            _same_png(os.path.join(quality, "tgt", name), items[i]["output_img"])


def _close(got, want, tol=1e-4):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - v) <= tol * max(1.0, abs(v)), (k, got[k], v)


def _patch_means(img01):
    """A feature function for FID: the means of 8x8 patches (48-d)."""
    x = np.asarray(img01, np.float32)
    B, H, Wd, C = x.shape
    return x.reshape(B, 4, H // 4, 4, Wd // 4, C).mean((2, 4)).reshape(B, -1)


def test_calc_errors_quality_matches_jax(setup):
    """One folder, both batteries, the same PercSim weights and the same
    feature function: the same dict, to 1e-4.  (The port's InceptionV3
    against the JAX package's: tests/test_torch_eval_nets.py.)"""
    _, _, vgg, quality, _, _ = setup
    want = jce.calc_errors_quality(
        quality, percsim=jmet.PercSim(variables=jmet.load_torch_vgg16(vgg)),
        feature_fn=_patch_means, batch=2)
    got = calc_errors_quality(
        quality, percsim=tmet.PercSim(state_dict=tmet.load_torch_vgg16(vgg), device="cpu"),
        feature_fn=_patch_means, batch=2)
    assert sorted(want) == ["FID", "PSNR", "PercSim", "SSIM", "percsim_lt_2.3",
                            "psnr_gt_20", "ssim_gt_0.8"]
    _close(got, want)


def test_eval_consistency_and_its_battery_match_jax(setup, monkeypatch):
    """eval_consistency writes generate_two_imgs' full and half rotations;
    with the port's fixtures, both consistency batteries give the same
    PSNR_vis and PercSim_vis."""
    ps, items, vgg, _, consistency, root = setup
    directions = np.array([it["direction"] for it in items])
    two = TwoImageGenerator(ps, cloud_capacity=2 * W * W, **KW)
    for i0, idxs in ((0, [0, 1]), (2, [2, 2])):
        b = _batch(items, idxs)
        dirs = [DIRECTION_ORDER[directions[i]] for i in idxs]
        outs = two.generate_two_imgs(b["input_img"], b["K"], b["Kinv"], b["P_in"],
                                     b["Pinv_in"], dirs, seed=7 + i0)
        for j, i in enumerate(idxs[: 2 if i0 == 0 else 1]):
            for num in (1, 2):
                _same_png(os.path.join(consistency, f"{i:04d}",
                                       f"output_image_{dirs[j]}_000{num}.png"),
                          outs[f"PredImg_{num}"][j])

    fixtures = str(root / "fixtures")
    write_fixtures(ps, items, fixtures)
    masks = os.path.join(fixtures, "consistency_masks")
    points = os.path.join(fixtures, "consistency_reference_points")
    assert sorted(os.listdir(masks)) == ["0000", "0001", "0002"]
    assert len(os.listdir(points)) == 6
    jax_percsim = jmet.PercSim(variables=jmet.load_torch_vgg16(vgg))
    monkeypatch.setattr(jcec, "PercSim", lambda: jax_percsim)
    want = jcec.calc_errors_consistency(consistency, directions, masks_dir=masks,
                                        points_dir=points)
    got = calc_errors_consistency(
        consistency, directions, masks_dir=masks, points_dir=points,
        percsim=tmet.PercSim(state_dict=tmet.load_torch_vgg16(vgg), device="cpu"))
    assert sorted(want) == ["PSNR_vis", "PercSim_vis"]
    _close(got, want)


def test_calc_errors_cli_on_the_cpu(setup, capsys):
    """`python -m pixelsynth_tpu_torch.eval.calc_errors OUT --device cpu`
    prints the battery's dict, FID included (random-weight networks)."""
    import json

    from pixelsynth_tpu_torch.eval import calc_errors

    quality = setup[3]
    calc_errors.main([quality, "--device", "cpu", "--limit", "2"])
    out = json.loads(capsys.readouterr().out)
    assert {"PSNR", "SSIM", "PercSim", "FID"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
