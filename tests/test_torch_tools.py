"""The port's profiling and tuning tools, the weight exporter and the script
twins against the JAX package's: the same inputs bit for bit, the same
output keys, and the same scores from the same views."""

import glob
import importlib
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from pixelsynth_tpu.tools import export_torch_weights as jexport
from pixelsynth_tpu.tools import profile_splat as jprofile_splat
from pixelsynth_tpu.tools import scene_drift as jdrift
from pixelsynth_tpu.tools import tune_splat as jtune
from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.tools import export_torch_weights, profile_splat, scene_drift
from pixelsynth_tpu_torch.tools import tune_splat
from test_torch_models import tiny
from torch_threads import _few_torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
W = 32


def test_profile_splat_inputs_bit_equal_to_jax():
    """The bench protocol's points: W=256, 2 x 131072, C=64, valid 90%."""
    W0, pts, fts, vld = profile_splat._inputs()
    jW, jpts, jfts, jvld = jprofile_splat._inputs()
    assert W0 == jW == 256
    for got, want in ((pts, jpts), (fts, jfts), (vld, jvld)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tune_splat_inputs_bit_equal_to_jax():
    for args in ((32, 100, 2), (128, 3000, 1, 5)):
        for got, want in zip(tune_splat._inputs(*args), jtune._inputs(*args)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tune_splat_sweep_rows_have_jax_keys():
    """A two-row grid at W=32 (and a row the radius rules out): the rows
    and their keys are JAX's, the default's deltas are 0, and a row that
    changes only the plain version's group size gives the same image."""
    grid = [(16, 1024, 2), (16, 128, 4), (4, 256, 4)]
    got = tune_splat.sweep(W, 300, 2, grid, reps=1, device="cpu")
    want = jtune.sweep(W, 300, 2, grid, reps=1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert isinstance(g["ms"], float) and g["ms"] > 0
    assert got[0]["knobs"] == "default"
    assert got[0]["max_abs_delta"] == 0.0 and got[0]["bg_delta_frac"] == 0.0
    # tile_group only regroups the plain blend: the same image
    assert got[1]["max_abs_delta"] <= 1e-5 and got[1]["bg_delta_frac"] == 0.0


PROFILE_VIEW_KEYS = ["depth_unet_ms", "splat_cumulative_ms", "masks_jax_ms",
                     "masks_host_ms", "vq_encode_ms", "ar_fill_ms", "n_bg_cells",
                     "vq_decode_S_ms", "decoder_S_ms", "disc_2S_ms", "view_step_ms",
                     "stage_sum_ms"]   # pixelsynth_tpu/tools/profile_view.py's keys


def test_profile_view_at_a_tiny_config():
    from pixelsynth_tpu_torch.pipeline import PixelSynth
    from pixelsynth_tpu_torch.tools.profile_view import profile_view

    ps = PixelSynth(tiny(Config()), device="cpu")
    out = profile_view(ps, samples=2, reps=1, cloud_capacity=2048, device="cpu")
    assert list(out) == PROFILE_VIEW_KEYS
    for k, v in out.items():
        assert np.isfinite(v) and v >= 0, (k, v)
    assert isinstance(out["n_bg_cells"], int)
    # the configured backend is put back
    assert ps.cfg.model.lmconv.masks_backend == Config().model.lmconv.masks_backend


def _hotspot_keys(W, S):
    """pixelsynth_tpu/tools/profile_hotspots.py's keys at W and S."""
    keys = ["unet_full_ms", "unet_nospectral_ms"]
    for res, cin, cout in [(W, 3, 32), (W // 2, 32, 64), (W // 4, 64, 128),
                           (W // 8, 128, 256), (W // 16, 256, 256)]:
        keys += [f"conv4x4s2_{res}_{cin}to{cout}_{t}_ms" for t in ("f32", "bf16")]
    for res, c in ((W // 2, 64), (W // 4, 128)):
        keys += [f"resize_bilinear_{res}x{c}_S{S}_ms", f"upsample_nn_{res}x{c}_S{S}_ms"]
    return keys + ["decoder_S_ms", "decoder_S1_ms"]


def test_profile_hotspots_at_a_tiny_config():
    from pixelsynth_tpu_torch.tools.profile_hotspots import profile_hotspots

    out = profile_hotspots(W, 2, 1, cfg=tiny(Config()), device="cpu")
    assert list(out) == _hotspot_keys(W, 2)
    assert all(np.isfinite(v) and v >= 0 for v in out.values())


def test_sweep_speculative_at_a_tiny_config():
    """The JAX tool's line keys a depth; a forward commits 1..spec+1 cells."""
    from pixelsynth_tpu_torch.tools.sweep_speculative import sweep_speculative

    rows = sweep_speculative((2, 4), pop=4, reps=1, cfg=tiny(Config()), device="cpu")
    assert [r["spec"] for r in rows] == [2, 4]
    for r in rows:
        assert list(r) == ["spec", "fill_s", "cell_ms", "cells_per_fwd"]
        assert r["fill_s"] > 0 and r["cell_ms"] > 0
        assert 1 <= r["cells_per_fwd"] <= r["spec"] + 1


class _FakeGenerator:
    """generate_scene's outputs as fixed numpy views from a seed: what both
    packages' walk_and_score score."""

    def __init__(self, W, directions, num_split, seed=0):
        from pixelsynth_tpu_torch.geometry.paths import num_split_for_direction

        rng = np.random.default_rng(seed)
        self.out = {"CloudValidCount": np.array([1234])}
        for d in directions:
            n = num_split_for_direction(d, num_split)
            for num in range(n + 1):
                self.out[f"PredImg_{d}_{num}"] = rng.uniform(-1, 1, (1, W, W, 3)).astype(
                    np.float32)
                fs = rng.uniform(-1, 1, (1, W, W, 3)).astype(np.float32)
                fs[:, : W // 4] = 0.0
                self.out[f"FeaturesImg_{d}_{num}"] = fs
        self.calls = []

    def generate_scene(self, img, K, Kinv, P, Pinv, **kw):
        self.calls.append((np.asarray(img), kw["directions"], kw["num_split"]))
        return self.out


def test_scene_drift_scores_match_jax(tmp_path):
    """The same fake views on the same held-out world: the input view,
    every record and every summary within 1e-5; the panels are PNGs."""
    from pixelsynth_tpu_torch.data.panorama import heldout_demo_world

    world, _, _ = heldout_demo_world(W)
    dirs = ["R", "L"]
    got_gen, want_gen = _FakeGenerator(W, dirs, 2), _FakeGenerator(W, dirs, 2)
    got = scene_drift.walk_and_score(got_gen, world, W, num_split=2, directions=dirs,
                                     dump_dir=str(tmp_path / "panels"))
    want = jdrift.walk_and_score(want_gen, world, W, num_split=2, directions=dirs)
    np.testing.assert_allclose(got_gen.calls[0][0], want_gen.calls[0][0], atol=1e-5)
    assert list(got) == list(want)
    for k in got:
        if k in ("walk_seconds", "records"):
            continue
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            np.testing.assert_allclose(list(got[k].values()), list(want[k].values()),
                                       atol=1e-5)
        elif isinstance(want[k], float):
            assert abs(got[k] - want[k]) <= 1e-5, k
        else:
            assert got[k] == want[k], k
    assert len(got["records"]) == len(want["records"]) == 6
    for g, w in zip(got["records"], want["records"]):
        assert list(g) == list(w)
        for k in g:
            assert abs(g[k] - w[k]) <= 1e-5 if isinstance(w[k], float) else g[k] == w[k]
    assert len(glob.glob(str(tmp_path / "panels" / "*.png"))) == 6


def test_scene_drift_keeps_jax_configs():
    assert scene_drift.CONFIGS == jdrift.CONFIGS


def _vgg19_features_layout(rng):
    """An nn.Sequential with torchvision's vgg19().features indices: convs
    at 0, 2, 5, 7, ... (ReLU and max-pool modules between)."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    layers, cin = [], 3
    for c in cfg:
        if c == "M":
            layers.append(torch.nn.MaxPool2d(2))
            continue
        conv = torch.nn.Conv2d(cin, c, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(rng.normal(size=conv.weight.shape)))
            conv.bias.copy_(torch.as_tensor(rng.normal(size=conv.bias.shape)))
        layers += [conv, torch.nn.ReLU()]
        cin = c
    return torch.nn.Sequential(*layers)


def test_export_features_round_trips_through_the_vgg19_loader(tmp_path):
    from pixelsynth_tpu_torch.models.losses import VGG19Features, load_torch_vgg19
    from pixelsynth_tpu_torch.weights import merge_collections

    seq = _vgg19_features_layout(np.random.default_rng(0))
    path = str(tmp_path / "vgg19_features.npz")
    assert export_torch_weights.export_features(seq, path) == 32
    vgg = VGG19Features()
    vgg.load_flax(merge_collections(load_torch_vgg19(path)))
    convs = [m for m in seq if isinstance(m, torch.nn.Conv2d)]
    mine = [m for m in vgg.modules() if isinstance(m, torch.nn.Conv2d) or
            (hasattr(m, "weight") and getattr(m, "weight") is not None
             and m.weight.dim() == 4)]
    assert mine
    for a, b in zip(mine, convs):
        torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
        torch.testing.assert_close(a.bias, b.bias, rtol=0, atol=0)


class _FakeInceptionV3(torch.nn.Module):
    """pytorch_fid's InceptionV3 layout: blocks.<i>.<module>...."""

    def __init__(self, output_blocks):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.blocks = torch.nn.ModuleList([
            torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4)),
            torch.nn.Sequential(torch.nn.Conv2d(4, 2, 1))])
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def test_export_inception_fid_matches_jax_with_a_fake_pytorch_fid(tmp_path, monkeypatch):
    fake_pkg = types.ModuleType("pytorch_fid")
    fake = types.ModuleType("pytorch_fid.inception")
    fake.InceptionV3 = _FakeInceptionV3
    fake_pkg.inception = fake
    monkeypatch.setitem(sys.modules, "pytorch_fid", fake_pkg)
    monkeypatch.setitem(sys.modules, "pytorch_fid.inception", fake)
    got_path, want_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert export_torch_weights.export_inception_fid(got_path) == "pytorch_fid"
    jexport.export_inception_fid(want_path)
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        # "blocks.<i>." collapsed: blocks.0.1.running_mean -> 1.running_mean
        assert "1.running_mean" in got.files and "0.weight" in got.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


def test_export_without_the_packages_skips_each_file(tmp_path, capsys):
    """No torchvision, pytorch_fid or lpips here: main names each and
    writes nothing."""
    for name in ("torchvision", "pytorch_fid", "lpips"):
        if importlib.util.find_spec(name) is not None:
            pytest.skip(f"{name} is installed")
    export_torch_weights.main(["--out", str(tmp_path)])
    text = capsys.readouterr().out
    for name in ("torchvision", "pytorch_fid", "lpips"):
        assert name in text
    assert os.listdir(tmp_path) == []


def _script_imports():
    """(python -m modules, (module, name) of every `from m import a, b`)
    of scripts/torch_*.sh."""
    mods, names = set(), set()
    scripts = sorted(glob.glob(os.path.join(ROOT, "scripts", "torch_*.sh")))
    for path in scripts:
        text = open(path).read()
        mods |= set(re.findall(r"python -m ([\w.]+)", text))
        for mod, items in re.findall(r"^from ([\w.]+) import (.+)$", text, re.M):
            names |= {(mod, n.strip()) for n in items.split(",")}
    return scripts, mods, names


def test_script_twins_name_what_the_port_has():
    scripts, mods, names = _script_imports()
    twins = {os.path.basename(p)[len("torch_"):]
             for p in scripts}
    originals = {os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "scripts", "*.sh"))
                 if not os.path.basename(p).startswith("torch_")}
    assert twins == originals and len(twins) == 7
    assert all(m.startswith("pixelsynth_tpu_torch.") for m in mods)
    assert all(m.startswith("pixelsynth_tpu_torch.") for m, _ in names)
    for m in mods:
        assert hasattr(importlib.import_module(m), "main"), m
    for m, n in names:
        assert hasattr(importlib.import_module(m), n), (m, n)
