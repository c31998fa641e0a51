"""The port stands alone: no module of pixelsynth_tpu_torch (nor
chip_smoke.py) imports JAX, Flax, optax or the JAX package, and its entry points
default to the card."""

import ast
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pixelsynth_tpu"}


def _sources():
    pkg = os.path.join(ROOT, "pixelsynth_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_imports():
    found = []
    sources = list(_sources())
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_entry_points_default_to_the_card():
    """Without device="cpu" the pipeline goes to CUDA: on a machine without
    a card it fails instead of falling back to the CPU."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import PixelSynth

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config()
    cfg.model.W, cfg.model.unet_num_filters, cfg.model.ngf, cfg.model.ndf = 32, 4, 8, 8
    cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 16, 8
    cfg.model.lmconv.nr_filters = 16
    with pytest.raises((RuntimeError, AssertionError)):
        PixelSynth(cfg)
