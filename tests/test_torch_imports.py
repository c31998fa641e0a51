"""The port stands alone: no module of pixelsynth_tpu_torch (nor
chip_smoke.py) imports JAX, Flax, optax or the JAX package, and its entry points
default to the card."""

import ast
import os

import pytest
import torch
from torch_threads import _few_torch_threads  # noqa: F401

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


# the modules of the evaluation slice: none may need OpenCV or PIL either
# (the card's machine has neither)
EVAL_MODULES = [
    "pixelsynth_tpu_torch.ops.depth_splat", "pixelsynth_tpu_torch.eval.metrics",
    "pixelsynth_tpu_torch.eval.inception", "pixelsynth_tpu_torch.eval.homography",
    "pixelsynth_tpu_torch.eval.harness", "pixelsynth_tpu_torch.eval.calc_errors",
    "pixelsynth_tpu_torch.eval.calc_errors_consistency",
    "pixelsynth_tpu_torch.eval.consistency_fixtures", "pixelsynth_tpu_torch.utils.video",
    "pixelsynth_tpu_torch.demo", "pixelsynth_tpu_torch.weights",
    "pixelsynth_tpu_torch.models.classifier", "pixelsynth_tpu_torch.models.losses",
    # the angle / encoder / baselines slice
    "pixelsynth_tpu_torch.geometry.cameras", "pixelsynth_tpu_torch.geometry.projection",
    "pixelsynth_tpu_torch.utils.camera_paths", "pixelsynth_tpu_torch.models.encoderdecoder",
    "pixelsynth_tpu_torch.models.vqvae", "pixelsynth_tpu_torch.models.baselines",
    "pixelsynth_tpu_torch.models.depth_model", "pixelsynth_tpu_torch.models.dmol",
    # the order builders and the relay chain
    "pixelsynth_tpu_torch.ops.orders", "pixelsynth_tpu_torch.ops.orders_device",
    "pixelsynth_tpu_torch.data.habitat", "pixelsynth_tpu_torch.data.loader",
    "pixelsynth_tpu_torch.train.loop", "pixelsynth_tpu_torch.tools.export_habitat_shards",
    "pixelsynth_tpu_torch.tools.train_scene_classifier",
    "pixelsynth_tpu_torch.tools.stitch_checkpoint", "pixelsynth_tpu_torch.tools.run_relay",
    # the profiling and tuning tools, the importer and the exporter (the
    # exporter's torchvision, pytorch_fid and lpips only inside functions)
    "pixelsynth_tpu_torch.utils.profiling", "pixelsynth_tpu_torch.tools.profile_view",
    "pixelsynth_tpu_torch.tools.profile_hotspots", "pixelsynth_tpu_torch.tools.profile_splat",
    "pixelsynth_tpu_torch.tools.tune_splat", "pixelsynth_tpu_torch.tools.sweep_speculative",
    "pixelsynth_tpu_torch.tools.scene_drift",
    "pixelsynth_tpu_torch.tools.import_reference_ckpt",
    "pixelsynth_tpu_torch.tools.export_torch_weights",
]


@pytest.mark.parametrize("name", EVAL_MODULES)
def test_eval_modules_import_without_jax_opencv_or_pil(name):
    import importlib

    module = importlib.import_module(name)
    with open(module.__file__) as f:
        tree = ast.parse(f.read(), module.__file__)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
    bad = [n for n in found if n.split(".")[0] in FORBIDDEN | {"cv2", "PIL"}]
    assert not bad, bad


@pytest.mark.parametrize("make", ["percsim", "lpips", "fid"])
def test_eval_networks_default_to_the_card(make):
    from pixelsynth_tpu_torch.eval.inception import make_fid_feature_fn
    from pixelsynth_tpu_torch.eval.metrics import LPIPS, PercSim

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        {"percsim": PercSim, "lpips": LPIPS, "fid": make_fid_feature_fn}[make]()


def test_encoder_pipeline_defaults_to_the_card():
    """With an encoder too (the build forward_angle and render_no_outpaint
    run on), the pipeline defaults to the card: without one it fails
    instead of falling back to the CPU."""
    from pixelsynth_tpu_torch.config import Config
    from pixelsynth_tpu_torch.pipeline import PixelSynth

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config()
    cfg.model.W, cfg.model.unet_num_filters, cfg.model.ngf, cfg.model.ndf = 32, 4, 8, 8
    cfg.model.vqvae.channel, cfg.model.vqvae.n_res_channel = 16, 8
    cfg.model.lmconv.nr_filters = 16
    cfg.model.use_rgb_features, cfg.model.predict_residual = False, False
    with pytest.raises((RuntimeError, AssertionError)):
        PixelSynth(cfg)


# the other datasets, the extract tools and data parallelism: none imports
# JAX or the JAX package; only the image decoder reaches for PIL, inside the
# function that decodes a file that is not a PNG
DATASET_PARALLEL_MODULES = [
    "pixelsynth_tpu_torch.data.realestate10k", "pixelsynth_tpu_torch.data.custom",
    "pixelsynth_tpu_torch.data.habitat_bridge", "pixelsynth_tpu_torch.data.demo_data",
    "pixelsynth_tpu_torch.tools.extract_vqvae_dataset",
    "pixelsynth_tpu_torch.tools.extract_code",
    "pixelsynth_tpu_torch.tools.extract_pixcnn_orders",
    "pixelsynth_tpu_torch.parallel.distributed", "pixelsynth_tpu_torch.parallel.mesh",
    "pixelsynth_tpu_torch.parallel.dryrun", "pixelsynth_tpu_torch.utils.devices",
]
PIL_INSIDE = {"pixelsynth_tpu_torch.data.realestate10k": "decode_image_u8"}


@pytest.mark.parametrize("name", DATASET_PARALLEL_MODULES)
def test_dataset_and_parallel_modules_import_without_jax(name):
    import importlib

    module = importlib.import_module(name)
    with open(module.__file__) as f:
        tree = ast.parse(f.read(), module.__file__)
    bad = []
    for fn in [None] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
        nodes = ast.walk(fn) if fn is not None else ast.iter_child_nodes(tree)
        for node in nodes:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            allowed = {"PIL"} if fn is not None and PIL_INSIDE.get(name) == fn.name else set()
            bad += [n for n in names
                    if n.split(".")[0] in (FORBIDDEN | {"cv2", "PIL"}) - allowed]
    assert not bad, bad
