"""Checkpoint reader and the Flax -> PyTorch weight bridge.

`load_stitched_npz` reads the single-file stitched checkpoint
(`evidence/relay/stitched.npz`, written by
pixelsynth_tpu/tools/stitch_checkpoint.py:58-88) with numpy alone: flat
`tree/a/b/c` keys, fp16 values widened to f32, plus a JSON `__config__`.

`from_jax_params` maps the Flax variable trees of every network the view
step uses onto the port's modules and returns their state dicts:
  * conv kernels HWIO -> OIHW; ConvTranspose kernels flipped to
    conv_transpose2d's (in, out, kh, kw);
  * Dense (in, out) -> Linear (out, in);
  * spectral norm folded into the weight: eval divides by
    sigma = |mat^T v| with the stored v (pixelsynth_tpu/models/layers.py
    :40-79), computed once here;
  * BatchNorm mean/var/scale/bias, StandingStatsBN buffers, NoiseBN
    gain_kernel/bias_kernel;
  * the PixelCNN tree loads into the `LMPixelCNN` module by name
    (`LMConv_i/{weight,bias,mask_weight}`, `GatedResnet_i/LMConv_{0,1}`,
    `GatedResnet_i/Nin_0/Dense_0`, `Nin_0/Dense_0`); lmconv taps keep their
    (k^2, Cin, Cout) layout.  That one module feeds all three engines: the
    module path itself, and through `models.lmconv.flax_named_params` the
    fused forward's packing (K1) and the per-layer kernel engine.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from pixelsynth_tpu_torch.config import Config

COLLECTIONS = ("params", "batch_stats", "spectral_stats", "ema")


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    root: Dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = np.asarray(tree)
    return out


def load_stitched_npz(path: str) -> Tuple[Config, Dict, Dict]:
    """-> (cfg, variables (float32 numpy trees), meta)."""
    with np.load(path) as data:
        cfg = Config.from_json(bytes(data["__config__"]).decode())
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data.files else {})
        flat = {}
        for k in data.files:
            if k.startswith("__"):
                continue
            v = data[k]
            flat[k] = v.astype(np.float32) if v.dtype == np.float16 else v
    return cfg, unflatten_tree(flat), meta


def merge_collections(variables: Dict) -> Dict:
    """{"params": {...}, "batch_stats": {...}, ...} -> one module tree
    whose leaves from every collection sit side by side (their names never
    collide: kernel/bias/scale vs mean/var vs u/v vs embed)."""
    merged: Dict = {}

    def put(node, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(node.setdefault(k, {}), v)
            else:
                if k in node:
                    raise ValueError(f"leaf {k!r} appears in two collections")
                node[k] = np.asarray(v)

    for col in COLLECTIONS:
        if col in variables:
            put(merged, variables[col])
    return merged


def from_jax_params(variables: Dict, cfg: Config) -> Dict[str, Dict]:
    """Flax variable trees -> {tree name: torch state dict} for every tree
    the view step uses (unet, projector, vqvae, disc, classifier,
    pixelcnn)."""
    import torch

    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn

    modules = build_modules(cfg, classifier_vars=variables.get("classifier"))
    modules["pixelcnn"] = build_pixelcnn(cfg)
    out: Dict[str, Dict] = {}
    with torch.no_grad():
        for name, module in modules.items():
            if name in variables:
                module.load_flax(merge_collections(variables[name]))
                out[name] = module.state_dict()
    return out
