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
  * with `trainable=True`, the stage-2 trainer's modules instead
    (pipeline.build_modules(trainable=True)): every collection of each
    tree carried as it is -- raw kernels (permuted), the spectral vectors
    `u`/`v` (`u_gain`/`v_gain`/`u_bias`/`v_bias` for NoiseBN), every
    `batch_stats` entry -- for unet, projector, vqvae, pixelcnn, disc and
    vgg, so that one step of the port computes what one JAX step computes;
  * the feature encoder's tree ("encoder", where use_rgb_features is
    False) and a refinement decoder of any input width, read from the
    tree's first kernel (3 or 64 features, plus 1 with the mask);
  * `from_jax_module` loads one Flax module's variables into a port module
    of the same names: the two-level VQ-VAE (models/vqvae.py `VQVAE`),
    the baselines (models/baselines.py) and any tree above;
  * `to_jax_params` is the inverse of the trainable bridge: the trainer's
    state dicts back to Flax trees of every collection (each module's
    `to_flax`, sorted by `split_collections`), which the stitched
    checkpoint stores (tools/stitch_checkpoint.py);
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


# the collection of each non-`params` leaf, as the JAX package files them
LEAF_COLLECTION = {
    **{n: "spectral_stats" for n in ("u", "v", "u_gain", "v_gain", "u_bias", "v_bias")},
    **{n: "batch_stats" for n in ("mean", "var", "stored_mean", "stored_var",
                                  "accumulation_counter")},
    **{n: "ema" for n in ("embed", "cluster_size", "embed_avg")},
}


def split_collections(merged: Dict) -> Dict:
    """The inverse of `merge_collections`: one module tree -> {"params":
    ..., "batch_stats": ..., "spectral_stats": ..., "ema": ...}, each leaf
    in the collection LEAF_COLLECTION names (else "params"); empty
    collections are left out."""
    out: Dict = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            tree = out.setdefault(LEAF_COLLECTION.get(k, "params"), {})
            for p in path:
                tree = tree.setdefault(p, {})
            tree[k] = v

    walk(merged, ())
    return out


def to_jax_params(state_dicts: Dict[str, Dict], cfg: Config) -> Dict[str, Dict]:
    """The inverse of `from_jax_params(..., trainable=True)`: {tree: the
    trainer's state dict} -> {tree: Flax variables of every collection}
    in the key layout `load_stitched_npz` (this module's and the JAX
    package's) reads.  Conv kernels OIHW -> HWIO, the ConvTranspose flip
    undone, Linear -> Dense, the raw spectral kernels with their `u` / `v`
    (the trainer's build; a serving build's folded weights cannot be
    inverted).  Trees: those of the stage-2 trainer (unet, projector,
    vqvae, disc, vgg, pixelcnn) and "classifier" (a ResNet18 of the state
    dict's class count)."""
    import torch

    from pixelsynth_tpu_torch.models.classifier import ResNet18
    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn

    proj_in = None
    if "projector" in state_dicts:
        proj_in = int(state_dicts["projector"]["ResNetBlock_0.SNConv_0.weight"].shape[1])
    modules = build_modules(cfg, trainable=True, projector_in=proj_in)
    modules["pixelcnn"] = build_pixelcnn(cfg, trainable=True)
    if "classifier" in state_dicts:
        modules["classifier"] = ResNet18(
            int(state_dicts["classifier"]["Dense_0.weight"].shape[0]))
    out = {}
    with torch.no_grad():
        for name, sd in state_dicts.items():
            module = modules[name]
            module.load_state_dict(sd)
            out[name] = split_collections(module.to_flax())
    return out


def from_jax_params(variables: Dict, cfg: Config, *,
                    trainable: bool = False) -> Dict[str, Dict]:
    """Flax variable trees -> {tree name: torch state dict} for every tree
    the view step uses (unet, projector, vqvae, disc, classifier,
    pixelcnn, and the encoder where use_rgb_features is False), or with
    `trainable` every tree of the stage-2 trainer (unet, projector, vqvae,
    disc, vgg, pixelcnn).  The projector is built at the input width of
    its tree's first kernel."""
    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn

    proj_in = None
    if "projector" in variables:
        first = variables["projector"]["params"]["ResNetBlock_0"]["SNConv_0"]["kernel"]
        proj_in = int(np.shape(first)[2])
    modules = build_modules(cfg, classifier_vars=variables.get("classifier"),
                            trainable=trainable, projector_in=proj_in)
    modules["pixelcnn"] = build_pixelcnn(cfg, trainable=trainable)
    return {name: from_jax_module(module, variables[name])
            for name, module in modules.items() if name in variables}


def from_jax_module(module, variables: Dict) -> Dict:
    """One Flax module's variables ({"params": ..., "batch_stats": ...,
    ...}) loaded into `module`, a port module whose children carry the Flax
    names -> its state dict."""
    import torch

    with torch.no_grad():
        module.load_flax(merge_collections(variables))
    return module.state_dict()


def eval_net_state_dict(net: str, variables: Dict) -> Dict:
    """The JAX package's eval-net variables (Flax `params` and
    `batch_stats` trees, numpy) -> the port's state dict of that net:
    net "vgg16" | "alex" | "squeeze" (eval/metrics.py, the Flax modules'
    `Conv_<i>` / `conv0` / `fire<i>` names onto torchvision's indices) or
    "inception" (eval/inception.py, the same names; BatchNorm scale ->
    weight, mean / var -> running_mean / running_var)."""
    import torch

    from pixelsynth_tpu_torch.eval.inception import InceptionV3Features
    from pixelsynth_tpu_torch.eval.metrics import PNET_NETS

    module = InceptionV3Features() if net == "inception" else PNET_NETS[net]()
    convs = [n for n, m in module.named_modules() if isinstance(m, torch.nn.Conv2d)]

    def name(path: str) -> str:
        if net in ("vgg16", "alex"):
            return convs[int(path.split("_")[-1])]
        if net == "squeeze":
            return "0" if path == "conv0" else path.replace("fire", "").replace("/", ".")
        return path.replace("/", ".")

    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
    sd = {}
    for col in ("params", "batch_stats"):
        for key, v in flatten_tree(variables.get(col, {})).items():
            path, leaf = key.rsplit("/", 1)
            v = np.asarray(v, np.float32)
            if leaf == "kernel":
                v = v.transpose(3, 2, 0, 1)
            sd[f"{name(path)}.{leaf_names[leaf]}"] = torch.tensor(v)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros_like(v)
    missing = set(module.state_dict()) ^ set(sd)
    if missing:
        raise KeyError(f"{net}: the variables and the module differ at {sorted(missing)[:5]}")
    return sd


def serving_state_dicts(trained: Dict, cfg: Config) -> Dict[str, Dict]:
    """The stage-2 trainer's modules ({tree: module}, built with
    `trainable=True` and loaded) -> the serving build's state dicts of the
    view step's trees (unet, projector, vqvae, disc, pixelcnn): each
    spectral weight divided by |mat^T v| with its stored v, which is what
    the trainable build computes in eval mode; the entries only the trainer
    keeps (the spectral vectors, StandingStatsBN's accumulation counter)
    left out.  A module kept under two names (the U-Net's `final` is also
    `SNConv_<n>`) is in the state dict twice and folded under both."""
    import torch

    from pixelsynth_tpu_torch.models.layers import Conv, NoiseBN
    from pixelsynth_tpu_torch.pipeline import build_modules, build_pixelcnn

    serving = build_modules(cfg)
    serving.pop("classifier")
    serving["pixelcnn"] = build_pixelcnn(cfg)
    out: Dict[str, Dict] = {}
    with torch.no_grad():
        for name, module in serving.items():
            t = trained[name]
            sd = dict(t.state_dict())
            for mname, m in t.named_modules(remove_duplicate=False):
                pre = f"{mname}." if mname else ""
                if isinstance(m, Conv) and m.sn_state:
                    sd[pre + "weight"] = m.weight / torch.linalg.vector_norm(
                        m._mat(m.weight).T @ m.v)
                elif isinstance(m, NoiseBN) and m.sn_state:
                    sd[pre + "wg"] = m.wg / torch.linalg.vector_norm(m.wg.T @ m.v_gain)
                    sd[pre + "wb"] = m.wb / torch.linalg.vector_norm(m.wb.T @ m.v_bias)
            out[name] = {k: sd[k].detach().cpu() for k in module.state_dict()}
    return out
