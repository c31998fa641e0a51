"""Load the reference's PyTorch checkpoints into the port's modules (port of
pixelsynth_tpu/tools/import_reference_ckpt.py).

The reference stitches its inference model from three checkpoints (its
demo.py:198-245):
  * ``pixelsynth.pth["state_dict"]``      -- BaseModel(DataParallel(ZbufferModelPts))
  * ``vqvae.pth``                         -- VQVAETop state_dict ("module."-prefixed)
  * ``autoregressive.pth["model_state_dict"]`` -- OurPixelCNN (lmconv)

Each converter maps a reference state dict straight onto a port module
(an `nn.Module` of models/, serving or trainable build) and returns that
module's full state dict, for `PixelSynth(cfg, state_dicts=...)` or
`module.load_state_dict`.  The reference and the port are both PyTorch, so
most tensors keep their layout: Conv2d OIHW, ConvTranspose2d (I, O, kh,
kw) and Linear (O, I) weights are the port's as they are.  What changes:
  * weight_norm (``weight_g``/``weight_v``) -> the dense weight
    g * v / ||v||; locally masked conv weights (O, I, kh, kw) -> the
    port's taps-major (k*k, I, O); ``mask_weight`` (O, k*k) -> (k*k, O);
  * spectral_norm (``weight_orig``/``weight_u``/``weight_v``): a trainable
    layer keeps the raw weight, u, and v permuted from the reference's
    (I, kh, kw) flattening into the port's (kh, kw, I) one (the JAX
    package's `_conv_v_perm`); a serving layer is divided by
    sigma = |mat^T v| with that v and mat the weight flattened (kh*kw*I,
    O), which is what the trainable layer computes in eval
    (models/layers.py `spectral_divide`) and what `weights.from_jax_params`
    folds;
  * the noise BatchNorm's gain / bias Linear -> the port's (20, C) `wg` /
    `wb` (the transposed weight), with their spectral vectors as above;
  * BatchNorm weight / bias / running stats -> scale / shift / mean / var.

Every entry written is checked against the freshly built port module: its
key must exist and its shape match, and every reference key a converter
reads must be present, so a structural mismatch fails loudly (KeyError or
ValueError) instead of mis-assigning.  Entries the checkpoint does not
cover keep the module's values.  The JAX package's converters give the
same state dicts through its Flax trees and `weights.from_jax_params`
(tests/test_torch_import_reference.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# a plan: (kind, reference module name, port module path) per layer
Plan = List[Tuple[str, str, str]]


# ---------------------------------------------------------------------------
# tensor-level helpers
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def resolve_weight_norm(sd: Mapping, prefix: str) -> np.ndarray:
    """Fold torch weight_norm: W = g * v / ||v|| (norm over dims != 0).

    Falls back to the plain ``weight`` when the layer was built without
    weight_norm -- PixelSynth instantiates OurPixelCNN with
    weight_norm=False (z_buffermodel.py:63-74), so its conv weights are
    stored plain while nin_out keeps weight_norm (model.py:99-108)."""
    if f"{prefix}.weight_g" not in sd:
        return _np(sd[f"{prefix}.weight"])
    g = _np(sd[f"{prefix}.weight_g"])
    v = _np(sd[f"{prefix}.weight_v"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v ** 2, axis=axes, keepdims=True))
    return g * v / norm


def lmconv_weight(w) -> np.ndarray:
    """locally_masked_conv2d weight (O, I, kh, kw) -> the port's (k*k, I, O),
    taps row-major (dy, dx) on both sides."""
    w = _np(w)
    O, I, kh, kw = w.shape
    return w.transpose(2, 3, 1, 0).reshape(kh * kw, I, O)


def conv_v_perm(v, oihw_shape) -> np.ndarray:
    """The reference's spectral v lives in the (I, kh, kw)-flattened input
    space; the port's Conv flattens (kh, kw, I)."""
    O, I, kh, kw = oihw_shape
    return _np(v).reshape(I, kh, kw).transpose(1, 2, 0).reshape(-1).copy()


def strip_prefix(sd: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class _Put:
    """Shape-checked assignment into a copy of a port module's state dict.
    A tensor the module holds under two names (the U-Net's `final` is
    also its last `SNConv_<n>`) is written under both."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        held = module.state_dict(keep_vars=True)
        self.sd = {k: v.detach().cpu().clone() for k, v in held.items()}
        by_id: Dict[int, List[str]] = {}
        for k, v in held.items():
            by_id.setdefault(id(v), []).append(k)
        self.names = {k: by_id[id(v)] for k, v in held.items()}

    def sub(self, path: str) -> torch.nn.Module:
        return self.module.get_submodule(path)

    def __call__(self, key: str, value) -> None:
        if key not in self.sd:
            raise KeyError(f"{key}: no such entry in the port's {type(self.module).__name__}")
        old = self.sd[key]
        if not torch.is_tensor(value):
            value = torch.as_tensor(np.ascontiguousarray(_np(value)))
        value = value.detach().cpu()
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: port {tuple(old.shape)} "
                             f"vs reference {tuple(value.shape)}")
        for name in self.names[key]:
            self.sd[name] = value.to(old.dtype).clone()


# ---------------------------------------------------------------------------
# layer converters: (put, reference state dict, reference name, port path)
# ---------------------------------------------------------------------------


def _bias(put: _Put, sd: Mapping, tname: str, mpath: str) -> None:
    if f"{tname}.bias" in sd:
        put(f"{mpath}.bias", sd[f"{tname}.bias"])


def _conv(put, sd, tname, mpath):
    """Conv2d or ConvTranspose2d without a parameterisation: the weight as
    it is (OIHW, or (I, O, kh, kw) for a transposed conv)."""
    put(f"{mpath}.weight", sd[f"{tname}.weight"])
    _bias(put, sd, tname, mpath)


def _sn_conv(put, sd, tname, mpath):
    """spectral_norm Conv2d -> a port Conv: trainable keeps weight_orig, u
    and the permuted v; serving divides by |mat^T v|."""
    m = put.sub(mpath)
    if f"{tname}.weight_orig" in sd:
        w = torch.as_tensor(_np(sd[f"{tname}.weight_orig"]))
        v = torch.as_tensor(conv_v_perm(sd[f"{tname}.weight_v"], tuple(w.shape)))
        if m.sn_state:
            put(f"{mpath}.weight", w)
            put(f"{mpath}.u", sd[f"{tname}.weight_u"])
            put(f"{mpath}.v", v)
        elif m.spectral:
            # HWIO, built as weights.from_jax_params builds it from a Flax
            # kernel, so that sigma rounds the same (the product's order
            # follows the strides)
            k = torch.tensor(_np(w).transpose(2, 3, 1, 0))
            mat = k.reshape(-1, k.shape[-1])
            k = k / torch.linalg.vector_norm(mat.T @ v)
            put(f"{mpath}.weight", k.permute(3, 2, 0, 1))
        else:
            raise ValueError(f"{tname} is spectral-normed in the checkpoint, the "
                             f"port's {mpath} is not")
    else:
        if m.spectral:
            raise ValueError(f"{tname} has no spectral norm in the checkpoint, the "
                             f"port's {mpath} has")
        put(f"{mpath}.weight", sd[f"{tname}.weight"])
    _bias(put, sd, tname, mpath)


def _bn(put, sd, tname, mpath):
    """BatchNorm2d -> the port's BatchNorm inside a SyncBatchNorm."""
    put(f"{mpath}.BatchNorm_0.scale", sd[f"{tname}.weight"])
    put(f"{mpath}.BatchNorm_0.shift", sd[f"{tname}.bias"])
    put(f"{mpath}.BatchNorm_0.mean", sd[f"{tname}.running_mean"])
    put(f"{mpath}.BatchNorm_0.var", sd[f"{tname}.running_var"])


def _noise_bn(put, sd, tname, mpath):
    """LinearNoiseLayer (normalization.py:21-47) -> NoiseBN: the gain and
    bias Linears (20 -> C) as (20, C) kernels, the BN's stored stats."""
    m = put.sub(mpath)
    for kind, attr in (("gain", "wg"), ("bias", "wb")):
        lin = f"{tname}.{kind}"
        if f"{lin}.weight_orig" in sd:
            w = torch.as_tensor(_np(sd[f"{lin}.weight_orig"]).T.copy())
            v = torch.as_tensor(_np(sd[f"{lin}.weight_v"]))
            if m.sn_state:
                put(f"{mpath}.{attr}", w)
                put(f"{mpath}.u_{kind}", sd[f"{lin}.weight_u"])
                put(f"{mpath}.v_{kind}", v)
            elif m.spectral:
                put(f"{mpath}.{attr}", w / torch.linalg.vector_norm(w.T @ v))
            else:
                raise ValueError(f"{lin} is spectral-normed in the checkpoint, the "
                                 f"port's {mpath} is not")
        else:
            if m.spectral:
                raise ValueError(f"{lin} has no spectral norm in the checkpoint, the "
                                 f"port's {mpath} has")
            put(f"{mpath}.{attr}", _np(sd[f"{lin}.weight"]).T.copy())
    put(f"{mpath}.BatchNorm_0.mean", sd[f"{tname}.bn.stored_mean"])
    put(f"{mpath}.BatchNorm_0.var", sd[f"{tname}.bn.stored_var"])


def _quantize(put, sd, tname, mpath):
    for name in ("embed", "cluster_size", "embed_avg"):
        put(f"{mpath}.{name}", sd[f"{tname}.{name}"])


def _lmconv(put, sd, tname, mpath):
    """A (weight-normed or plain) locally masked conv -> the port's LMConv."""
    put(f"{mpath}.weight", lmconv_weight(resolve_weight_norm(sd, tname)))
    _bias(put, sd, tname, mpath)
    if f"{tname}.mask_weight" in sd:
        put(f"{mpath}.mask_weight", _np(sd[f"{tname}.mask_weight"]).T.copy())


def _nin(put, sd, tname, mpath):
    """nin (lin_a, weight-normed Linear) -> the port's Nin."""
    put(f"{mpath}.Dense_0.weight", resolve_weight_norm(sd, f"{tname}.lin_a"))
    put(f"{mpath}.Dense_0.bias", sd[f"{tname}.lin_a.bias"])


LAYERS = {"conv": _conv, "sn_conv": _sn_conv, "bn": _bn, "noise_bn": _noise_bn,
          "quantize": _quantize, "lmconv": _lmconv, "nin": _nin}


def apply_plan(plan: Plan, sd: Mapping, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every layer of `plan` from the reference state dict `sd` into a copy
    of `module`'s state dict, which is returned (CPU tensors)."""
    put = _Put(module)
    for kind, tname, mpath in plan:
        LAYERS[kind](put, sd, tname, mpath)
    return put.sd


# ---------------------------------------------------------------------------
# plans and converters, one a model
# ---------------------------------------------------------------------------


def plan_vqvae(n_res_block: int = 2) -> Plan:
    """VQVAETop / VQVAE (models/vqvae2/vqvae.py:164-312): both levels'
    encoders, quantizers and decoders (the two-level model carries the same
    modules; its decoder reads both levels' codes)."""
    plan: Plan = []

    def encoder(mod, stride):
        # blocks: stride4 = [C,R,C,R,C] + res; stride2 = [C,R,C] + res
        conv_idx = [0, 2, 4] if stride == 4 else [0, 2]
        for j, ci in enumerate(conv_idx):
            plan.append(("conv", f"{mod}.blocks.{ci}", f"{mod}.Conv_{j}"))
        res0 = conv_idx[-1] + 1
        for r in range(n_res_block):
            base = f"{mod}.blocks.{res0 + r}.conv"
            plan.append(("conv", f"{base}.1", f"{mod}.ResBlock_{r}.Conv_0"))
            plan.append(("conv", f"{base}.3", f"{mod}.ResBlock_{r}.Conv_1"))

    def decoder(mod, stride):
        # blocks: [C] + res + [R] + (stride4: [T,R,T] | stride2: [T])
        plan.append(("conv", f"{mod}.blocks.0", f"{mod}.Conv_0"))
        for r in range(n_res_block):
            base = f"{mod}.blocks.{1 + r}.conv"
            plan.append(("conv", f"{base}.1", f"{mod}.ResBlock_{r}.Conv_0"))
            plan.append(("conv", f"{base}.3", f"{mod}.ResBlock_{r}.Conv_1"))
        t0 = 1 + n_res_block + 1
        plan.append(("conv", f"{mod}.blocks.{t0}", f"{mod}.ConvTranspose_0"))
        if stride == 4:
            plan.append(("conv", f"{mod}.blocks.{t0 + 2}", f"{mod}.ConvTranspose_1"))

    encoder("enc_b", 4)
    encoder("enc_t", 2)
    plan.append(("conv", "quantize_conv_t", "quantize_conv_t"))
    plan.append(("quantize", "quantize_t", "quantize_t"))
    decoder("dec_t", 2)
    plan.append(("conv", "quantize_conv_b", "quantize_conv_b"))
    plan.append(("quantize", "quantize_b", "quantize_b"))
    plan.append(("conv", "upsample_t", "upsample_t"))
    decoder("dec", 4)
    return plan


def convert_vqvae(sd: Mapping, module, *, n_res_block: int = 2) -> Dict:
    """VQVAETop / VQVAE state_dict -> the state dict of the port's
    `VQVAETop` or two-level `VQVAE` (models/vqvae.py) `module`."""
    return apply_plan(plan_vqvae(n_res_block), sd, module)


def plan_lmconv(nr_resnet: int = 2) -> Plan:
    """OurPixelCNN (models/lmconv/model.py:61-155): the first conv, the up
    pass (3 x nr_resnet gated resnets with a downsizing conv between), the
    down pass ([nr, nr + 1, nr + 1] gated resnets with nin skips and an
    upsizing conv between), the output nin."""
    plan: Plan = [("lmconv", "u_init", "LMConv_0")]
    g = 0

    def gated(tmod, skip):
        nonlocal g
        fmod = f"GatedResnet_{g}"
        plan.append(("lmconv", f"{tmod}.conv_input", f"{fmod}.LMConv_0"))
        plan.append(("lmconv", f"{tmod}.conv_out", f"{fmod}.LMConv_1"))
        if skip:
            plan.append(("nin", f"{tmod}.nin_skip", f"{fmod}.Nin_0"))
        g += 1

    for i in range(3):
        for j in range(nr_resnet):
            gated(f"up_layers.{i}.u_stream.{j}", False)
        if i < 2:
            plan.append(("lmconv", f"downsize_u_stream.{i}", f"LMConv_{1 + i}"))
    down_nr = [nr_resnet, nr_resnet + 1, nr_resnet + 1]
    for i in range(3):
        for j in range(down_nr[i]):
            gated(f"down_layers.{i}.u_stream.{j}", True)
        if i < 2:
            plan.append(("lmconv", f"upsize_u_stream.{i}", f"LMConv_{3 + i}"))
    plan.append(("nin", "nin_out", "Nin_0"))
    return plan


def convert_lmconv(sd: Mapping, module, *, nr_resnet: int = 2) -> Dict:
    """OurPixelCNN state_dict -> the state dict of the port's `LMPixelCNN`."""
    return apply_plan(plan_lmconv(nr_resnet), sd, module)


def plan_unet(levels: int = 8) -> Plan:
    """The reference Unet (architectures.py:174-279): conv1..convL ->
    SNConv_0..L-1, dconv1..dconvL -> SNConv_L..2L-1, and the batch norms
    in the order the port's U-Net creates them."""
    L = levels
    plan: Plan = [("sn_conv", f"conv{i + 1}", f"SNConv_{i}") for i in range(L)]
    plan += [("sn_conv", f"dconv{i + 1}", f"SNConv_{L + i}") for i in range(L)]
    enc_norms = ["batch_norm2_0", "batch_norm4_0"] + [
        f"batch_norm8_{i}" for i in range(L - 4)]
    dec_norms = [f"batch_norm8_{L - 4 + i}" for i in range(L - 4)] + [
        "batch_norm4_1", "batch_norm2_1", "batch_norm"]
    plan += [("bn", t, f"SyncBatchNorm_{j}") for j, t in enumerate(enc_norms + dec_norms)]
    return plan


def convert_unet(sd: Mapping, module, *, levels: Optional[int] = None) -> Dict:
    """Reference Unet state_dict (spectral-normed convs + BatchNorm) -> the
    state dict of the port's `UNet` (levels: the module's)."""
    return apply_plan(plan_unet(levels or module.levels), sd, module)


def plan_resnet_blocks(module, tprefix: str) -> Plan:
    """ResNet_Block (models/layers/blocks.py:33-73) a ResNetBlock_i child
    of `module`: ch_a = [bn_noise1, ReLU, conv_aa, bn_noise2, ReLU, conv_ab,
    resample]; ch_b = [conv_b, resample] where the port's block has the
    shortcut conv."""
    plan: Plan = []
    blocks = [n for n, _ in module.named_children() if n.startswith("ResNetBlock_")]
    for i in range(len(blocks)):
        t, f = f"{tprefix}.{i}", f"ResNetBlock_{i}"
        plan += [("noise_bn", f"{t}.ch_a.0", f"{f}.NoiseBN_0"),
                 ("sn_conv", f"{t}.ch_a.2", f"{f}.SNConv_0"),
                 ("noise_bn", f"{t}.ch_a.3", f"{f}.NoiseBN_1"),
                 ("sn_conv", f"{t}.ch_a.5", f"{f}.SNConv_1")]
        if hasattr(getattr(module, f), "SNConv_2"):
            plan.append(("sn_conv", f"{t}.ch_b.0", f"{f}.SNConv_2"))
    return plan


def convert_resnet_encoder(sd: Mapping, module) -> Dict:
    """ResNetEncoder (architectures.py:91-123): gblocks.<i>."""
    return apply_plan(plan_resnet_blocks(module, "gblocks"), sd, module)


def convert_resnet_decoder(sd: Mapping, module) -> Dict:
    """ResNetDecoder (architectures.py:126-167): eblocks.<i>."""
    return apply_plan(plan_resnet_blocks(module, "eblocks"), sd, module)


def plan_discriminator(num_D: int = 2, n_layers: int = 4) -> Plan:
    """MultiscaleDiscriminator (discriminators.py:78-215):
    discriminator_<i>.model<n>.0; the middle layers sit inside the
    norm_layer Sequential (spectral conv at .0, InstanceNorm at .1)."""
    plan: Plan = []
    for d in range(num_D):
        for n in range(n_layers + 1):
            mid = 1 <= n <= n_layers - 1
            t = f"discriminator_{d}.model{n}.0" + (".0" if mid else "")
            plan.append(("sn_conv", t, f"NLayerDiscriminator_{d}.SNConv_{n}"))
    return plan


def convert_discriminator(sd: Mapping, module, *, num_D: int = 2,
                          n_layers: int = 4) -> Dict:
    return apply_plan(plan_discriminator(num_D, n_layers), sd, module)


# ---------------------------------------------------------------------------
# top-level stitching (demo.py:198-245)
# ---------------------------------------------------------------------------


def _normalize_zbuffer_sd(sd: Mapping) -> Dict:
    """Strip the BaseModel/DataParallel wrappers: keys arrive as
    ``model.module.<submodule>...`` (demo.py:203-210)."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.module.", "module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def import_pixelsynth(state_dict: Mapping, ps) -> Dict[str, Dict]:
    """pixelsynth.pth['state_dict'] onto the modules of `ps` (a
    pipeline.PixelSynth) -> {tree: state dict} for every submodule the
    checkpoint holds: pts_regressor -> "unet", encoder -> "encoder",
    projector -> "projector", vqvae, outpaint2 -> "pixelcnn", netD ->
    "disc" (z_buffermodel.py module attributes)."""
    sd = _normalize_zbuffer_sd(state_dict)
    mc = ps.cfg.model
    out: Dict[str, Dict] = {}
    sub = strip_prefix(sd, "pts_regressor.")
    if sub:
        out["unet"] = convert_unet(sub, ps.unet)
    sub = strip_prefix(sd, "encoder.")
    if sub and getattr(ps, "encoder", None) is not None:
        out["encoder"] = convert_resnet_encoder(sub, ps.encoder)
    sub = strip_prefix(sd, "projector.")
    if sub:
        out["projector"] = convert_resnet_decoder(sub, ps.projector)
    sub = strip_prefix(sd, "vqvae.")
    if sub:
        out["vqvae"] = convert_vqvae(sub, ps.vqvae)
    sub = strip_prefix(sd, "outpaint2.")
    if sub:
        out["pixelcnn"] = convert_lmconv(sub, ps.pixelcnn, nr_resnet=mc.lmconv.nr_resnet)
    sub = strip_prefix(sd, "netD.")
    if sub and getattr(ps, "disc", None) is not None:
        out["disc"] = convert_discriminator(sub, ps.disc)
    return out


def _load(path: str) -> Mapping:
    return torch.load(path, map_location="cpu", weights_only=True)


def import_from_files(ps, *, pixelsynth_path: Optional[str] = None,
                      vqvae_path: Optional[str] = None,
                      autoregressive_path: Optional[str] = None) -> Dict[str, Dict]:
    """Load and stitch the three reference checkpoint files (demo.py:198-231)
    onto the modules of `ps` -> {tree: state dict}; a later file's tree
    replaces an earlier one's.  Serve them with
    `PixelSynth(ps.cfg, state_dicts=...)`."""
    out: Dict[str, Dict] = {}
    if pixelsynth_path:
        ckpt = _load(pixelsynth_path)
        out.update(import_pixelsynth(ckpt.get("state_dict", ckpt), ps))
    if vqvae_path:
        sd = _load(vqvae_path)
        sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
        out["vqvae"] = convert_vqvae(sd, ps.vqvae)
    if autoregressive_path:
        ckpt = _load(autoregressive_path)
        out["pixelcnn"] = convert_lmconv(ckpt.get("model_state_dict", ckpt), ps.pixelcnn,
                                         nr_resnet=ps.cfg.model.lmconv.nr_resnet)
    return out
