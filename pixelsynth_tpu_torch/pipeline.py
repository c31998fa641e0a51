"""The PixelSynth pipeline on PyTorch (port of pixelsynth_tpu/pipeline.py):
the inference stages (:285-481) and the stage-2 training forward
(`train_forward`, :485-588).

  depth U-Net -> reprojection -> soft z-buffer splat (K2; binning by
  `splat.binning` / `splat.sort_backend`, K5) -> background mask ->
  generation order (host heap) + kernel masks -> VQ encode -> AR fill
  (`lmconv.sample_backend`: "fused" = speculative through K1, "pallas" =
  the module path through K3, "xla" = the module path through the plain
  masked conv) -> VQ decode -> refinement decoder

Cumulative scenes carry a fixed-capacity, validity-masked point cloud
(`CloudState`); appends compact it with a stable sort.  Entry points run
on `cuda` unless the caller passes device="cpu".

Point features are the image itself (`use_rgb_features`, the default) or
the 64 channels of the `ResNetEncoder`, which the splat (K2 at any
feature width) carries into a refinement decoder built at that width.
`forward_angle` renders a list of output extrinsics from one image without
outpainting.  With an encoder the port computes what the JAX package can:
the composition features -> splat_view -> decode_image
(`render_no_outpaint`, `forward_angle`); it refuses what the JAX package
cannot compute (`refuse_what_jax_cannot`).

`PixelSynth(cfg, trainable=True)` builds the stage-2 trainer's networks
instead of the view step's: the depth U-Net, the refinement decoder, the
PixelCNN (on `lmconv.train_backend`) and the discriminator with trainable
raw weights and their batch / spectral statistics as buffers, beside the
frozen VQ-VAE and a VGG19 for the perceptual loss.  `train_forward` runs
the splat under a gradient (K2's forward, a plain backward) and, with
`train_backend="pallas"`, every masked conv of the PixelCNN through K3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.geometry.projection import (
    homogeneous_to_pixels, lift_to_cloud, to44,
)
from pixelsynth_tpu_torch.models.classifier import ResNet18
from pixelsynth_tpu_torch.models.discriminators import MultiscaleDiscriminator
from pixelsynth_tpu_torch.models.encoderdecoder import (
    FEATURE_DIM, ResNetDecoder, ResNetEncoder,
)
from pixelsynth_tpu_torch.models.layers import collections
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN, flax_named_params
from pixelsynth_tpu_torch.models.losses import VGG19Features, synthesis_loss
from pixelsynth_tpu_torch.models.unet import UNet
from pixelsynth_tpu_torch.models.vqvae import VQVAETop
from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
from pixelsynth_tpu_torch.ops.lmconv_fused import (
    make_fused_logits_fn, pack_lmconv_params,
)
from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
from pixelsynth_tpu_torch.ops.orders_device import orders_and_masks_device
from pixelsynth_tpu_torch.ops.splat import splat
from pixelsynth_tpu_torch.weights import unflatten_tree


@dataclasses.dataclass
class CloudState:
    """Fixed-capacity homogeneous point cloud carried across scene views:
    pts (B, C_max, 4) in the K-projected frame of the last rendered view,
    feats (B, C_max, F), valid (B, C_max) bool."""

    pts: torch.Tensor
    feats: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(B: int, capacity: int, feat_dim: int, device=None) -> "CloudState":
        return CloudState(torch.zeros((B, capacity, 4), device=device),
                          torch.zeros((B, capacity, feat_dim), device=device),
                          torch.zeros((B, capacity), dtype=torch.bool,
                                      device=device))

    def transform(self, K, RT_cam2, RTinv_cam3) -> "CloudState":
        """pts' = K @ RT2 @ RTinv3 @ pts (exact for the identity model-facing
        K every dataset here uses; z_buffer_manipulator.py:244-247)."""
        M = to44(K) @ (to44(RT_cam2) @ to44(RTinv_cam3))
        return CloudState(torch.einsum("bij,bnj->bni", M, self.pts),
                          self.feats, self.valid)

    def append_compact(self, new_pts, new_feats, new_valid) -> "CloudState":
        """Append, then stable-compact valid entries to the front; overflow
        drops the newest tail."""
        pts = torch.cat([self.pts, new_pts], 1)
        feats = torch.cat([self.feats, new_feats], 1)
        valid = torch.cat([self.valid, new_valid], 1)
        cap = self.pts.shape[1]
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :cap]
        return CloudState(
            torch.gather(pts, 1, order[..., None].expand(-1, -1, pts.shape[-1])),
            torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1])),
            torch.gather(valid, 1, order))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all positions (pipeline.py:47-51, torch's
    CrossEntropyLoss): logits (..., classes), labels (...) int."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


def downsample_mask(mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W) -> avg-pooled by `factor` (z_buffermodel.py:87,646-647)."""
    return F.avg_pool2d(mask.float()[:, None], factor, factor)[:, 0]


def binarize_trunc(mask_ds: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> {0,1} by truncation: 1 only where the cell is
    entirely inside (z_buffermodel.py:668-669)."""
    return (mask_ds >= 1.0 - 1e-6).float()


def refuse_what_jax_cannot(cfg: Config, *, trainable: bool = False,
                           scene: bool = False) -> None:
    """Raise NotImplementedError, naming the field and the JAX package's
    line, for the configurations the JAX package cannot compute: the
    modifier U-Net (built, never initialised, feeding only the 64-channel
    combine), and with an encoder the trainer, the scene view step and the
    residual over 64-wide features."""
    mc = cfg.model
    if "modifier" in mc.depth_predictor_type:
        raise NotImplementedError(
            f"model.depth_predictor_type={mc.depth_predictor_type!r}: the modifier "
            "U-Net has no tree in the JAX package's init_variables "
            "(pixelsynth_tpu/pipeline.py:263-281) and feeds only train_forward's "
            "combine of 64 channels with a 3-channel decode (:525-532 -> :557)")
    if mc.use_rgb_features:
        return
    if trainable:
        raise NotImplementedError(
            "model.use_rgb_features=False with trainable=True: train_forward "
            "combines the encoder's 64-wide splat with the 3-channel VQ decode "
            "(pixelsynth_tpu/pipeline.py:557, combine at :478-481), which the JAX "
            "package cannot compute")
    if scene:
        raise NotImplementedError(
            "model.use_rgb_features=False in SceneGenerator: the JAX view step "
            "runs the encoder without rngs and combines its 64-wide splat with "
            "the 3-channel VQ decode (pixelsynth_tpu/scene.py:153,185,219)")
    if mc.predict_residual:
        raise NotImplementedError(
            "model.predict_residual=True with model.use_rgb_features=False: the "
            "decoder's residual adds the 64-wide features to its 3 channels "
            "(pixelsynth_tpu/models/encoderdecoder.py:107-110)")


def build_modules(cfg: Config, classifier_vars=None, *,
                  trainable: bool = False,
                  projector_in: Optional[int] = None) -> Dict[str, torch.nn.Module]:
    """The view step's networks, on the CPU, unloaded; with `trainable` the
    stage-2 trainer's instead (models/layers.py: raw weights with their
    spectral vectors; the frozen VQ-VAE and a VGG19 in place of the
    classifier).  With `use_rgb_features=False` also the "encoder".  The
    refinement decoder reads `projector_in` channels: by default the
    features' width plus the mask channel, which is what the JAX package's
    init builds (pipeline.py:263-270) at the features' width; loaded
    weights give their own (weights.from_jax_params)."""
    mc = cfg.model
    refuse_what_jax_cannot(cfg, trainable=trainable)
    if projector_in is None:
        projector_in = (3 if mc.use_rgb_features else FEATURE_DIM) + 1
    spectral = "spectral" in mc.norm_G
    levels = int(round(np.log2(mc.W)))
    if 2 ** levels != mc.W:
        raise ValueError("W must be a power of two")
    n_cls = 365
    if classifier_vars is not None:
        n_cls = int(np.asarray(classifier_vars["params"]["Dense_0"]["kernel"]).shape[-1])
    mods = {
        "unet": UNet(mc.unet_num_filters, 1, spectral, levels,
                     "batchstanding" if "batchstanding" in mc.norm_G else "batch",
                     trainable=trainable),
        "projector": ResNetDecoder(mc.refine_model_type, mc.ngf, spectral,
                                   mc.predict_residual,
                                   mc.normalize_before_residual,
                                   in_channels=projector_in,
                                   trainable=trainable),
        "vqvae": build_vqvae(cfg),
        "disc": MultiscaleDiscriminator(mc.ndf, trainable=trainable),
    }
    mods.update({"vgg": VGG19Features()} if trainable else
                {"classifier": ResNet18(n_cls)})
    if not mc.use_rgb_features:
        mods["encoder"] = ResNetEncoder(mc.refine_model_type, mc.ngf, spectral)
    return mods


def build_vqvae(cfg: Config) -> VQVAETop:
    """The VQ-VAE of `cfg.model.vqvae`, on the CPU, unloaded: the view
    step's encoder and decoder and the stage-1 trainer's model."""
    v = cfg.model.vqvae
    return VQVAETop(v.in_channel, v.channel, v.n_res_block, v.n_res_channel,
                    v.embed_dim, v.n_embed, v.decay, v.eps)


SAMPLE_BACKENDS = ("fused", "pallas", "xla")
MASKS_BACKENDS = ("jax", "host")


def masks_backend_is_host(l) -> bool:
    """`lmconv.masks_backend` (l an LMConvConfig): "host" -> True, "jax"
    -> False; any other value raises."""
    if l.masks_backend not in MASKS_BACKENDS:
        raise NotImplementedError(
            f"lmconv.masks_backend={l.masks_backend!r}: the port implements "
            f"{MASKS_BACKENDS}")
    return l.masks_backend == "host"


def build_pixelcnn(cfg: Config, *, trainable: bool = False) -> LMPixelCNN:
    """The PixelCNN module, on the CPU, unloaded.  The sampling side
    (`pixelcnn_fast`, pipeline.py:226-231): the masked-conv backend is
    `lmconv.sample_backend`, with "fused" keeping the kernel backend for
    the module (the fused forward itself is `make_sampling_logits_fn`'s).
    With `trainable` the training side (`pixelcnn`, :218-225, and the
    stage-3 trainer's model): the backend is `lmconv.train_backend` ("xla"
    the plain masked conv, "pallas" K3 under its differentiable entry),
    with `compute_dtype` only for "pallas", and the parameters require
    grad."""
    l = cfg.model.lmconv
    backend = l.train_backend if trainable else l.sample_backend
    backends = ("pallas", "xla") if trainable else SAMPLE_BACKENDS
    if backend not in backends:
        field = "train_backend" if trainable else "sample_backend"
        raise NotImplementedError(
            f"lmconv.{field}={backend!r}: the port implements {backends}")
    masks_backend_is_host(l)
    if trainable:
        dtype = l.compute_dtype if backend == "pallas" else None
    else:
        dtype = l.compute_dtype
        backend = "pallas" if backend == "fused" else backend
    model = LMPixelCNN(
        nr_resnet=l.nr_resnet, nr_filters=l.nr_filters,
        input_channels=l.input_channels, kernel_size=l.kernel_size,
        max_dilation=l.max_dilation, feature_norm=l.feature_norm,
        dropout_prob=l.dropout_prob, conv_bias=l.conv_bias,
        conv_mask_weight=l.conv_mask_weight, num_classes=l.num_classes,
        compute_dtype=dtype, backend=backend)
    model.requires_grad_(trainable)
    return model


def random_pixelcnn_params(cfg: Config, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Flax-named PixelCNN arrays from a seed: lmconv weights and biases
    ~ U(+-1/sqrt(fan_in)) (the reference's reset_parameters), nin
    ~ N(0, 1/fan_in) with zero bias."""
    l = cfg.model.lmconv
    Fc, NC, k2, nr = l.nr_filters, l.num_classes, l.kernel_size ** 2, l.nr_resnet
    out = {}

    def lm(name, cin, cout):
        bound = 1.0 / np.sqrt(cin * k2)
        out[f"{name}/weight"] = (torch.rand((k2, cin, cout), generator=gen) * 2 - 1) * bound
        out[f"{name}/bias"] = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
        if l.conv_mask_weight:
            out[f"{name}/mask_weight"] = (
                (torch.rand((k2, cout), generator=gen) * 2 - 1) / np.sqrt(k2))

    def dense(name, cin, cout):
        out[f"{name}/kernel"] = torch.randn((cin, cout), generator=gen) / np.sqrt(cin)
        out[f"{name}/bias"] = torch.zeros(cout)

    lm("LMConv_0", l.input_channels + 1, Fc)
    for i in range(6 * nr + 2):
        lm(f"GatedResnet_{i}/LMConv_0", 2 * Fc, Fc)
        lm(f"GatedResnet_{i}/LMConv_1", 2 * Fc, 2 * Fc)
        if i >= 3 * nr:
            dense(f"GatedResnet_{i}/Nin_0/Dense_0", 2 * Fc, Fc)
    for i in range(1, 5):
        lm(f"LMConv_{i}", Fc, Fc)
    dense("Nin_0/Dense_0", Fc, NC)
    return out


def sampling_logits_fn(l, pixelcnn: LMPixelCNN, packed: Optional[Dict], masks):
    """(codes, filled) -> logits closure for the AR population loop, by
    `l.sample_backend` (l an LMConvConfig; pipeline.py:425-467): "fused" is
    the fused forward (K1; `packed` from `pack_lmconv_params`, masks folded
    once, outside the loop), with `.at`; "pallas" and "xla" go through the
    per-layer module `pixelcnn` (K3, or the plain masked conv) and have no
    `.at`, so the sampler takes one cell per forward."""
    if l.sample_backend == "fused":
        if l.feature_norm != "pono" or l.conv_mask_weight:
            raise NotImplementedError(
                'lmconv.sample_backend="fused" computes feature_norm="pono" '
                "without conv_mask_weight only")
        return make_fused_logits_fn(
            packed, masks, nr_resnet=l.nr_resnet, max_dilation=l.max_dilation,
            num_classes=l.num_classes, compute_dtype=l.compute_dtype)
    # build_pixelcnn refused every other value than "pallas" and "xla"
    triple = (masks[:, 0], masks[:, 1], masks[:, 2])
    if l.sample_backend == "pallas" and masks.is_cuda:
        # lay the masks out for K3 once, not at each of its launches
        triple = (triple[0], prepare_mask(triple[1]), prepare_mask(triple[2]))

    @torch.no_grad()
    def fn(codes, filled):
        return pixelcnn(None, *triple, codes=codes, filled=filled)

    return fn


class PixelSynth:
    """The networks of the view step plus its stages, or (`trainable`) the
    stage-2 trainer's networks plus the training forward.

    state_dicts: {tree: state dict} from weights.from_jax_params (trained
    weights, made with the same `trainable`); every other tree is
    initialized from `seed`.  with_classifier: build the re-ranking
    classifier (always when its state dict is given; never when
    trainable)."""

    def __init__(self, cfg: Config, *, device="cuda", seed: int = 0,
                 state_dicts: Optional[Dict[str, Dict]] = None,
                 with_classifier: Optional[bool] = None,
                 trainable: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.W = cfg.model.W
        self.trainable = trainable
        state_dicts = state_dicts or {}
        proj_in = None
        if "projector" in state_dicts:
            proj_in = state_dicts["projector"]["ResNetBlock_0.SNConv_0.weight"].shape[1]
        mods = build_modules(cfg, trainable=trainable, projector_in=proj_in)
        if not trainable:
            if "classifier" in state_dicts:
                n_cls = state_dicts["classifier"]["Dense_0.weight"].shape[0]
                mods["classifier"] = ResNet18(n_cls)
            if with_classifier is None:
                with_classifier = "classifier" in state_dicts
            if not with_classifier:
                mods.pop("classifier")
        # one PixelCNN parameter set for the three engines: the module
        # (sample_backend "pallas" / "xla"), K1's packing ("fused") and the
        # per-layer kernel engine (models/lmconv_fast.py)
        mods["pixelcnn"] = build_pixelcnn(cfg, trainable=trainable)
        self.trees = list(mods)
        self.classifier = self.encoder = None
        for name, m in mods.items():
            setattr(self, name, m)
        self.init_variables(torch.Generator().manual_seed(seed), state_dicts)
        for name in self.trees:
            setattr(self, name, getattr(self, name).to(self.device).eval())
        if not trainable:
            l = cfg.model.lmconv
            self.pixelcnn_params = flax_named_params(self.pixelcnn)
            self.packed = pack_lmconv_params(self.pixelcnn_params,
                                             nr_resnet=l.nr_resnet,
                                             compute_dtype=l.compute_dtype,
                                             device=self.device)

    @torch.no_grad()
    def init_variables(self, gen: torch.Generator,
                       state_dicts: Optional[Dict[str, Dict]] = None) -> None:
        """Every tree (unet, projector, vqvae, disc, then the classifier or
        the VGG19, then the encoder where there is one, then the PixelCNN)
        from its state dict where one is given, else initialized from
        `gen`, in that order."""
        state_dicts = state_dicts or {}
        for name in self.trees:
            m = getattr(self, name)
            if name in state_dicts:
                m.load_state_dict(state_dicts[name])
            elif name == "pixelcnn":
                m.load_flax(unflatten_tree(random_pixelcnn_params(self.cfg, gen)))
            else:
                m.reset(gen)

    @classmethod
    def from_stitched(cls, path: str, *, device="cuda") -> "PixelSynth":
        """Load a stitched checkpoint; the distribution-preserving schedule
        knobs are reset to the current defaults (demo.load_model)."""
        from pixelsynth_tpu_torch.weights import from_jax_params, load_stitched_npz

        cfg, variables, _ = load_stitched_npz(path)
        cfg.refresh_splat_perf_knobs()
        return cls(cfg, device=device, state_dicts=from_jax_params(variables, cfg))

    # -- stages ------------------------------------------------------------

    def regress_depth(self, img: torch.Tensor, *, train: bool = False):
        """sigmoid(UNet) scaled to [min_z, max_z] (z_buffermodel.py:303-314).
        With train=True the U-Net runs in train mode (batch statistics, one
        power iteration) and the result is (depth, its collection updates:
        the U-Net's `batch_stats` / `spectral_stats`, updated in place)."""
        mc = self.cfg.model
        self.unet.train(train)
        raw = self.unet(img)[..., 0]
        if mc.use_inverse_depth:
            depth = 1.0 / (torch.sigmoid(raw) * 10.0 + 0.01)
        else:
            depth = torch.sigmoid(raw) * (mc.max_z - mc.min_z) + mc.min_z
        return (depth, collections(self.unet)) if train else depth

    def features(self, img: torch.Tensor, *, noise_scale: float = 1.0,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The point features (pipeline.py:294-303): the image itself, or
        the encoder's (B, W, W, 64) with its NoiseBN draws from `gen`
        (eval mode: the encoder has no trainer here, see
        `refuse_what_jax_cannot`)."""
        if self.encoder is None:
            return img
        return self.encoder(img, noise_scale=noise_scale, gen=gen)

    def splat_view(self, fs, depth, cams):
        """Project view-1 features into the output camera and splat.
        cams: K, Kinv, P_in, Pinv_in, P_out, each (B, 4, 4).  Returns
        (gen_fs (B, W, W, C), background (B, W, W) bool, cloud (B, N, 4))."""
        B = fs.shape[0]
        cloud = lift_to_cloud(depth, cams["K"], cams["Kinv"], cams["Pinv_in"],
                              cams["P_out"], self.W)
        pts, valid = homogeneous_to_pixels(cloud, self.W)
        gen_fs, bg = splat(pts, fs.reshape(B, -1, fs.shape[-1]), valid, W=self.W,
                           cfg=self.cfg.model.splat)
        return gen_fs, bg, cloud.transpose(1, 2)

    def _mask_arg(self, bg):
        """The mask the no-outpainting renders pass the decoder: none when
        the config has `no_outpainting` (pipeline.py:605,626)."""
        return None if self.cfg.model.no_outpainting else bg

    @torch.no_grad()
    def render_no_outpaint(self, img, cams, *, noise_scale: float = 1.0,
                           gen: Optional[torch.Generator] = None):
        """The no-outpainting path (pipeline.py:616-631, z_buffermodel.py
        :382-383): depth -> features -> lift -> splat -> the refinement
        decoder; the encoder's and the decoder's noise draws come from
        `gen`, in that order."""
        depth = self.regress_depth(img)
        fs = self.features(img, noise_scale=noise_scale, gen=gen)
        gen_fs, bg, _ = self.splat_view(fs, depth, cams)
        gen_img = self.decode_image(gen_fs, self._mask_arg(bg),
                                    noise_scale=noise_scale, gen=gen)
        return {"PredImg": gen_img, "PredDepth": depth, "Background": bg,
                "FeaturesImg": gen_fs}

    @torch.no_grad()
    def forward_angle(self, img, K, Kinv, RTs, *, gen: Optional[torch.Generator] = None,
                      return_depth: bool = False):
        """Render each output extrinsic of `RTs` from one image without
        outpainting (pipeline.py:591-614, z_buffermodel.py:710-754): one
        depth pass and one feature pass, then per view `splat_view` (one K2
        launch) and the decoder.  The decoder's noise stream restarts at
        every view, as the JAX package hands every view the same key: each
        view's draws start from `gen`'s state after the feature pass.
        img (B, W, W, 3); K, Kinv (B, 4, 4); RTs a list of (4, 4) or (B, 4,
        4) world-from-output extrinsics.  -> list of (B, W, W, 3)
        [, depth (B, W, W)]."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        B = img.shape[0]
        eye = torch.eye(4, device=img.device).expand(B, 4, 4)
        depth = self.regress_depth(img)
        fs = self.features(img, gen=gen)
        start = gen.get_state()
        outs = []
        for RT in RTs:
            RT = RT if torch.is_tensor(RT) else torch.as_tensor(np.asarray(RT, np.float32))
            RT = RT.to(img.device, torch.float32).expand(B, 4, 4)
            cams = {"K": K, "Kinv": Kinv, "P_in": eye, "Pinv_in": eye, "P_out": RT}
            gen_fs, bg, _ = self.splat_view(fs, depth, cams)
            gen.set_state(start)
            outs.append(self.decode_image(gen_fs, self._mask_arg(bg), gen=gen))
        return (outs, depth) if return_depth else outs

    def splat_cumulative(self, fs, depth, cams, state: CloudState,
                         last_bg: Optional[torch.Tensor], RTinv_last):
        """Cumulative-scene splat (pipeline.py:327-373): the prior cloud in
        the new camera, together with only the previously outpainted
        (last-background) points of the current view; the cloud grows by
        those same points."""
        B = fs.shape[0]
        cur_cloud = lift_to_cloud(depth, cams["K"], cams["Kinv"],
                                  cams["Pinv_in"], cams["P_out"], self.W)
        cur_pts, cur_valid = homogeneous_to_pixels(cur_cloud, self.W)
        cur_feats = fs.reshape(B, -1, fs.shape[-1])
        if last_bg is not None:
            cur_valid = cur_valid & last_bg.reshape(B, -1)
        state_t = state.transform(cams["K"], cams["P_out"], RTinv_last)
        prior_pts, prior_valid = homogeneous_to_pixels(state_t.pts.transpose(1, 2),
                                                       self.W)
        prior_valid = prior_valid & state_t.valid
        gen_fs, bg = splat(torch.cat([cur_pts, prior_pts], 1),
                           torch.cat([cur_feats, state_t.feats], 1),
                           torch.cat([cur_valid, prior_valid], 1),
                           W=self.W, cfg=self.cfg.model.splat)
        new_state = state_t.append_compact(cur_cloud.transpose(1, 2), cur_feats,
                                           cur_valid)
        return gen_fs, bg, new_state

    def masks_for_background(self, bg_mask: torch.Tensor, *,
                             host: Optional[bool] = None):
        """The generation orders and kernel masks of a batch's background
        (z_buffermodel.py:641-701; pipeline.py:375-397): the signed distance
        field of the downsampled masks, then the greedy order by
        `lmconv.masks_backend` -- "jax" the device builder
        (ops/orders_device.py, the CUDA kernel on the card), "host" the heap
        after a copy to the host (ops/orders.py); `host` overrides the field.
        -> (order (B, HW, 2), masks (B, 3, k^2, HW), bg_ds (B, h, w))."""
        fg_ds = downsample_mask(~bg_mask)
        bg_ds = downsample_mask(bg_mask)
        l = self.cfg.model.lmconv
        if host is None:
            host = masks_backend_is_host(l)
        distances = signed_distance_field(binarize_trunc(fg_ds),
                                          binarize_trunc(bg_ds), mode=l.dt_mode)
        build = orders_and_masks if host else orders_and_masks_device
        order, masks = build(distances, l.kernel_size, l.max_dilation)
        return order, masks, bg_ds

    def vq_encode(self, img):
        return self.vqvae.encode(img)

    def vq_decode(self, codes):
        return self.vqvae.decode_code(codes)

    def make_sampling_logits_fn(self, masks):
        """(codes, filled) -> logits closure for the AR population loop, by
        `lmconv.sample_backend` (`sampling_logits_fn`)."""
        return sampling_logits_fn(self.cfg.model.lmconv, self.pixelcnn,
                                  self.packed, masks)

    def decode_image(self, combined, bg_mask, *, noise_scale: float = 1.0,
                     gen: Optional[torch.Generator] = None, train: bool = False):
        """The refinement decoder on `combined` and the mask given (None:
        no mask channel), as pipeline.py:470-476 passes it; its noise draws
        come from `gen`.  With train=True, (image, the decoder's collection
        updates)."""
        self.projector.train(train)
        out = self.projector(combined, bg_mask, noise_scale=noise_scale, gen=gen)
        return (out, collections(self.projector)) if train else out

    def pixelcnn_logits(self, onehot, masks, *, train: bool = False,
                        gen: Optional[torch.Generator] = None):
        """The training-side PixelCNN on one-hot codes (pipeline.py:408):
        onehot (B, h, w, num_classes), masks (B, 3, k^2, hw) stacked [init,
        undilated, dilated].  On the card with train_backend "pallas" the
        masks are laid out for K3 once for all its launches.  -> logits
        (B, h, w, num_classes)."""
        self.pixelcnn.train(train)
        triple = [masks[:, 0], masks[:, 1], masks[:, 2]]
        if masks.is_cuda and self.cfg.model.lmconv.train_backend == "pallas":
            triple = [prepare_mask(m) for m in triple]
        return self.pixelcnn(onehot, *triple, gen=gen)

    def batch_to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """numpy arrays -> float32 tensors on this device; tensors are moved
        and keep their dtype."""
        return {k: (v.to(self.device) if torch.is_tensor(v) else
                    torch.as_tensor(np.array(v, np.float32), device=self.device))
                for k, v in batch.items()}

    def train_forward(self, batch: Dict, *, gen: Optional[torch.Generator] = None,
                      train_ar: bool = True, train: bool = True,
                      noise_scale: float = 1.0):
        """Stage-2 training forward (pipeline.py:485-588, the reference's
        z_buffermodel.py:291-419).

        batch: {"input_img", "output_img" (B, W, W, 3) in [-1, 1], "K",
        "Kinv", "P_in", "Pinv_in", "P_out" (B, 4, 4)[, "depth_img"]}.  The
        trainable trees (unet, projector, pixelcnn) run in train mode when
        `train`, updating their batch / spectral statistics in place; the
        VQ-VAE is frozen and the VGG19 only a loss.  NoiseBN noise comes
        from `gen`; noise_scale=0.0 gives the deterministic forward (gain
        1, bias 0).  Returns (total loss, losses, outputs, updates), the
        last the trees' collections after the forward."""
        mc = self.cfg.model
        img, out_img = batch["input_img"], batch["output_img"]
        cams = {k: batch[k] for k in ("K", "Kinv", "P_in", "Pinv_in", "P_out")}
        updates = {"unet": None, "projector": None}
        if mc.use_gt_depth and "depth_img" in batch:
            depth = batch["depth_img"]
        elif train:
            depth, updates["unet"] = self.regress_depth(img, train=True)
        else:
            depth = self.regress_depth(img)
        gen_fs, bg, _ = self.splat_view(self.features(img), depth, cams)

        losses: Dict[str, torch.Tensor] = {}
        ar_loss = None
        with torch.no_grad():
            codes = self.vq_encode(out_img)
        if train_ar and not mc.no_outpainting:
            _, masks, _ = self.masks_for_background(bg)
            oh = F.one_hot(codes, mc.lmconv.num_classes).float()
            ar_logits = self.pixelcnn_logits(oh, masks, train=train, gen=gen)
            ar_loss = softmax_xent(ar_logits, codes)
        # the ground-truth background stand-in: decoded GT codes
        # (z_buffermodel.py:370-380) from the frozen VQ-VAE
        with torch.no_grad():
            input_gt = self.vq_decode(codes)
        combined = self.combine(gen_fs, input_gt, bg)
        if train:
            gen_img, updates["projector"] = self.decode_image(
                combined, bg, noise_scale=noise_scale, gen=gen, train=True)
        else:
            gen_img = self.decode_image(combined, bg, noise_scale=noise_scale, gen=gen)

        losses.update(synthesis_loss(gen_img, out_img, losses=self.cfg.loss.losses,
                                     vgg=self.vgg))
        total = losses["Total Loss"]
        if ar_loss is not None:
            lam = self.cfg.loss.lambda_autoreg
            total = total + ar_loss * (1.0 if lam is None else lam)
            # bits-per-dim-style report (z_buffermodel.py:398)
            losses["autoreg_loss"] = ar_loss.detach() / np.log(2.0)
        if mc.train_depth and "depth_img" in batch:
            # supervised depth L1 (z_buffermodel.py:404-407)
            depth_loss = (depth - batch["depth_img"]).abs().mean()
            total = total + depth_loss
            losses["depth_loss"] = depth_loss
        losses["Total Loss"] = total
        outputs = {
            "PredImg": gen_img,
            "OutputImg": out_img,
            "InputImg": img,
            "PredDepthImg": depth / 5.0 - 1.0,
            "ForegroundImg": (~bg).float(),
        }
        return total, losses, outputs, updates

    @staticmethod
    def combine(gen_fs, decoded, bg_mask):
        """Foreground splat + background AR content (z_buffermodel.py:703-708)."""
        bg = bg_mask.to(gen_fs.dtype)[..., None]
        return gen_fs * (1.0 - bg) + decoded * bg
