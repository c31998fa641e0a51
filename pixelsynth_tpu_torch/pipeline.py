"""The PixelSynth inference pipeline on PyTorch (port of the inference
stages of pixelsynth_tpu/pipeline.py, :285-481).

  depth U-Net -> reprojection -> soft z-buffer splat (K2; binning by
  `splat.binning` / `splat.sort_backend`, K5) -> background mask ->
  generation order (host heap) + kernel masks -> VQ encode -> AR fill
  (`lmconv.sample_backend`: "fused" = speculative through K1, "pallas" =
  the module path through K3, "xla" = the module path through the plain
  masked conv) -> VQ decode -> refinement decoder

Cumulative scenes carry a fixed-capacity, validity-masked point cloud
(`CloudState`); appends compact it with a stable sort.  Entry points run
on `cuda` unless the caller passes device="cpu".
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
from pixelsynth_tpu_torch.models.encoderdecoder import ResNetDecoder
from pixelsynth_tpu_torch.models.lmconv import LMPixelCNN, flax_named_params
from pixelsynth_tpu_torch.models.unet import UNet
from pixelsynth_tpu_torch.models.vqvae import VQVAETop
from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
from pixelsynth_tpu_torch.ops.lmconv_fused import (
    make_fused_logits_fn, pack_lmconv_params,
)
from pixelsynth_tpu_torch.ops.masked_conv_kernel import prepare_mask
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
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


def downsample_mask(mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(B, H, W) -> avg-pooled by `factor` (z_buffermodel.py:87,646-647)."""
    return F.avg_pool2d(mask.float()[:, None], factor, factor)[:, 0]


def binarize_trunc(mask_ds: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> {0,1} by truncation: 1 only where the cell is
    entirely inside (z_buffermodel.py:668-669)."""
    return (mask_ds >= 1.0 - 1e-6).float()


def build_modules(cfg: Config, classifier_vars=None) -> Dict[str, torch.nn.Module]:
    """The view step's networks, on the CPU, unloaded."""
    mc = cfg.model
    if not mc.use_rgb_features or "modifier" in mc.depth_predictor_type:
        raise NotImplementedError("the port serves RGB point features only")
    spectral = "spectral" in mc.norm_G
    levels = int(round(np.log2(mc.W)))
    if 2 ** levels != mc.W:
        raise ValueError("W must be a power of two")
    v = mc.vqvae
    n_cls = 365
    if classifier_vars is not None:
        n_cls = int(np.asarray(classifier_vars["params"]["Dense_0"]["kernel"]).shape[-1])
    return {
        "unet": UNet(mc.unet_num_filters, 1, spectral, levels,
                     "batchstanding" if "batchstanding" in mc.norm_G else "batch"),
        "projector": ResNetDecoder(mc.refine_model_type, mc.ngf, spectral,
                                   mc.predict_residual,
                                   mc.normalize_before_residual),
        "vqvae": VQVAETop(v.in_channel, v.channel, v.n_res_block,
                          v.n_res_channel, v.embed_dim, v.n_embed),
        "disc": MultiscaleDiscriminator(mc.ndf),
        "classifier": ResNet18(n_cls),
    }


SAMPLE_BACKENDS = ("fused", "pallas", "xla")


def build_pixelcnn(cfg: Config) -> LMPixelCNN:
    """The sampling-side PixelCNN module (`pixelcnn_fast`, pipeline.py
    :226-231), on the CPU, unloaded: the masked-conv backend is
    `lmconv.sample_backend`, with "fused" keeping the kernel backend for
    the module (the fused forward itself is `make_sampling_logits_fn`'s)."""
    l = cfg.model.lmconv
    if l.sample_backend not in SAMPLE_BACKENDS:
        raise NotImplementedError(
            f"lmconv.sample_backend={l.sample_backend!r}: the port implements "
            f"{SAMPLE_BACKENDS}")
    if l.weight_norm:
        raise NotImplementedError("lmconv.weight_norm=True is not ported")
    return LMPixelCNN(
        nr_resnet=l.nr_resnet, nr_filters=l.nr_filters,
        input_channels=l.input_channels, kernel_size=l.kernel_size,
        max_dilation=l.max_dilation, feature_norm=l.feature_norm,
        dropout_prob=l.dropout_prob, conv_bias=l.conv_bias,
        conv_mask_weight=l.conv_mask_weight, num_classes=l.num_classes,
        compute_dtype=l.compute_dtype,
        backend="pallas" if l.sample_backend == "fused" else l.sample_backend)


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


class PixelSynth:
    """The networks of the view step plus its stages.

    state_dicts: {tree: state dict} from weights.from_jax_params (trained
    weights); without it every network is initialized from `seed`.
    with_classifier: build the re-ranking classifier (always when its
    state dict is given)."""

    def __init__(self, cfg: Config, *, device="cuda", seed: int = 0,
                 state_dicts: Optional[Dict[str, Dict]] = None,
                 with_classifier: Optional[bool] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.W = cfg.model.W
        state_dicts = state_dicts or {}
        mods = build_modules(cfg)
        if "classifier" in state_dicts:
            n_cls = state_dicts["classifier"]["Dense_0.weight"].shape[0]
            mods["classifier"] = ResNet18(n_cls)
        if with_classifier is None:
            with_classifier = "classifier" in state_dicts
        if not with_classifier:
            mods.pop("classifier")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, m in mods.items():
                if name in state_dicts:
                    m.load_state_dict(state_dicts[name])
                else:
                    m.reset(gen)
        for name, m in mods.items():
            setattr(self, name, m.to(self.device).eval())
        self.classifier = mods.get("classifier")
        if self.classifier is not None:
            self.classifier = self.classifier.to(self.device).eval()
        # one PixelCNN parameter set for the three engines: the module
        # (sample_backend "pallas" / "xla"), K1's packing ("fused") and the
        # per-layer kernel engine (models/lmconv_fast.py)
        pixelcnn = build_pixelcnn(cfg)
        with torch.no_grad():
            if "pixelcnn" in state_dicts:
                pixelcnn.load_state_dict(state_dicts["pixelcnn"])
            else:
                pixelcnn.load_flax(unflatten_tree(random_pixelcnn_params(cfg, gen)))
        self.pixelcnn = pixelcnn.to(self.device).eval()
        l = cfg.model.lmconv
        self.pixelcnn_params = flax_named_params(self.pixelcnn)
        self.packed = pack_lmconv_params(self.pixelcnn_params,
                                         nr_resnet=l.nr_resnet,
                                         compute_dtype=l.compute_dtype,
                                         device=self.device)

    @classmethod
    def from_stitched(cls, path: str, *, device="cuda") -> "PixelSynth":
        """Load a stitched checkpoint; the distribution-preserving schedule
        knobs are reset to the current defaults (demo.load_model)."""
        from pixelsynth_tpu_torch.weights import from_jax_params, load_stitched_npz

        cfg, variables, _ = load_stitched_npz(path)
        cfg.refresh_splat_perf_knobs()
        return cls(cfg, device=device, state_dicts=from_jax_params(variables, cfg))

    # -- stages ------------------------------------------------------------

    def regress_depth(self, img: torch.Tensor) -> torch.Tensor:
        """sigmoid(UNet) scaled to [min_z, max_z] (z_buffermodel.py:303-314)."""
        mc = self.cfg.model
        raw = self.unet(img)[..., 0]
        if mc.use_inverse_depth:
            return 1.0 / (torch.sigmoid(raw) * 10.0 + 0.01)
        return torch.sigmoid(raw) * (mc.max_z - mc.min_z) + mc.min_z

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """The point features: the image itself (the port serves RGB point
        features only; `build_modules` refuses an encoder)."""
        return img

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

    @torch.no_grad()
    def render_no_outpaint(self, img, cams, *, noise_scale: float = 1.0,
                           gen: Optional[torch.Generator] = None):
        """The no-outpainting path (z_buffermodel.py:382-383): depth ->
        lift -> splat -> the refinement decoder, whose noise draws come
        from `gen`.  The decoder is built with the foreground-channel
        input, so the mask is passed unless the config has
        `no_outpainting`."""
        depth = self.regress_depth(img)
        fs = self.features(img)
        gen_fs, bg, _ = self.splat_view(fs, depth, cams)
        gen_img = self.decode_image(gen_fs, bg, noise_scale=noise_scale, gen=gen)
        return {"PredImg": gen_img, "PredDepth": depth, "Background": bg,
                "FeaturesImg": gen_fs}

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

    def masks_for_background(self, bg_mask: torch.Tensor):
        """-> (order (B, HW, 2), masks (B, 3, k^2, HW), bg_ds (B, h, w))."""
        fg_ds = downsample_mask(~bg_mask)
        bg_ds = downsample_mask(bg_mask)
        l = self.cfg.model.lmconv
        distances = signed_distance_field(binarize_trunc(fg_ds),
                                          binarize_trunc(bg_ds), mode=l.dt_mode)
        order, masks = orders_and_masks(distances, l.kernel_size, l.max_dilation)
        return order, masks, bg_ds

    def vq_encode(self, img):
        return self.vqvae.encode(img)

    def vq_decode(self, codes):
        return self.vqvae.decode_code(codes)

    @torch.no_grad()
    def pixelcnn_logits_codes(self, codes, filled, masks):
        """The module path on integer codes + filled mask (the
        embedding-gather first layer): masks (B, 3, k^2, HW) stacked [init,
        undilated, dilated], or that triple as a sequence (whose members
        may be PreparedMasks).  Returns (B, H, W, num_classes) logits."""
        m = (masks[:, 0], masks[:, 1], masks[:, 2]) if torch.is_tensor(masks) else masks
        return self.pixelcnn(None, *m, codes=codes, filled=filled)

    def make_sampling_logits_fn(self, masks):
        """(codes, filled) -> logits closure for the AR population loop, by
        `lmconv.sample_backend` (pipeline.py:425-467): "fused" is the fused
        forward (K1; weights packed and masks folded once, outside the
        loop), with `.at`; "pallas" and "xla" go through the per-layer
        module (K3, or the plain masked conv) and have no `.at`, so the
        sampler takes one cell per forward."""
        l = self.cfg.model.lmconv
        if l.sample_backend == "fused":
            if l.feature_norm != "pono" or l.conv_mask_weight:
                raise NotImplementedError(
                    'lmconv.sample_backend="fused" computes feature_norm="pono" '
                    "without conv_mask_weight only")
            return make_fused_logits_fn(
                self.packed, masks, nr_resnet=l.nr_resnet,
                max_dilation=l.max_dilation, num_classes=l.num_classes,
                compute_dtype=l.compute_dtype)
        # build_pixelcnn refused every other value than "pallas" and "xla"
        triple = (masks[:, 0], masks[:, 1], masks[:, 2])
        if l.sample_backend == "pallas" and masks.is_cuda:
            # lay the masks out for K3 once, not at each of its launches
            triple = (triple[0], prepare_mask(triple[1]), prepare_mask(triple[2]))

        def fn(codes, filled):
            return self.pixelcnn_logits_codes(codes, filled, triple)

        return fn

    def decode_image(self, combined, bg_mask, *, noise_scale: float = 1.0,
                     gen: Optional[torch.Generator] = None):
        mask_arg = None if self.cfg.model.no_outpainting else bg_mask
        return self.projector(combined, mask_arg, noise_scale=noise_scale, gen=gen)

    @staticmethod
    def combine(gen_fs, decoded, bg_mask):
        """Foreground splat + background AR content (z_buffermodel.py:703-708)."""
        bg = bg_mask.to(gen_fs.dtype)[..., None]
        return gen_fs * (1.0 - bg) + decoded * bg
