"""BigGAN-style ResNet feature encoder and refinement decoder (port of
pixelsynth_tpu/models/encoderdecoder.py).  `trainable` builds the training
layers of models/layers.py; in train mode a forward updates the NoiseBNs'
batch statistics and spectral vectors in place (the JAX modules return
them as their `batch_stats` / `spectral_stats` updates)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pixelsynth_tpu_torch.models.layers import FlaxNamed, ResNetBlock

FEATURE_DIM = 64   # the encoder's point features: layers_enc[-1] of every setup


def get_resnet_arch(model_type: str, ngf: int = 64) -> Dict:
    """Channel tables of every setup (encoderdecoder.py:21-56;
    configs.py:3-382 of the reference).  A None first entry means "the
    input's channels"; the modules here take the input width as built, as
    Flax infers it from the input."""
    setup = model_type.split("_")[1]
    shallow_enc = [None, ngf // 2, ngf // 2, ngf // 2, ngf, ngf, ngf, ngf, 64]
    std_dec_tail = [ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2, ngf * 2, 3]
    if setup in ("256W8UpDown", "256W8UpDown64", "256W8UpDownRGB",
                 "256W8UpDown3", "256W8UpDown3SuperRes"):
        dec_in = {"256W8UpDown": 128, "256W8UpDown64": 64, "256W8UpDownRGB": 3,
                  "256W8UpDown3": None, "256W8UpDown3SuperRes": None}[setup]
        return {"layers_enc": list(shallow_enc), "downsample": [False] * 8,
                "layers_dec": [dec_in] + std_dec_tail,
                "upsample": [False, "Down", "Down", False, "Up", "Up", False, False]}
    if setup == "256W8UpDown3_ultra":
        return {"layers_enc": list(shallow_enc), "downsample": [False] * 8,
                "layers_dec": [3] + std_dec_tail,
                "upsample": ["Down", "Down", "Down", False, "Up", "Up", "Up", False]}
    if setup == "256W8":
        return {"layers_enc": [None, ngf, ngf, ngf * 2, ngf * 2, ngf * 2,
                               ngf * 4, ngf * 4, 64],
                "downsample": [True, False, False, False, True, False, False, False],
                "layers_dec": [64, ngf, ngf, ngf * 2, ngf * 2, ngf * 2,
                               ngf * 4, ngf * 4, 3],
                "upsample": [False, False, "Up", False, False, False, "Up", False]}
    raise ValueError(f"unknown arch {model_type}")


class ResNetEncoder(FlaxNamed):
    """The point-feature encoder (encoderdecoder.py:59-75): eight ResNet
    blocks from the image's channels to FEATURE_DIM, each downsampling
    where the setup's `downsample` says so.  NHWC in and out; the NoiseBN
    draws come from `gen`."""

    def __init__(self, model_type="resnet_256W8UpDown3", ngf=64, spectral=True,
                 downsample=True, in_channels=3, trainable=False):
        super().__init__()
        arch = get_resnet_arch(model_type, ngf)
        chans = [in_channels] + arch["layers_enc"][1:]
        self.blocks = [self.add("ResNetBlock", ResNetBlock(
            chans[i - 1], chans[i],
            "Down" if downsample and arch["downsample"][i - 1] else None,
            spectral, trainable)) for i in range(1, len(chans))]

    def forward(self, x, *, noise_scale: float = 1.0,
                gen: Optional[torch.Generator] = None):
        h = x.permute(0, 3, 1, 2)
        for blk in self.blocks:
            h = blk(h, noise_scale=noise_scale, gen=gen)
        return h.permute(0, 2, 3, 1)


class ResNetDecoder(FlaxNamed):
    """Refinement decoder with residual prediction and the foreground-mask
    input channel (encoderdecoder.py:78-111).  NHWC in and out.
    in_channels is the width of what the first block reads: the features'
    width, plus 1 where the mask is passed."""

    def __init__(self, model_type="resnet_256W8UpDown3", ngf=64, spectral=True,
                 predict_residual=True, normalize_before_residual=False,
                 in_channels=4, trainable=False):
        super().__init__()
        arch = get_resnet_arch(model_type, ngf)
        chans = [in_channels] + arch["layers_dec"][1:]
        self.in_channels = in_channels
        self.predict_residual = predict_residual
        self.normalize_before_residual = normalize_before_residual
        self.blocks = [self.add("ResNetBlock", ResNetBlock(
            chans[i - 1], chans[i], arch["upsample"][i - 1], spectral, trainable))
            for i in range(1, len(chans))]

    def forward(self, x, background_mask: Optional[torch.Tensor] = None, *,
                noise_scale: float = 1.0,
                gen: Optional[torch.Generator] = None):
        if background_mask is not None:
            fg = (~background_mask).to(x.dtype)[..., None]
            h = torch.cat([x, fg], dim=-1)
        else:
            h = x
        h = h.permute(0, 3, 1, 2)
        for blk in self.blocks:
            h = blk(h, noise_scale=noise_scale, gen=gen)
        h = h.permute(0, 2, 3, 1)
        if self.predict_residual:
            if self.normalize_before_residual:
                return torch.tanh(h) + x
            return torch.tanh(h + x)
        return torch.tanh(h)
