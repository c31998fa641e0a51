"""BigGAN-style refinement decoder (port of
pixelsynth_tpu/models/encoderdecoder.py, decoder only: the feature encoder
is unused with RGB point features)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pixelsynth_tpu_torch.models.layers import FlaxNamed, ResNetBlock


def get_resnet_arch(model_type: str, ngf: int = 64) -> Dict:
    """Decoder channel tables (encoderdecoder.py:21-57, the 256W8UpDown
    family; configs.py:54-99 of the reference)."""
    setup = model_type.split("_")[1]
    std_dec_tail = [ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2, ngf * 2, 3]
    if setup in ("256W8UpDown", "256W8UpDown64", "256W8UpDownRGB",
                 "256W8UpDown3", "256W8UpDown3SuperRes"):
        dec_in = {"256W8UpDown": 128, "256W8UpDown64": 64, "256W8UpDownRGB": 3,
                  "256W8UpDown3": None, "256W8UpDown3SuperRes": None}[setup]
        return {"layers_dec": [dec_in] + std_dec_tail,
                "upsample": [False, "Down", "Down", False, "Up", "Up", False, False]}
    if setup == "256W8UpDown3_ultra":
        return {"layers_dec": [3] + std_dec_tail,
                "upsample": ["Down", "Down", "Down", False, "Up", "Up", "Up", False]}
    raise ValueError(f"arch {model_type} is not ported")


class ResNetDecoder(FlaxNamed):
    """Refinement decoder with residual prediction and the foreground-mask
    input channel (encoderdecoder.py:78-111).  NHWC in and out."""

    def __init__(self, model_type="resnet_256W8UpDown3", ngf=64, spectral=True,
                 predict_residual=True, normalize_before_residual=False,
                 in_channels=3, with_mask=True):
        super().__init__()
        arch = get_resnet_arch(model_type, ngf)
        chans = list(arch["layers_dec"])
        if chans[0] is None:
            chans[0] = in_channels + (1 if with_mask else 0)
        self.predict_residual = predict_residual
        self.normalize_before_residual = normalize_before_residual
        self.blocks = [self.add("ResNetBlock", ResNetBlock(
            chans[i - 1], chans[i], arch["upsample"][i - 1], spectral))
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
