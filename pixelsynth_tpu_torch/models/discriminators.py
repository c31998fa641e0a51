"""pix2pixHD multiscale PatchGAN discriminator (port of
pixelsynth_tpu/models/discriminators.py).  NHWC in; per scale, the list of
each layer's NHWC features.  `trainable` builds raw spectral-normed
weights with their u/v buffers; the discriminator has no batch
statistics, so train mode only advances the spectral vectors (which the
trainer does once a step, train/dpr.py)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import Conv, FlaxNamed, avg_pool


def _instance_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Flax GroupNorm(group_size=1, no affine): per-channel moments over
    space with the fast variance max(E[x^2] - E[x]^2, 0)."""
    mean = h.mean((2, 3), keepdim=True)
    var = torch.clamp((h * h).mean((2, 3), keepdim=True) - mean * mean, min=0)
    return (h - mean) * torch.rsqrt(var + eps)


class NLayerDiscriminator(FlaxNamed):
    def __init__(self, ndf=64, n_layers=4, in_channels=3, trainable=False):
        super().__init__()
        self.n_layers = n_layers
        nf = ndf
        kw = dict(trainable=trainable)
        self.convs = [self.add("SNConv", Conv(in_channels, nf, 4, 2, 2, **kw))]
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            self.convs.append(self.add("SNConv", Conv(
                nf_prev, nf, 4, stride, 2, bias=False, spectral=True, **kw)))
        self.convs.append(self.add("SNConv", Conv(nf, 1, 4, 1, 2, **kw)))

    def forward(self, x) -> List[torch.Tensor]:
        h = F.leaky_relu(self.convs[0](x), 0.2)
        results = [h]
        for n in range(1, self.n_layers):
            h = F.leaky_relu(_instance_norm(self.convs[n](h)), 0.2)
            results.append(h)
        results.append(self.convs[-1](h))
        return [r.permute(0, 2, 3, 1) for r in results]


class MultiscaleDiscriminator(FlaxNamed):
    def __init__(self, ndf=64, num_D=2, n_layers=4, trainable=False):
        super().__init__()
        self.discs = [self.add("NLayerDiscriminator",
                               NLayerDiscriminator(ndf, n_layers, trainable=trainable))
                      for _ in range(num_D)]

    def forward(self, x) -> List[List[torch.Tensor]]:
        h = x.permute(0, 3, 1, 2)
        outs = []
        for i, d in enumerate(self.discs):
            outs.append(d(h))
            if i != len(self.discs) - 1:
                h = avg_pool(h, 3, 2, 1, count_include_pad=False)
        return outs
