"""Depth-regression U-Net (port of pixelsynth_tpu/models/unet.py).

Stride-2 4x4 down convs to 1x1, then bilinear-2x + 3x3 conv up stages with
skip concatenation; BatchNorm between stages, LeakyReLU(0.2) down, ReLU
up.  `levels` = log2(W).  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import (
    Conv, FlaxNamed, StandingStatsBN, SyncBatchNorm, upsample2x,
)


class UNet(FlaxNamed):
    def __init__(self, num_filters=32, channels_out=1, spectral=True,
                 levels=8, norm="batch", in_channels=3):
        super().__init__()
        nf, L = num_filters, levels
        mults = [1, 2, 4] + [8] * (L - 3)
        chans = [nf * m for m in mults[:L]]
        self.levels = L
        make_norm = ((lambda c: StandingStatsBN(c)) if norm == "batchstanding"
                     else (lambda c: SyncBatchNorm(c)))
        norm_kind = "StandingStatsBN" if norm == "batchstanding" else "SyncBatchNorm"
        # creation order == Flax's call order, so the auto-names line up
        self.enc_convs, self.enc_norms = [], []
        self.enc_convs.append(self.add("SNConv", Conv(in_channels, chans[0], 4, 2, 1,
                                                      spectral=spectral)))
        self.enc_norms.append(None)
        for i in range(1, L):
            self.enc_convs.append(self.add("SNConv", Conv(chans[i - 1], chans[i], 4, 2, 1,
                                                          spectral=spectral)))
            self.enc_norms.append(self.add(norm_kind, make_norm(chans[i]))
                                  if i != L - 1 else None)
        self.dec_convs, self.dec_norms = [], []
        cin = chans[L - 1]
        for i in range(L - 1, 0, -1):
            cout = chans[i - 1] if i <= 3 else chans[i]
            self.dec_convs.append(self.add("SNConv", Conv(cin, cout, 3, 1, 1,
                                                          spectral=spectral)))
            self.dec_norms.append(self.add(norm_kind, make_norm(cout)))
            cin = cout + chans[i - 1]
        self.final = self.add("SNConv", Conv(cin, channels_out, 3, 1, 1,
                                             spectral=spectral))

    def forward(self, x):
        """x (B, H, W, 3) -> (B, H, W, channels_out)."""
        h = self.enc_convs[0](x.permute(0, 3, 1, 2))
        encs = [h]
        for i in range(1, self.levels):
            h = self.enc_convs[i](F.leaky_relu(encs[-1], 0.2))
            if self.enc_norms[i] is not None:
                h = self.enc_norms[i](h)
            encs.append(h)
        h = encs[-1]
        for j, i in enumerate(range(self.levels - 1, 0, -1)):
            h = self.dec_norms[j](self.dec_convs[j](upsample2x(torch.relu(h))))
            h = torch.cat([h, encs[i - 1]], dim=1)
        h = self.final(upsample2x(torch.relu(h)))
        return h.permute(0, 2, 3, 1)
