"""Top-only VQ-VAE-2, inference (port of pixelsynth_tpu/models/vqvae.py).

`VQVAETop.encode` returns the top-level code ids; `decode_code` maps ids
back to an image.  The codebook EMA update is training-only and not
ported.  NHWC in and out, NCHW inside.
"""

from __future__ import annotations

import numpy as np
import torch

from pixelsynth_tpu_torch.models.layers import Conv, ConvTranspose, FlaxNamed


class Quantize(FlaxNamed):
    """Nearest-codebook assignment (vqvae.py:21-74), eval only."""

    def __init__(self, dim=64, n_embed=512):
        super().__init__()
        self.dim = dim
        self.register_buffer("embed", torch.zeros(dim, n_embed))

    def forward(self, x):
        """x (..., dim) -> int64 ids (...)."""
        flat = x.reshape(-1, self.dim)
        dist = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ self.embed
                + (self.embed ** 2).sum(0, keepdim=True))
        return dist.argmin(1).reshape(x.shape[:-1])

    def embed_code(self, idx):
        return self.embed.T[idx]

    def reset(self, gen):
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen))

    def load_flax(self, node):
        self.embed.copy_(torch.tensor(np.asarray(node["embed"], np.float32)))


class ResBlock(FlaxNamed):
    """conv(relu(x)) + relu(x) (the reference's inplace-ReLU semantics)."""

    def __init__(self, cin, channel):
        super().__init__()
        self.add("Conv", Conv(cin, channel, 3, 1, 1))
        self.add("Conv", Conv(channel, cin, 1, 1, 0))

    def forward(self, x):
        r = torch.relu(x)
        return r + self.Conv_1(torch.relu(self.Conv_0(r)))


class Encoder(FlaxNamed):
    def __init__(self, cin, channel=128, n_res_block=2, n_res_channel=32,
                 stride=4):
        super().__init__()
        if stride == 4:
            self.add("Conv", Conv(cin, channel // 2, 4, 2, 1))
            self.add("Conv", Conv(channel // 2, channel, 4, 2, 1))
            self.add("Conv", Conv(channel, channel, 3, 1, 1))
        else:
            self.add("Conv", Conv(cin, channel // 2, 4, 2, 1))
            self.add("Conv", Conv(channel // 2, channel, 3, 1, 1))
        self.convs = [m for n, m in self.named_children()]
        self.blocks = [self.add("ResBlock", ResBlock(channel, n_res_channel))
                       for _ in range(n_res_block)]

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        for blk in self.blocks:
            x = blk(x)
        return torch.relu(x)


class Decoder(FlaxNamed):
    def __init__(self, cin, out_channel, channel=128, n_res_block=2,
                 n_res_channel=32, stride=4):
        super().__init__()
        self.add("Conv", Conv(cin, channel, 3, 1, 1))
        self.blocks = [self.add("ResBlock", ResBlock(channel, n_res_channel))
                       for _ in range(n_res_block)]
        if stride == 4:
            self.ups = [self.add("ConvTranspose", ConvTranspose(channel, channel // 2)),
                        self.add("ConvTranspose", ConvTranspose(channel // 2, out_channel))]
        else:
            self.ups = [self.add("ConvTranspose", ConvTranspose(channel, out_channel))]

    def forward(self, x):
        x = self.Conv_0(x)
        for blk in self.blocks:
            x = blk(x)
        x = torch.relu(x)
        for i, up in enumerate(self.ups):
            x = up(x)
            if i < len(self.ups) - 1:
                x = torch.relu(x)
        return x


class VQVAETop(FlaxNamed):
    """256 -> 32x32 grid of 512-way codes, decoded from the top level."""

    def __init__(self, in_channel=3, channel=128, n_res_block=2,
                 n_res_channel=32, embed_dim=64, n_embed=512):
        super().__init__()
        args = (channel, n_res_block, n_res_channel)
        self.enc_b = Encoder(in_channel, *args, stride=4)
        self.enc_t = Encoder(channel, *args, stride=2)
        self.quantize_conv_t = Conv(channel, embed_dim, 1)
        self.quantize_t = Quantize(embed_dim, n_embed)
        self.dec_t = Decoder(embed_dim, embed_dim, *args, stride=2)
        self.quantize_conv_b = Conv(embed_dim + channel, embed_dim, 1)
        self.quantize_b = Quantize(embed_dim, n_embed)
        self.upsample_t = ConvTranspose(embed_dim, embed_dim)
        self.dec = Decoder(embed_dim, in_channel, *args, stride=4)

    def encode(self, x):
        """(B, H, W, 3) -> top code ids (B, H/8, W/8) int64 (only the top
        path: the bottom codes do not feed id_t)."""
        h = self.enc_t(self.enc_b(x.permute(0, 3, 1, 2)))
        qt = self.quantize_conv_t(h).permute(0, 2, 3, 1)
        return self.quantize_t(qt)

    def decode_code(self, code_t):
        """(B, h, w) ids -> (B, 8h, 8w, 3)."""
        q = self.quantize_t.embed_code(code_t).permute(0, 3, 1, 2)
        return self.dec(self.upsample_t(q)).permute(0, 2, 3, 1)
