"""VQ-VAE-2 (port of pixelsynth_tpu/models/vqvae.py): `VQVAETop`, the
top-only model the pipeline serves and stage 1 trains, and `VQVAE`, the
two-level model (vqvae.py:202-252), which decodes from both levels.

Serving: `VQVAETop.encode` returns the top-level code ids and
`decode_code` maps ids back to an image.  Training (stage 1): `forward`
gives (recon, diff) and `encode_full` the JAX `encode`'s five outputs;
in train mode each `Quantize` applies its codebook EMA update
(vqvae.py:56-67) to its buffers.  The buffers carry the names of the
Flax `ema` collection (`embed`, `cluster_size`, `embed_avg`).  NHWC in
and out, NCHW inside.
"""

from __future__ import annotations

import numpy as np
import torch

from pixelsynth_tpu_torch.models.layers import Conv, ConvTranspose, FlaxNamed


class Quantize(FlaxNamed):
    """Nearest-codebook assignment with the EMA codebook update
    (vqvae.py:21-74).  `forward` gives the ids alone (the serving path);
    `quantize` gives (straight-through quantized, diff, ids) and, in train
    mode, updates `cluster_size`, `embed_avg` and `embed` in place."""

    def __init__(self, dim=64, n_embed=512, decay=0.99, eps=1e-5):
        super().__init__()
        self.dim, self.n_embed, self.decay, self.eps = dim, n_embed, decay, eps
        self.register_buffer("embed", torch.zeros(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(dim, n_embed))

    def _ids(self, flat):
        dist = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ self.embed
                + (self.embed ** 2).sum(0, keepdim=True))
        return dist.argmin(1)

    def forward(self, x):
        """x (..., dim) -> int64 ids (...)."""
        return self._ids(x.reshape(-1, self.dim)).reshape(x.shape[:-1])

    def quantize(self, x):
        """x (..., dim) -> (quantized (..., dim), diff, ids (...)).  The
        codebook read is the one before this call's update."""
        flat = x.reshape(-1, self.dim)
        with torch.no_grad():
            idx = self._ids(flat.detach())
            q = self.embed_code(idx.reshape(x.shape[:-1]))
            if self.training:
                self._ema_update(flat.detach(), idx)
        diff = ((q - x) ** 2).mean()
        return x + (q - x).detach(), diff, idx.reshape(x.shape[:-1])

    def _ema_update(self, flat, idx):
        d = self.decay
        onehot_sum = torch.bincount(idx, minlength=self.n_embed).to(flat.dtype)
        embed_sum = torch.zeros((self.n_embed, self.dim), dtype=flat.dtype,
                                device=flat.device).index_add_(0, idx, flat).T
        cs = self.cluster_size * d + onehot_sum * (1 - d)
        ea = self.embed_avg * d + embed_sum * (1 - d)
        n = cs.sum()
        cs_norm = (cs + self.eps) / (n + self.n_embed * self.eps) * n
        self.cluster_size.copy_(cs)
        self.embed_avg.copy_(ea)
        self.embed.copy_(ea / cs_norm[None, :])

    def embed_code(self, idx):
        return self.embed.T[idx]

    def reset(self, gen):
        """embed ~ N(0, 1) (Flax's init: one draw), cluster_size zeros,
        embed_avg a copy of embed."""
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen))
        self.cluster_size.zero_()
        self.embed_avg.copy_(self.embed)

    def load_flax(self, node):
        """The `ema` leaves; a tree without cluster_size / embed_avg leaves
        them as `reset` would (zeros, a copy of embed)."""
        self.embed.copy_(torch.tensor(np.asarray(node["embed"], np.float32)))
        self.cluster_size.zero_()
        self.embed_avg.copy_(self.embed)
        for name in ("cluster_size", "embed_avg"):
            if name in node:
                getattr(self, name).copy_(
                    torch.tensor(np.asarray(node[name], np.float32)))

    def to_flax(self):
        return {name: getattr(self, name).detach().cpu().numpy().astype(np.float32)
                for name in ("embed", "cluster_size", "embed_avg")}


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
                 n_res_channel=32, embed_dim=64, n_embed=512, decay=0.99,
                 eps=1e-5):
        super().__init__()
        args = (channel, n_res_block, n_res_channel)
        self.enc_b = Encoder(in_channel, *args, stride=4)
        self.enc_t = Encoder(channel, *args, stride=2)
        self.quantize_conv_t = Conv(channel, embed_dim, 1)
        self.quantize_t = Quantize(embed_dim, n_embed, decay, eps)
        self.dec_t = Decoder(embed_dim, embed_dim, *args, stride=2)
        self.quantize_conv_b = Conv(embed_dim + channel, embed_dim, 1)
        self.quantize_b = Quantize(embed_dim, n_embed, decay, eps)
        self.upsample_t = ConvTranspose(embed_dim, embed_dim)
        self.dec = Decoder(embed_dim, in_channel, *args, stride=4)

    def encode(self, x):
        """(B, H, W, 3) -> top code ids (B, H/8, W/8) int64 (only the top
        path: the bottom codes do not feed id_t)."""
        h = self.enc_t(self.enc_b(x.permute(0, 3, 1, 2)))
        qt = self.quantize_conv_t(h).permute(0, 2, 3, 1)
        return self.quantize_t(qt)

    def _qb_input(self, quant_t, enc_b):
        dec_t = self.dec_t(quant_t.permute(0, 3, 1, 2))
        return self.quantize_conv_b(torch.cat([dec_t, enc_b], 1)).permute(0, 2, 3, 1)

    def encode_full(self, x):
        """The JAX `encode` (vqvae.py:162-172): (B, H, W, 3) ->
        (quant_t, quant_b, diff_t + diff_b, id_t, id_b), NHWC.  In train
        mode both codebooks take their EMA update."""
        enc_b = self.enc_b(x.permute(0, 3, 1, 2))
        qt = self.quantize_conv_t(self.enc_t(enc_b)).permute(0, 2, 3, 1)
        quant_t, diff_t, id_t = self.quantize_t.quantize(qt)
        qb = self._qb_input(quant_t, enc_b)
        quant_b, diff_b, id_b = self.quantize_b.quantize(qb)
        return quant_t, quant_b, diff_t + diff_b, id_t, id_b

    def forward(self, x):
        """(B, H, W, 3) -> (recon (B, H, W, 3), diff): the stage-1
        training forward (vqvae.py:158-160)."""
        quant_t, _, diff, _, _ = self.encode_full(x)
        return self.decode(quant_t), diff

    def decode(self, quant_t):
        """(B, h, w, embed_dim) -> (B, 8h, 8w, 3)."""
        return self.dec(self.upsample_t(quant_t.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def decode_code(self, code_t):
        """(B, h, w) ids -> (B, 8h, 8w, 3)."""
        return self.decode(self.quantize_t.embed_code(code_t))

    @torch.no_grad()
    def pre_quantize(self, x):
        """Raw pre-quantization latents (qt, qb), NHWC, for the
        data-dependent codebook init (train/vqvae.init_codebook_from_batch);
        qb goes through the current top codebook and no buffer changes."""
        enc_b = self.enc_b(x.permute(0, 3, 1, 2))
        qt = self.quantize_conv_t(self.enc_t(enc_b)).permute(0, 2, 3, 1)
        quant_t = self.quantize_t.embed_code(self.quantize_t(qt))
        return qt, self._qb_input(quant_t, enc_b)


class VQVAE(VQVAETop):
    """The two-level VQ-VAE-2 (vqvae.py:202-252; the reference's
    vqvae.py:164-238): the top model's encoders, codebooks and top decoder,
    with the image decoder reading the upsampled top quantization beside
    the bottom one (2 x embed_dim channels).  `encode` gives both code
    ids, `encode_full` the JAX `encode`'s five outputs (in train mode both
    codebooks take their EMA update), `forward` (recon, diff).  NHWC."""

    def __init__(self, in_channel=3, channel=128, n_res_block=2,
                 n_res_channel=32, embed_dim=64, n_embed=512, decay=0.99,
                 eps=1e-5):
        super().__init__(in_channel, channel, n_res_block, n_res_channel,
                         embed_dim, n_embed, decay, eps)
        self.dec = Decoder(2 * embed_dim, in_channel, channel, n_res_block,
                           n_res_channel, stride=4)

    def encode(self, x):
        """(B, H, W, 3) -> (id_t (B, H/8, W/8), id_b (B, H/4, W/4)) int64."""
        _, _, _, id_t, id_b = self.encode_full(x)
        return id_t, id_b

    def forward(self, x):
        quant_t, quant_b, diff, _, _ = self.encode_full(x)
        return self.decode(quant_t, quant_b), diff

    def decode(self, quant_t, quant_b):
        """(B, h, w, embed_dim), (B, 2h, 2w, embed_dim) -> (B, 8h, 8w, 3)."""
        up_t = self.upsample_t(quant_t.permute(0, 3, 1, 2))
        return self.dec(torch.cat([up_t, quant_b.permute(0, 3, 1, 2)], 1)
                        ).permute(0, 2, 3, 1)

    def decode_code(self, code_t, code_b):
        """(B, h, w), (B, 2h, 2w) ids -> (B, 8h, 8w, 3)."""
        return self.decode(self.quantize_t.embed_code(code_t),
                           self.quantize_b.embed_code(code_b))
