"""The paper's comparison baselines (port of pixelsynth_tpu/models/
baselines.py; the reference's models/encoderdecoder.py:26-294), NHWC at
their boundaries: `ViewAppearanceFlow` (encode the image and the relative
pose, predict a flow field, warp the input bilinearly) and `Tatarchenko`
(regress the pixels directly).  `_ConvDecoder` reshapes to 8x8 and
upsamples five times, so both emit 256x256 and take W=256 inputs."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import BatchNorm, Conv, Dense, FlaxNamed


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with the corners aligned and out-of-range samples
    clamped to the border, the JAX package's own arithmetic
    (baselines.py:16-42): img (B, H, W, C), grid (B, H, W, 2) holding (x,
    y) in [-1, 1] -> (B, H, W, C).  The weights are x - floor(x) after the
    floor is clamped, so beyond the border they are clipped to [0, 1]."""
    B, H, W, C = img.shape
    x = (grid[..., 0] + 1.0) * (W - 1) / 2.0
    y = (grid[..., 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    flat = img.reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy * W + xx).long().reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, *yy.shape[1:], C)

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _act(kind: str):
    return torch.relu if kind == "relu" else (lambda h: F.leaky_relu(h, 0.2))


class _BN1d(BatchNorm):
    """Flax nn.BatchNorm (momentum 0.99) over the features of (B, F)."""

    def __init__(self, c):
        super().__init__(c, momentum=0.99)

    def forward(self, x):
        return super().forward(x[:, :, None, None])[:, :, 0, 0]


class _ConvEncoder(FlaxNamed):
    """6 stride-2 3x3 convs of 16..512 channels, then 2 dense layers of
    4096, each followed by the activation and a BatchNorm
    (baselines.py:45-62).  NCHW in, (B, 4096) out."""

    def __init__(self, act="relu", W=256):
        super().__init__()
        self.act = _act(act)
        cin = 3
        for feats in (16, 32, 64, 128, 256, 512):
            self.add("Conv", Conv(cin, feats, 3, 2, 1))
            self.add("BatchNorm", BatchNorm(feats, momentum=0.99))
            cin = feats
        fin = 512 * (W // 64) ** 2
        for _ in range(2):
            self.add("Dense", Dense(fin, 4096))
            self.add("BatchNorm", _BN1d(4096))
            fin = 4096

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"BatchNorm_{i}")(self.act(getattr(self, f"Conv_{i}")(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # Flax's NHWC flattening
        for i in range(2):
            x = getattr(self, f"BatchNorm_{6 + i}")(self.act(getattr(self, f"Dense_{i}")(x)))
        return x


class _ConvDecoder(FlaxNamed):
    """2 dense layers of 4096 -> 8x8x64 -> a 3x3 conv of 256, then four
    (nearest 2x upsample, 3x3 conv) stages of 128..16 channels, each with
    the activation and a BatchNorm, then a last upsample, a 3x3 conv to
    `out_channels` and tanh (baselines.py:65-91).  (B, fin) in, NHWC out."""

    def __init__(self, fin, out_channels=2, act="relu"):
        super().__init__()
        self.act = _act(act)
        for _ in range(2):
            self.add("Dense", Dense(fin, 4096))
            self.add("BatchNorm", _BN1d(4096))
            fin = 4096
        cin = 64
        for feats in (256, 128, 64, 32, 16):
            self.add("Conv", Conv(cin, feats, 3, 1, 1))
            self.add("BatchNorm", BatchNorm(feats, momentum=0.99))
            cin = feats
        self.add("Conv", Conv(cin, out_channels, 3, 1, 1))

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"BatchNorm_{i}")(self.act(getattr(self, f"Dense_{i}")(x)))
        x = x.reshape(x.shape[0], 8, 8, 64).permute(0, 3, 1, 2)
        for i in range(5):
            if i > 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"BatchNorm_{2 + i}")(self.act(getattr(self, f"Conv_{i}")(x)))
        x = self.Conv_5(F.interpolate(x, scale_factor=2, mode="nearest"))
        return torch.tanh(x).permute(0, 2, 3, 1)


class _AngleTransformer(FlaxNamed):
    """The relative pose's 12 numbers -> Dense 128 -> Dense out_dim, each
    with ReLU and a BatchNorm (baselines.py:94-105)."""

    def __init__(self, out_dim=256):
        super().__init__()
        self.add("Dense", Dense(12, 128))
        self.add("BatchNorm", _BN1d(128))
        self.add("Dense", Dense(128, out_dim))
        self.add("BatchNorm", _BN1d(out_dim))

    def forward(self, x):
        x = self.BatchNorm_0(torch.relu(self.Dense_0(x)))
        return self.BatchNorm_1(torch.relu(self.Dense_1(x)))


def _relative_pose(input_RTinv, output_RT):
    RT = (input_RTinv @ output_RT)[:, 0:3, :]
    return RT.reshape(RT.shape[0], -1)


class ViewAppearanceFlow(FlaxNamed):
    """The flow baseline (baselines.py:108-118): image and relative pose ->
    a (B, H, W, 2) flow in [-1, 1] -> `grid_sample` of the input.  In
    train mode its BatchNorms take the batch's statistics."""

    def __init__(self, W=256):
        super().__init__()
        self.add("_ConvEncoder", _ConvEncoder("relu", W))
        self.add("_AngleTransformer", _AngleTransformer(256))
        self.add("_ConvDecoder", _ConvDecoder(4096 + 256, 2, "relu"))

    def forward(self, input_img, input_RTinv, output_RT):
        fs = self._ConvEncoder_0(input_img.permute(0, 3, 1, 2))
        fa = self._AngleTransformer_0(_relative_pose(input_RTinv, output_RT))
        flow = self._ConvDecoder_0(torch.cat([fs, fa], -1))
        return grid_sample(input_img, flow)


class Tatarchenko(FlaxNamed):
    """The pixel-regression baseline (baselines.py:121-130): leaky ReLUs,
    a 64-wide pose code, the image regressed directly."""

    def __init__(self, W=256):
        super().__init__()
        self.add("_ConvEncoder", _ConvEncoder("leaky", W))
        self.add("_AngleTransformer", _AngleTransformer(64))
        self.add("_ConvDecoder", _ConvDecoder(4096 + 64, 3, "leaky"))

    def forward(self, input_img, input_RTinv, output_RT):
        fs = self._ConvEncoder_0(input_img.permute(0, 3, 1, 2))
        fa = self._AngleTransformer_0(_relative_pose(input_RTinv, output_RT))
        return self._ConvDecoder_0(torch.cat([fs, fa], -1))
