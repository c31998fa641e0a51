"""Shared layers of the port (inference subset of pixelsynth_tpu/models/layers.py).

Every module here is a `FlaxNamed` module: its children carry the names
Flax gives the same layers (`SNConv_0`, `BatchNorm_0`, `ResNetBlock_3`,
...), so a Flax variable subtree loads by walking names
(`load_flax(node)`, node = that module's merged params / batch_stats /
spectral_stats / ema leaves; see weights.merge_collections).

Layouts: the modules compute in NCHW, the torch convention; the top-level
models convert from and to the JAX package's NHWC at their boundary.
Spectral norm is folded at load (eval divides by sigma = |W^T v| with the
stored v, layers.py:40-79) and, for a random init, by power iteration.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(like.device)


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def spectral_sigma(mat: torch.Tensor, gen: torch.Generator,
                   iters: int = 15) -> torch.Tensor:
    """Largest singular value of mat (d, out) by power iteration from a
    random u, as the JAX package converges u at init (layers.py:53-63)."""
    u = l2norm(torch.randn(mat.shape[-1], generator=gen).to(mat))
    for _ in range(iters):
        u = l2norm(mat.T @ l2norm(mat @ u))
    v = l2norm(mat @ u)
    return torch.linalg.vector_norm(mat.T @ v)


class FlaxNamed(nn.Module):
    """Container whose children are named with Flax's auto-naming
    (`<Class>_<index>` in creation order)."""

    def __init__(self):
        super().__init__()
        self._counts: Dict[str, int] = {}

    def add(self, kind: str, module: nn.Module) -> nn.Module:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return module

    def load_flax(self, node: Dict) -> None:
        for name, child in self.named_children():
            child.load_flax(node[name])

    def reset(self, gen: torch.Generator) -> None:
        for child in self.children():
            child.reset(gen)


class Conv(FlaxNamed):
    """Flax nn.Conv / SNConv (HWIO kernel) as an NCHW conv (OIHW weight);
    spectral=True divides the weight by its spectral norm once, at load."""

    def __init__(self, cin, cout, k, stride=1, pad=0, *, bias=True,
                 spectral=False):
        super().__init__()
        self.stride, self.pad, self.spectral = stride, pad, spectral
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(cout), requires_grad=False)
                     if bias else None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)

    def reset(self, gen):
        cout = self.weight.shape[0]
        fan_in = self.weight[0].numel()
        w = torch.randn(self.weight.shape, generator=gen) / np.sqrt(fan_in)
        if self.spectral:
            w = w / spectral_sigma(w.reshape(cout, -1).T, gen)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def load_flax(self, node):
        k = torch.tensor(np.asarray(node["kernel"], np.float32))
        if self.spectral:
            mat = k.reshape(-1, k.shape[-1])
            v = torch.tensor(np.asarray(node["v"], np.float32))
            k = k / torch.linalg.vector_norm(mat.T @ v)
        self.weight.copy_(k.permute(3, 2, 0, 1))
        if self.bias is not None:
            self.bias.copy_(_t(node["bias"], self.bias))


class ConvTranspose(FlaxNamed):
    """Flax nn.ConvTranspose(k=4, strides=2, padding="SAME"), i.e. a conv of
    the 2x-dilated input padded (2, 2) with the unflipped kernel, which is
    torch's conv_transpose2d(padding=1) with the kernel flipped."""

    def __init__(self, cin, cout, k=4):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2,
                                  padding=1)

    def reset(self, gen):
        cin, cout, k, _ = self.weight.shape
        self.weight.copy_(torch.randn(self.weight.shape, generator=gen)
                          / np.sqrt(k * k * cin))
        self.bias.zero_()

    def load_flax(self, node):
        k = torch.tensor(np.asarray(node["kernel"], np.float32))
        self.weight.copy_(torch.flip(k, (0, 1)).permute(2, 3, 0, 1))
        self.bias.copy_(_t(node["bias"], self.bias))


class Dense(FlaxNamed):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def reset(self, gen):
        self.weight.copy_(torch.randn(self.weight.shape, generator=gen)
                          / np.sqrt(self.weight.shape[1]))
        self.bias.zero_()

    def load_flax(self, node):
        self.weight.copy_(_t(node["kernel"], self.weight).T)
        self.bias.copy_(_t(node["bias"], self.bias))


class BatchNorm(FlaxNamed):
    """Flax nn.BatchNorm in eval: (x - mean) * rsqrt(var + eps) [* scale]
    [+ bias], over NCHW channels."""

    def __init__(self, c, *, scale=True, bias=True, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.register_buffer("scale", torch.ones(c) if scale else None)
        self.register_buffer("shift", torch.zeros(c) if bias else None)

    def forward(self, x):
        mul = torch.rsqrt(self.var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x - self.mean[:, None, None]) * mul[:, None, None]
        if self.shift is not None:
            y = y + self.shift[:, None, None]
        return y

    def reset(self, gen):
        pass

    def load_flax(self, node):
        self.mean.copy_(_t(node["mean"], self.mean))
        self.var.copy_(_t(node["var"], self.var))
        if self.scale is not None:
            self.scale.copy_(_t(node["scale"], self.scale))
        if self.shift is not None:
            self.shift.copy_(_t(node["bias"], self.shift))


class SyncBatchNorm(FlaxNamed):
    """Eval-mode SyncBatchNorm: a named wrapper of one BatchNorm."""

    def __init__(self, c):
        super().__init__()
        self.add("BatchNorm", BatchNorm(c))

    def forward(self, x):
        return self.BatchNorm_0(x)


class StandingStatsBN(FlaxNamed):
    """BigGAN BatchNorm_StandingStats in eval with running stats
    (layers.py:148-191)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, val in (("gain", torch.ones(c)), ("bias", torch.zeros(c)),
                          ("stored_mean", torch.zeros(c)),
                          ("stored_var", torch.ones(c))):
            self.register_buffer(name, val)

    def forward(self, x):
        scale = torch.rsqrt(self.stored_var + self.eps) * self.gain
        shift = self.stored_mean * scale - self.bias
        return x * scale[:, None, None] - shift[:, None, None]

    def reset(self, gen):
        pass

    def load_flax(self, node):
        for name in ("gain", "bias", "stored_mean", "stored_var"):
            getattr(self, name).copy_(_t(node[name], getattr(self, name)))


class NoiseBN(FlaxNamed):
    """BigGAN noise-conditioned BN (layers.py:194-236) in eval: gain and
    bias predicted from a (B, 20) normal draw taken from `gen`, or zero
    noise when noise_scale == 0 (gain 1, bias 0)."""

    noise_sz = 20

    def __init__(self, c, spectral=True):
        super().__init__()
        self.spectral = spectral
        self.wg = nn.Parameter(torch.zeros(self.noise_sz, c), requires_grad=False)
        self.wb = nn.Parameter(torch.zeros(self.noise_sz, c), requires_grad=False)
        self.add("BatchNorm", BatchNorm(c, scale=False, bias=False))

    def forward(self, x, *, noise_scale: float = 1.0,
                gen: Optional[torch.Generator] = None):
        h = self.BatchNorm_0(x)
        if noise_scale == 0.0:
            return h
        noise = torch.randn((x.shape[0], self.noise_sz), generator=gen,
                            device=x.device) * noise_scale
        gain = 1.0 + noise @ self.wg
        bias = noise @ self.wb
        return h * gain[:, :, None, None] + bias[:, :, None, None]

    def reset(self, gen):
        for p in (self.wg, self.wb):
            w = torch.randn(p.shape, generator=gen) / np.sqrt(self.noise_sz)
            if self.spectral:
                w = w / spectral_sigma(w, gen)
            p.copy_(w)

    def load_flax(self, node):
        for p, kname, vname in ((self.wg, "gain_kernel", "v_gain"),
                                (self.wb, "bias_kernel", "v_bias")):
            w = torch.tensor(np.asarray(node[kname], np.float32))
            if self.spectral:
                v = torch.tensor(np.asarray(node[vname], np.float32))
                w = w / torch.linalg.vector_norm(w.T @ v)
            p.copy_(w)
        self.BatchNorm_0.load_flax(node["BatchNorm_0"])


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW (jax.image.resize bilinear ==
    align_corners=False with edge clamping)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def avg_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0):
    """Flax nn.avg_pool (padding counted in the divisor), NCHW."""
    return F.avg_pool2d(x, k, stride, padding, count_include_pad=True)


class ResNetBlock(FlaxNamed):
    """BigGAN ResNet block (layers.py:239-277), NCHW."""

    def __init__(self, in_c, features, resample=None, spectral=True):
        super().__init__()
        self.resample = resample
        self.add("NoiseBN", NoiseBN(in_c, spectral))
        self.add("SNConv", Conv(in_c, features, 3, 1, 1, spectral=spectral))
        self.add("NoiseBN", NoiseBN(features, spectral))
        self.add("SNConv", Conv(features, features, 3, 1, 1, spectral=spectral))
        self.has_skip = bool(resample) or in_c != features
        if self.has_skip:
            self.add("SNConv", Conv(in_c, features, 1, 1, 0, spectral=spectral))

    def _resample(self, h):
        if self.resample == "Down" or self.resample is True:
            return avg_pool(h, 3, 2, 1)
        if self.resample == "Up":
            return upsample2x(h)
        return h

    def forward(self, x, *, noise_scale=1.0, gen=None):
        h = torch.relu(self.NoiseBN_0(x, noise_scale=noise_scale, gen=gen))
        h = self.SNConv_0(h)
        h = torch.relu(self.NoiseBN_1(h, noise_scale=noise_scale, gen=gen))
        h = self._resample(self.SNConv_1(h))
        s = self._resample(self.SNConv_2(x)) if self.has_skip else x
        return h + s


# ---------------------------------------------------------------------------
# lmconv primitives (NHWC, channels last)
# ---------------------------------------------------------------------------


def concat_elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(torch.cat([x, -x], dim=-1))


def pono(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Positional normalization over the last axis, unbiased variance
    (ddof=1, layers.py:290-297)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=True)
    return (x - mean) / torch.sqrt(var + epsilon)


def order_rescale(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Divide by the per-location count of visible taps (layers.py:300-307).
    x (B, H, W, C); mask (B, k*k, H*W)."""
    B, H, W, _ = x.shape
    return x / mask.sum(1).reshape(B, H, W, 1)


class Nin(FlaxNamed):
    """1x1 'network in network' linear layer (layers.py:310-317): one
    Dense over the last axis."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.add("Dense", Dense(cin, features))

    def forward(self, x):
        return self.Dense_0(x)
