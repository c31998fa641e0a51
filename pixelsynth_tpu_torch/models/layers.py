"""Shared layers of the port (port of pixelsynth_tpu/models/layers.py).

Every module here is a `FlaxNamed` module: its children carry the names
Flax gives the same layers (`SNConv_0`, `BatchNorm_0`, `ResNetBlock_3`,
...), so a Flax variable subtree loads by walking names
(`load_flax(node)`, node = that module's merged params / batch_stats /
spectral_stats / ema leaves; see weights.merge_collections).

Layouts: the modules compute in NCHW, the torch convention; the top-level
models convert from and to the JAX package's NHWC at their boundary.

Two builds of every layer that carries state:
  * serving (`trainable=False`, what the view step loads): spectral norm
    is folded into the weight at load (eval divides by sigma = |W^T v| with
    the stored v, layers.py:40-79) and, for a random init, by power
    iteration; weights do not require grad;
  * training (`trainable=True`): the raw weights are trainable
    `nn.Parameter`s, the spectral vectors `u`/`v` are buffers (the
    `spectral_stats` collection), and `module.train()` selects the train
    forward: one power iteration stored in the buffers, BatchNorm on batch
    statistics with the running statistics updated in place.  In eval the
    weight is divided by |mat^T v| with the stored v, which is the serving
    build's folded weight.
Buffers carry Flax's collection names, so `collections(module)` returns a
module's `batch_stats` / `spectral_stats` as Flax trees.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(like.device)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def converged_u(mat: torch.Tensor, gen: torch.Generator,
                iters: int = 15) -> torch.Tensor:
    """The right singular vector of mat (d, out) by power iteration from a
    random u, as the JAX package converges u at init (layers.py:53-63)."""
    u = l2norm(torch.randn(mat.shape[-1], generator=gen).to(mat))
    for _ in range(iters):
        u = l2norm(mat.T @ l2norm(mat @ u))
    return u


def spectral_sigma(mat: torch.Tensor, gen: torch.Generator,
                   iters: int = 15) -> torch.Tensor:
    """Largest singular value of mat (d, out) by power iteration."""
    v = l2norm(mat @ converged_u(mat, gen, iters))
    return torch.linalg.vector_norm(mat.T @ v)


def spectral_divide(module: nn.Module, w: torch.Tensor, mat: torch.Tensor,
                    uname: str = "u", vname: str = "v") -> torch.Tensor:
    """w / sigma with the module's stored spectral vectors
    (`_spectral_normalize`, layers.py:40-79); mat is w flattened as the
    JAX package flattens it, (d, out).  In train mode one power iteration
    under no grad, v = norm(mat @ u) then u = norm(mat^T @ v), stored in
    the buffers.  sigma = |mat^T v| with v detached, so the gradient
    reaches the weight through sigma."""
    v = getattr(module, vname)
    if module.training:
        with torch.no_grad():
            v = l2norm(mat @ getattr(module, uname))
            getattr(module, uname).copy_(l2norm(mat.T @ v))
            getattr(module, vname).copy_(v)
    return w / torch.linalg.vector_norm(mat.T @ v)


SPECTRAL_NAMES = ("u", "v", "u_gain", "v_gain", "u_bias", "v_bias")


def collections(module: nn.Module) -> Dict[str, Dict]:
    """The module's buffers as Flax collection trees: {"spectral_stats":
    {...}, "batch_stats": {...}}, nested by the Flax names (the buffers
    themselves, updated in place by a train forward)."""
    out: Dict[str, Dict] = {"batch_stats": {}, "spectral_stats": {}}
    for name, buf in module.named_buffers():
        parts = name.split(".")
        col = "spectral_stats" if parts[-1] in SPECTRAL_NAMES else "batch_stats"
        node = out[col]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = buf
    return {k: v for k, v in out.items() if v}


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

    def to_flax(self) -> Dict:
        """The inverse of `load_flax`: the module's leaves as one merged
        Flax tree of float32 numpy arrays (weights.split_collections sorts
        them into collections).  Only the trainer's build can be inverted:
        a serving build has folded its spectral norms."""
        return {name: child.to_flax() for name, child in self.named_children()}

    def reset(self, gen: torch.Generator) -> None:
        for child in self.children():
            child.reset(gen)


class Conv(FlaxNamed):
    """Flax nn.Conv / SNConv (HWIO kernel) as an NCHW conv (OIHW weight).
    spectral=True: the serving build divides the weight by its spectral
    norm once, at load; the trainable build keeps the raw weight and the
    `u` (out,) / `v` (kh*kw*cin,) buffers and divides at every forward."""

    def __init__(self, cin, cout, k, stride=1, pad=0, *, bias=True,
                 spectral=False, trainable=False):
        super().__init__()
        self.stride, self.pad, self.spectral = stride, pad, spectral
        self.sn_state = spectral and trainable
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k),
                                   requires_grad=trainable)
        self.bias = (nn.Parameter(torch.zeros(cout), requires_grad=trainable)
                     if bias else None)
        if self.sn_state:
            self.register_buffer("u", torch.zeros(cout))
            self.register_buffer("v", torch.zeros(k * k * cin))

    def _mat(self, w):
        """OIHW -> the HWIO kernel flattened to (kh*kw*cin, cout)."""
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])

    def forward(self, x):
        w = self.weight
        if self.sn_state:
            w = spectral_divide(self, w, self._mat(w))
        return F.conv2d(x, w, self.bias, self.stride, self.pad)

    def reset(self, gen):
        cout = self.weight.shape[0]
        fan_in = self.weight[0].numel()
        w = torch.randn(self.weight.shape, generator=gen) / np.sqrt(fan_in)
        if self.sn_state:
            u = converged_u(self._mat(w), gen)
            self.u.copy_(u)
            self.v.copy_(l2norm(self._mat(w) @ u))
        elif self.spectral:
            w = w / spectral_sigma(w.reshape(cout, -1).T, gen)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def load_flax(self, node):
        k = torch.tensor(np.asarray(node["kernel"], np.float32))
        if self.sn_state:
            self.u.copy_(_t(node["u"], self.u))
            self.v.copy_(_t(node["v"], self.v))
        elif self.spectral:
            mat = k.reshape(-1, k.shape[-1])
            v = torch.tensor(np.asarray(node["v"], np.float32))
            k = k / torch.linalg.vector_norm(mat.T @ v)
        self.weight.copy_(k.permute(3, 2, 0, 1))
        if self.bias is not None:
            self.bias.copy_(_t(node["bias"], self.bias))

    def to_flax(self):
        if self.spectral and not self.sn_state:
            raise ValueError("a serving Conv keeps its weight divided by its "
                             "spectral norm; only the trainer's build inverts")
        out = {"kernel": _n(self.weight.permute(2, 3, 1, 0))}
        if self.bias is not None:
            out["bias"] = _n(self.bias)
        if self.sn_state:
            out.update(u=_n(self.u), v=_n(self.v))
        return out


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

    def to_flax(self):
        return {"kernel": _n(torch.flip(self.weight.permute(2, 3, 0, 1), (0, 1))),
                "bias": _n(self.bias)}


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

    def to_flax(self):
        return {"kernel": _n(self.weight.T), "bias": _n(self.bias)}


def batch_moments(x: torch.Tensor):
    """Per-channel mean and biased variance of NCHW x over (N, H, W), as
    Flax's fast variance: max(E[x^2] - E[x]^2, 0)."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0)
    return mean, var


class BatchNorm(FlaxNamed):
    """Flax nn.BatchNorm over NCHW channels: (x - mean) * rsqrt(var + eps)
    [* scale] [+ bias].  Eval reads the running statistics; train
    (`module.train()`) normalises with the batch's and updates the running
    ones in place, old * momentum + batch * (1 - momentum) with the biased
    batch variance (Flax's convention: momentum 0.9 keeps 90% of the old)."""

    def __init__(self, c, *, scale=True, bias=True, eps=1e-5, momentum=0.9,
                 trainable=False):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.scale = (nn.Parameter(torch.ones(c), requires_grad=trainable)
                      if scale else None)
        self.shift = (nn.Parameter(torch.zeros(c), requires_grad=trainable)
                      if bias else None)

    def forward(self, x):
        mean, var = self.mean, self.var
        if self.training:
            mean, var = batch_moments(x)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(self.mean * m + mean * (1 - m))
                self.var.copy_(self.var * m + var * (1 - m))
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None]
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

    def to_flax(self):
        out = {"mean": _n(self.mean), "var": _n(self.var)}
        if self.scale is not None:
            out["scale"] = _n(self.scale)
        if self.shift is not None:
            out["bias"] = _n(self.shift)
        return out


class SyncBatchNorm(FlaxNamed):
    """SyncBatchNorm (layers.py:122-150): a named wrapper of one Flax
    nn.BatchNorm(momentum=0.9).  On one card the batch statistics are the
    whole batch's."""

    def __init__(self, c, trainable=False):
        super().__init__()
        self.add("BatchNorm", BatchNorm(c, trainable=trainable))

    def forward(self, x):
        return self.BatchNorm_0(x)


class StandingStatsBN(FlaxNamed):
    """BigGAN BatchNorm_StandingStats (layers.py:155-191) with running
    stats: eval normalises with the stored statistics; train with the
    batch's mean(x) and mean(x^2) - mean(x)^2, and moves the stored ones by
    momentum 0.1 in the torch convention (old * 0.9 + batch * 0.1).  The
    trainable build also keeps Flax's `accumulation_counter` (read by the
    standing-statistics mode, which no path here runs)."""

    def __init__(self, c, eps=1e-5, momentum=0.1, trainable=False):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.gain = nn.Parameter(torch.ones(c), requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=trainable)
        self.register_buffer("stored_mean", torch.zeros(c))
        self.register_buffer("stored_var", torch.ones(c))
        if trainable:
            self.register_buffer("accumulation_counter", torch.zeros(1))

    def forward(self, x):
        m, var = self.stored_mean, self.stored_var
        if self.training:
            m = x.mean((0, 2, 3))
            var = (x * x).mean((0, 2, 3)) - m * m
            with torch.no_grad():
                k = self.momentum
                self.stored_mean.copy_(self.stored_mean * (1 - k) + m * k)
                self.stored_var.copy_(self.stored_var * (1 - k) + var * k)
        scale = torch.rsqrt(var + self.eps) * self.gain
        shift = m * scale - self.bias
        return x * scale[:, None, None] - shift[:, None, None]

    def reset(self, gen):
        pass

    def load_flax(self, node):
        names = ["gain", "bias", "stored_mean", "stored_var"]
        if hasattr(self, "accumulation_counter"):
            names.append("accumulation_counter")
        for name in names:
            getattr(self, name).copy_(_t(node[name], getattr(self, name)))

    def to_flax(self):
        names = ["gain", "bias", "stored_mean", "stored_var"]
        if hasattr(self, "accumulation_counter"):
            names.append("accumulation_counter")
        return {name: _n(getattr(self, name)) for name in names}


class NoiseBN(FlaxNamed):
    """BigGAN noise-conditioned BN (layers.py:194-236): gain and bias
    predicted from a (B, 20) normal draw taken from `gen` on its own
    device (or the `noise` given), zero noise when noise_scale == 0 (gain
    1, bias 0).  The serving build keeps gain_kernel / bias_kernel already
    divided by their spectral norms; the trainable build keeps them raw
    with `u_gain`/`v_gain`, `u_bias`/`v_bias` and runs their power
    iterations in train mode even at zero noise, as the JAX layer does.
    The inner BN has momentum 0.9."""

    noise_sz = 20

    def __init__(self, c, spectral=True, trainable=False):
        super().__init__()
        self.spectral = spectral
        self.sn_state = spectral and trainable
        self.wg = nn.Parameter(torch.zeros(self.noise_sz, c), requires_grad=trainable)
        self.wb = nn.Parameter(torch.zeros(self.noise_sz, c), requires_grad=trainable)
        if self.sn_state:
            for kind in ("gain", "bias"):
                self.register_buffer(f"u_{kind}", torch.zeros(c))
                self.register_buffer(f"v_{kind}", torch.zeros(self.noise_sz))
        self.add("BatchNorm", BatchNorm(c, scale=False, bias=False,
                                        trainable=trainable))

    def forward(self, x, *, noise_scale: float = 1.0,
                gen: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        wg, wb = self.wg, self.wb
        if self.sn_state:
            wg = spectral_divide(self, wg, wg, "u_gain", "v_gain")
            wb = spectral_divide(self, wb, wb, "u_bias", "v_bias")
        h = self.BatchNorm_0(x)
        if noise is None:
            if noise_scale == 0.0:
                return h
            # drawn where the generator lives (a CPU generator gives a model
            # on the card the CPU's draws)
            dev = x.device if gen is None else gen.device
            noise = torch.randn((x.shape[0], self.noise_sz), generator=gen,
                                device=dev).to(x.device) * noise_scale
        gain = 1.0 + noise @ wg
        bias = noise @ wb
        return h * gain[:, :, None, None] + bias[:, :, None, None]

    def reset(self, gen):
        for p, kind in ((self.wg, "gain"), (self.wb, "bias")):
            w = torch.randn(p.shape, generator=gen) / np.sqrt(self.noise_sz)
            if self.sn_state:
                u = converged_u(w, gen)
                getattr(self, f"u_{kind}").copy_(u)
                getattr(self, f"v_{kind}").copy_(l2norm(w @ u))
            elif self.spectral:
                w = w / spectral_sigma(w, gen)
            p.copy_(w)

    def load_flax(self, node):
        for p, kind in ((self.wg, "gain"), (self.wb, "bias")):
            w = torch.tensor(np.asarray(node[f"{kind}_kernel"], np.float32))
            if self.sn_state:
                for name in (f"u_{kind}", f"v_{kind}"):
                    getattr(self, name).copy_(_t(node[name], getattr(self, name)))
            elif self.spectral:
                v = torch.tensor(np.asarray(node[f"v_{kind}"], np.float32))
                w = w / torch.linalg.vector_norm(w.T @ v)
            p.copy_(w)
        self.BatchNorm_0.load_flax(node["BatchNorm_0"])

    def to_flax(self):
        if self.spectral and not self.sn_state:
            raise ValueError("a serving NoiseBN keeps its kernels divided by "
                             "their spectral norms; only the trainer's build inverts")
        out = {"gain_kernel": _n(self.wg), "bias_kernel": _n(self.wb),
               "BatchNorm_0": self.BatchNorm_0.to_flax()}
        if self.sn_state:
            for name in SPECTRAL_NAMES[2:]:
                out[name] = _n(getattr(self, name))
        return out


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

    def __init__(self, in_c, features, resample=None, spectral=True,
                 trainable=False):
        super().__init__()
        self.resample = resample
        kw = dict(spectral=spectral, trainable=trainable)
        self.add("NoiseBN", NoiseBN(in_c, **kw))
        self.add("SNConv", Conv(in_c, features, 3, 1, 1, **kw))
        self.add("NoiseBN", NoiseBN(features, **kw))
        self.add("SNConv", Conv(features, features, 3, 1, 1, **kw))
        self.has_skip = bool(resample) or in_c != features
        if self.has_skip:
            self.add("SNConv", Conv(in_c, features, 1, 1, 0, **kw))

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
