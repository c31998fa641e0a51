"""InceptionV3 pool3 features for FID (port of pixelsynth_tpu/eval/inception.py).

The reference shells out to `python -m pytorch_fid`
(calc_errors_quality.py:135), which scores the Frechet distance of
InceptionV3 pool3 (2048-d) activations.  This is the torchvision
inception_v3 topology without the aux head, with torchvision's module
names, so a torchvision / pytorch_fid state dict exported as npz loads by
name (`load_torch_inception`; BatchNorm running statistics are buffers).

It computes what the JAX package's Flax network computes: BatchNorm eps
1e-3 on the running statistics, every 3x3 average pool without the padding
in its divisor (pytorch_fid's FIDInception blocks), and with
`fid_variant=True` a max pool in Mixed_7c's pool branch.  The modules are
NCHW; `preprocess_for_inception` takes NHWC [0, 1] images like the JAX
function and resizes with jax.image.resize's "bilinear" weights
(half-pixel centres, antialiased when shrinking).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixelsynth_tpu_torch.eval.metrics import build_net, load_state_dict_npz


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's "bilinear" along one
    axis (jax/_src/image/scale.py compute_weight_mat): the triangle kernel
    at half-pixel sample positions, widened by the scale when shrinking
    (antialiasing), normalised per output.  It keeps the float32 arithmetic
    of that function as XLA compiles it: float32 constants 1/scale and
    1/kernel_scale, and the sample positions and the kernel's argument each
    rounded once from a fused multiply-add.  Rounded otherwise (as
    F.interpolate(antialias=True) rounds them), the positions near 300 move
    by an ulp and the weights by ~1e-5."""
    f32 = torch.float32
    scale = n_out / n_in
    inv = float(torch.tensor(1.0 / scale, dtype=f32))
    rks = float(1.0 / torch.tensor(max(1.0 / scale, 1.0), dtype=f32))
    sample = ((torch.arange(n_out, dtype=f32) + 0.5).double() * inv - 0.5).float()
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    w = torch.clamp((1.0 - x.double() * rks).float(), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def preprocess_for_inception(img01) -> torch.Tensor:
    """[0, 1] NHWC -> (B, 299, 299, 3) in [-1, 1] (pytorch_fid's resize
    and scaling), on the input's device."""
    x = torch.as_tensor(img01 if torch.is_tensor(img01) else np.asarray(img01),
                        dtype=torch.float32)
    H, W = x.shape[1], x.shape[2]
    if H != 299:
        x = torch.einsum("bhwc,hk->bkwc", x, _resize_weights(H, 299, x.device))
    if W != 299:
        x = torch.einsum("bhwc,wk->bhkc", x, _resize_weights(W, 299, x.device))
    return x * 2.0 - 1.0


class BasicConv(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> relu."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def _avg3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max3s2(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max3s2(x)], 1)


class InceptionE(nn.Module):
    """pool "avg", or "max" (pytorch_fid's last E block)."""

    def __init__(self, cin, pool="avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3Features(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, 2048) pool3 activations."""

    def __init__(self, fid_variant: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid_variant else "avg")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max3s2(x)))
        x = _max3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))


def load_torch_inception(npz_path: str) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch_fid inception state dict exported as npz ->
    InceptionV3Features state dict (conv weights, BatchNorm weight, bias,
    running_mean and running_var; the aux head and fc are left out)."""
    return load_state_dict_npz(InceptionV3Features(), npz_path)


def make_fid_feature_fn(state_dict: Optional[Dict] = None, *, device="cuda",
                        gen: Optional[torch.Generator] = None,
                        batch: int = 16) -> Callable[[np.ndarray], np.ndarray]:
    """Feature function for eval.calc_errors.calc_errors_quality: NHWC
    [0, 1] images -> (B, 2048) float32 numpy activations, computed on
    `device` `batch` images at a time.  Without a state dict the weights
    are random from `gen` (seed 0 by default): smoke only."""
    net = build_net(InceptionV3Features(), state_dict, device, gen)

    @torch.no_grad()
    def fn(img01) -> np.ndarray:
        x = torch.as_tensor(img01 if torch.is_tensor(img01) else np.asarray(img01),
                            dtype=torch.float32)
        outs = []
        for i in range(0, x.shape[0], batch):
            chunk = preprocess_for_inception(x[i:i + batch].to(device))
            outs.append(net(chunk.permute(0, 3, 1, 2)).float().cpu())
        return torch.cat(outs).numpy()

    return fn
