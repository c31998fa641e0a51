"""Evaluation metrics on [0, 1] images (port of pixelsynth_tpu/eval/metrics.py):

  * PSNR clamped at 100, with an optional visibility mask
    (evaluation/metrics.py:6-19, calc_errors_quality.py:71-83), and SSIM;
  * PercSim: the cosine feature distance of a VGG16, AlexNet or SqueezeNet
    backbone with the LPIPS shift/scale normalisation
    (models/networks/pretrained_networks.py:11-93);
  * LPIPS over the VGG16 features, with or without the learned lin layers;
  * the FID machinery (activation statistics, Frechet distance), the
    Inception score and the tail rates PSNR>20 / PercSim<2.3 / SSIM>0.8
    (utils/calc_errors.py:104-283), in numpy.

The backbones are torch modules (NCHW) whose parameters carry torchvision's
state-dict names, so an npz of `vgg16.features`, `alexnet.features` or
`squeezenet1_1.features` loads by name.  They compute what the JAX
package's Flax modules compute, including where those differ from
torchvision: the SqueezeNet's first conv pads "SAME" (torchvision: no
padding) and its max pools round down (torchvision: ceil_mode=True).
PercSim and LPIPS take NHWC images (numpy or tensors) in [0, 1] and return
a (B,) float32 numpy array; their networks run on `device`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.losses import ssim as _ssim

# LPIPS input normalisation (pretrained_networks.py:45-46)
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr_clamped(pred01, gt01) -> torch.Tensor:
    """Per-image PSNR of (B, H, W, C) images, clamped at 100."""
    pred01, gt01 = _t(pred01), _t(gt01)
    B = pred01.shape[0]
    mse = ((pred01 - gt01) ** 2).reshape(B, -1).mean(1)
    return torch.clamp(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)), max=100.0)


def psnr_masked(pred01, gt01, mask) -> torch.Tensor:
    """Masked PSNR (evaluation/metrics.py PSNR with a mask): the MSE over
    visible pixels only.  mask (B, H, W), or (B, H, W, C) per channel."""
    pred01, gt01, mask = _t(pred01), _t(gt01), _t(mask)
    B = pred01.shape[0]
    m = mask.reshape(B, -1, 1) if mask.dim() == 3 else mask.reshape(B, -1, mask.shape[-1])
    diff = ((pred01 - gt01) ** 2).reshape(B, -1, pred01.shape[-1])
    mse = (diff * m).sum((1, 2)) / torch.clamp(m.expand(diff.shape).sum((1, 2)), min=1e-8)
    return torch.clamp(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)), max=100.0)


def ssim_metric(pred01, gt01) -> torch.Tensor:
    return _ssim(_t(pred01), _t(gt01))


# ---------------------------------------------------------------------------
# backbones (torchvision names, the JAX package's arithmetic)
# ---------------------------------------------------------------------------


class _Sliced(nn.Sequential):
    """A torchvision `features` Sequential cut into slices: forward returns
    the activation after each index in `ends`."""

    ends: Sequence[int] = ()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.ends:
                outs.append(x)
        return outs


class VGG16Features(_Sliced):
    """vgg16.features[:30], sliced at relu1_2, relu2_2, relu3_3, relu4_3 and
    relu5_3 (pretrained_networks.py:34-93)."""

    ends = (3, 8, 15, 22, 29)

    def __init__(self):
        layers, cin = [], 3
        for v in (64, 64, "P", 128, 128, "P", 256, 256, 256, "P",
                  512, 512, 512, "P", 512, 512, 512):
            if v == "P":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        super().__init__(*layers)


class AlexNetFeatures(_Sliced):
    """alexnet.features[:12], sliced at each ReLU (pretrained_networks.py
    :154-194)."""

    ends = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())


class Fire(nn.Module):
    """SqueezeNet fire module: 1x1 squeeze -> (1x1 | 3x3) expand, concat."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)),
                          torch.relu(self.expand3x3(s))], 1)


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad NCHW x as Flax's padding="SAME" does for a k x k window at
    `stride`: ceil(size / stride) outputs, the odd pixel of padding at the
    end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SqueezeNetFeatures(_Sliced):
    """squeezenet1_1.features in 7 slices (pretrained_networks.py:95-151),
    with the JAX package's conv0 "SAME" padding and floor max pools."""

    ends = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__(
            nn.Conv2d(3, 64, 3, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            Fire(64, 16, 64), Fire(128, 16, 64), nn.MaxPool2d(3, 2),
            Fire(128, 32, 128), Fire(256, 32, 128), nn.MaxPool2d(3, 2),
            Fire(256, 48, 192), Fire(384, 48, 192), Fire(384, 64, 256),
            Fire(512, 64, 256))

    def forward(self, x):
        return super().forward(same_pad(x, 3, 2))


PNET_NETS = {"vgg16": VGG16Features, "alex": AlexNetFeatures,
             "squeeze": SqueezeNetFeatures}


@torch.no_grad()
def init_random(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded random weights (smoke only): every conv weight
    N(0, 2 / fan_in), biases 0, BatchNorm the identity statistics."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * np.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


def load_state_dict_npz(module: nn.Module, npz_path: str) -> Dict[str, torch.Tensor]:
    """The entries of a torchvision-layout npz that `module` holds, by
    name: every parameter and buffer of the module must be there (a
    BatchNorm's `num_batches_tracked` counter may be missing); other
    entries (a classifier head, an aux branch) are ignored."""
    with np.load(npz_path) as raw:
        files = set(raw.files)
        out = {}
        for k, v in module.state_dict().items():
            if k in files:
                out[k] = torch.as_tensor(raw[k]).to(v.dtype).reshape(v.shape)
            elif k.endswith("num_batches_tracked"):
                out[k] = torch.zeros_like(v)
            else:
                raise KeyError(f"{npz_path} has no {k!r}")
    return out


def load_torch_vgg16(npz_path: str) -> Dict[str, torch.Tensor]:
    """torchvision vgg16.features npz ('<idx>.weight') -> VGG16Features
    state dict."""
    return load_state_dict_npz(VGG16Features(), npz_path)


def load_torch_alexnet(npz_path: str) -> Dict[str, torch.Tensor]:
    """torchvision alexnet.features npz -> AlexNetFeatures state dict."""
    return load_state_dict_npz(AlexNetFeatures(), npz_path)


def load_torch_squeezenet(npz_path: str) -> Dict[str, torch.Tensor]:
    """torchvision squeezenet1_1.features npz ('0.weight',
    '<i>.{squeeze,expand1x1,expand3x3}.weight') -> SqueezeNetFeatures
    state dict."""
    return load_state_dict_npz(SqueezeNetFeatures(), npz_path)


def build_net(module: nn.Module, state_dict: Optional[Dict], device,
              gen: Optional[torch.Generator]) -> nn.Module:
    """`module` loaded from `state_dict`, or from `gen` (seed 0 by
    default) without one; frozen, in eval mode, on `device`."""
    if state_dict is None:
        init_random(module, gen if gen is not None else torch.Generator().manual_seed(0))
    else:
        module.load_state_dict(state_dict)
    return module.to(device).eval().requires_grad_(False)


def _nchw(x, device) -> torch.Tensor:
    """NHWC [0, 1] numpy or tensor -> NCHW float32 on device."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32).to(device).permute(0, 3, 1, 2)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10)


class _FeatureDistance:
    def __init__(self, net: nn.Module, state_dict, device, gen):
        self.device = torch.device(device)
        self.net = build_net(net, state_dict, self.device, gen)
        self._shift = torch.as_tensor(LPIPS_SHIFT, device=self.device)[None, :, None, None]
        self._scale = torch.as_tensor(LPIPS_SCALE, device=self.device)[None, :, None, None]

    def features(self, img01) -> List[torch.Tensor]:
        return self.net((_nchw(img01, self.device) - self._shift) / self._scale)

    @torch.no_grad()
    def __call__(self, a01, b01) -> np.ndarray:
        total = 0.0
        for i, (x, y) in enumerate(zip(self.features(a01), self.features(b01))):
            total = total + self.slice_distance(i, _unit(x), _unit(y))
        return total.float().cpu().numpy()


class PercSim(_FeatureDistance):
    """Cosine feature distance summed over the backbone's slices
    (pretrained_networks.py:11-31 cos_sim + 72-93).  net: "vgg16" (the
    PercSim metric, utils/calc_errors.py) | "alex" | "squeeze" (PNet
    --pnet_type).  Without a state dict the weights are random from `gen`
    (seed 0 by default): smoke numbers, not the paper's."""

    def __init__(self, net: str = "vgg16", state_dict=None, *, device="cuda",
                 gen: Optional[torch.Generator] = None):
        super().__init__(PNET_NETS[net](), state_dict, device, gen)

    def slice_distance(self, i, xn, yn):
        return 1.0 - (xn * yn).sum(1).flatten(1).mean(1)


class LPIPS(_FeatureDistance):
    """Learned perceptual distance (utils/calc_errors.py:209-212): unit
    VGG16 features per channel, squared difference, the learned per-channel
    lin weights (`lin_weights`: five (C_l,) arrays, load_lpips_lin_weights)
    or, without them, the channel mean (a squared PercSim: smoke only),
    then the spatial mean, summed over the slices."""

    def __init__(self, state_dict=None, lin_weights=None, *, device="cuda",
                 gen: Optional[torch.Generator] = None):
        super().__init__(VGG16Features(), state_dict, device, gen)
        self.lin = (None if lin_weights is None else
                    [torch.as_tensor(np.asarray(w, np.float32), device=self.device
                                     ).reshape(1, -1, 1, 1) for w in lin_weights])

    def slice_distance(self, i, xn, yn):
        d2 = (xn - yn) ** 2
        d2 = d2 * self.lin[i] if self.lin is not None else d2 / d2.shape[1]
        return d2.sum(1).flatten(1).mean(1)


def load_lpips_lin_weights(npz_path: str) -> List[np.ndarray]:
    """lpips release lin layers exported as npz 'lin<i>.model.1.weight' or
    'lins.<i>.model.1.weight' (1x1 convs, (1, C, 1, 1)) -> five (C,)
    arrays."""
    out = []
    with np.load(npz_path) as raw:
        for i in range(5):
            for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if k in raw.files:
                    out.append(raw[k].reshape(-1))
                    break
    return out


# ---------------------------------------------------------------------------
# FID machinery, Inception score, tail rates (numpy)
# ---------------------------------------------------------------------------


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu, sigma)."""
    mu = features.mean(0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def fid_from_stats(mu1, sigma1, mu2, sigma2) -> float:
    """Frechet distance between two Gaussians (pytorch_fid semantics):
    |mu1 - mu2|^2 + tr(s1) + tr(s2) - 2 tr(sqrtm(s1 s2)).  The last trace
    is the sum of the square roots of the eigenvalues of s1 s2, taken from
    s1^(1/2) s2 s1^(1/2), which has the same eigenvalues and is symmetric
    positive semi-definite: two symmetric eigensolves, where scipy's
    `sqrtm` of the product (pytorch_fid's, and the JAX package's) takes
    minutes at Inception's 2048 dimensions on the CPU.  Rounding below zero
    is clipped, so singular covariances (fewer samples than dimensions)
    need no offset."""
    diff = mu1 - mu2
    s1 = torch.as_tensor(np.asarray(sigma1, np.float64))
    s2 = torch.as_tensor(np.asarray(sigma2, np.float64))
    w, v = torch.linalg.eigh(s1)
    root = (v * w.clamp(min=0.0).sqrt()) @ v.T
    m = root @ s2 @ root
    ev = torch.linalg.eigvalsh((m + m.T) / 2)
    tr_covmean = float(ev.clamp(min=0.0).sqrt().sum())
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """(N, C) class probabilities -> (mean, std) IS (utils/calc_errors.py)."""
    N = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * N // splits: (i + 1) * N // splits]
        if len(part) == 0:
            continue
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def tail_rates(psnrs: np.ndarray, percsims: np.ndarray, ssims: np.ndarray) -> Dict[str, float]:
    """Tail fractions (utils/calc_errors.py:268-276)."""
    return {
        "psnr_gt_20": float(np.mean(psnrs > 20.0)),
        "percsim_lt_2.3": float(np.mean(percsims < 2.3)),
        "ssim_gt_0.8": float(np.mean(ssims > 0.8)),
    }
