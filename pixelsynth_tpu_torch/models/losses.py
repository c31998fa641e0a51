"""The loss stack (port of pixelsynth_tpu/models/losses.py), NHWC:

  * `psnr` and the gaussian-window `ssim` (models/losses/ssim.py
    semantics), the reference's image metrics;
  * `VGG19Features` and the multiscale VGG L1 `perceptual_loss`
    (synthesis.py:85-104 of the reference);
  * `synthesis_loss`: the weighted "lambda_name" list with PSNR / SSIM in
    both the reference's [-1, 1] convention and the standard [0, 1] one;
  * the hinge GAN losses with feature matching and `discriminator_scores`
    (gan_loss.py:81-285 of the reference).

The VGG19 is a frozen input of the trainer: random-init from a seed, or a
Flax `vgg` tree through the weight bridge.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.models.layers import Conv, FlaxNamed


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Reference PSNR (synthesis.py:60-66): MSE summed over channels,
    averaged over pixels, per image, then 10*log10(1/mse) averaged."""
    B = pred.shape[0]
    mse = ((pred - gt) ** 2).sum(-1).reshape(B, -1).mean(1)
    return (10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-10))).mean()


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM of NHWC images, zero 'same' padding, one window
    per channel, C1/C2 = 0.01^2/0.03^2; the mean over every position and
    channel, as float32.  The variance terms are small differences of
    large moments, so the window sums decide the result: the TPU's
    default conv precision pushed SSIM outside [-1, 1] on real images, and
    the JAX package's float32 sums sit up to ~1e-5 from the float64 value
    on the relay's views.  Here the moments and the map are taken in
    float64 (no TF32 or reduced-precision path exists for it)."""
    C = pred.shape[-1]
    pred = torch.as_tensor(pred).float().double().permute(0, 3, 1, 2)
    gt = torch.as_tensor(gt).float().double().permute(0, 3, 1, 2)
    w = torch.as_tensor(_gaussian_window(window_size, 1.5), device=pred.device)
    kernel = w.double()[None, None].repeat(C, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=C)

    mu1, mu2 = filt(pred), filt(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(pred * pred) - mu1_sq
    s2 = filt(gt * gt) - mu2_sq
    s12 = filt(pred * gt) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean().float()


# torchvision vgg19.features per slice: conv widths and "P" for a 2x2 max
# pool (slice1: conv1_1; slice2: conv1_2, pool, conv2_1; ... slice5:
# conv4_2..conv4_4, pool, conv5_1)
VGG_SLICES: Sequence[Sequence] = (
    (64,),
    (64, "P", 128),
    (128, "P", 256),
    (256, 256, 256, "P", 512),
    (512, 512, 512, "P", 512),
)


class VGG19Features(FlaxNamed):
    """The 5 relu slices of the SPADE-style perceptual loss (losses.py
    :43-60): Flax nn.Conv(3x3, padding 1) + relu, 2x2 max pools.  NHWC in,
    a list of five NHWC feature maps out."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.slices: List[List] = []
        cin = in_channels
        for ops in VGG_SLICES:
            layers = []
            for op in ops:
                if op == "P":
                    layers.append("P")
                else:
                    layers.append(self.add("Conv", Conv(cin, op, 3, 1, 1)))
                    cin = op
            self.slices.append(layers)

    def forward(self, x) -> List[torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        outs = []
        for layers in self.slices:
            for layer in layers:
                h = F.max_pool2d(h, 2, 2) if layer == "P" else torch.relu(layer(h))
            outs.append(h.permute(0, 2, 3, 1))
        return outs


def load_torch_vgg19(npz_path: str) -> Dict:
    """torchvision vgg19.features weights saved as an npz of
    '<idx>.weight' / '<idx>.bias' OIHW arrays -> the `vgg` variables tree
    ({"params": {"Conv_<i>": {kernel (HWIO), bias}}}, numpy) that
    `VGG19Features.load_flax(weights.merge_collections(tree))` loads, as
    the JAX package's loader returns it."""
    with np.load(npz_path) as raw:
        conv_ids = sorted(int(k.split(".")[0]) for k in raw.files if k.endswith(".weight"))
        return {"params": {f"Conv_{i}": {"kernel": raw[f"{cid}.weight"].transpose(2, 3, 1, 0),
                                         "bias": raw[f"{cid}.bias"]}
                           for i, cid in enumerate(conv_ids)}}


PERCEPTUAL_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def perceptual_loss(vgg, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Multiscale VGG L1 (losses.py:145-153); the target's features carry
    no gradient."""
    pf = vgg(pred)
    with torch.no_grad():
        gf = vgg(gt)
    loss = 0.0
    for w, p, g in zip(PERCEPTUAL_WEIGHTS, pf, gf):
        loss = loss + w * (p - g).abs().mean()
    return loss


def synthesis_loss(pred: torch.Tensor, gt: torch.Tensor, *,
                   losses: Sequence[str] = ("1.0_l1", "10.0_content"),
                   vgg=None) -> Dict[str, torch.Tensor]:
    """Weighted loss list "lambda_name" -> dict with "Total Loss" and the
    metrics (losses.py:155-199): "psnr" and "ssim" in the reference's
    [-1, 1] convention, "psnr_std" and "ssim_std" on [0, 1] images.  The
    metrics are taken without a gradient (they are no part of the total)."""
    out: Dict[str, torch.Tensor] = {}
    total = 0.0
    for spec in losses:
        lam_s, name = spec.split("_", 1)
        if name == "l1":
            v = (pred - gt).abs().mean()
            out["L1"] = v
        elif name == "content":
            if vgg is None:
                continue
            v = perceptual_loss(vgg, pred, gt)
            out["Perceptual"] = v
        else:
            raise ValueError(f"unknown loss {name}")
        total = total + float(lam_s) * v
    with torch.no_grad():
        p, g = pred.detach(), gt.detach()
        out["psnr"] = psnr(p, g)
        p01, g01 = p * 0.5 + 0.5, g * 0.5 + 0.5
        mse01 = torch.clamp(((p01 - g01) ** 2).mean(), min=1e-10)
        out["psnr_std"] = 10.0 * torch.log10(1.0 / mse01)
        out["ssim"] = ssim(p, g)
        out["ssim_std"] = ssim(p01, g01)
    out["Total Loss"] = total
    return out


def hinge_d_loss(pred_fake, pred_real) -> Dict[str, torch.Tensor]:
    """Discriminator hinge loss on each scale's final map, averaged over
    the scales (losses.py:206-216)."""
    d_fake = torch.stack([torch.relu(1.0 + f[-1]).mean() for f in pred_fake]).mean()
    d_real = torch.stack([torch.relu(1.0 - r[-1]).mean() for r in pred_real]).mean()
    return {"D_Fake": d_fake, "D_real": d_real, "Total Loss": d_fake + d_real}


def hinge_g_loss(pred_fake, pred_real, *, lambda_feat: float = 10.0,
                 feat_match: bool = True) -> Dict[str, torch.Tensor]:
    """Generator hinge plus feature matching against the detached real
    features (losses.py:219-236)."""
    gan = torch.stack([-f[-1].mean() for f in pred_fake]).mean()
    out = {"GAN": gan}
    total = gan
    if feat_match:
        num_D = len(pred_fake)
        fm = 0.0
        for pf, pr in zip(pred_fake, pred_real):
            for f, r in zip(pf[:-1], pr[:-1]):
                fm = fm + (f - r.detach()).abs().mean() * (lambda_feat / num_D)
        out["GAN_Feat"] = fm
        total = total + fm
    out["Total Loss"] = total
    return out


def discriminator_scores(disc, fake, real):
    """D on the fake || real batch, split per scale and layer (losses.py
    :239-247: one shared batch)."""
    preds = disc(torch.cat([fake, real], 0))
    half = fake.shape[0]
    return ([[t[:half] for t in scale] for scale in preds],
            [[t[half:] for t in scale] for scale in preds])
