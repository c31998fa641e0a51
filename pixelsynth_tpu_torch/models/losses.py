"""Image metrics of the loss stack (port of pixelsynth_tpu/models/losses.py
`psnr` and `ssim`): the reference's PSNR and the gaussian-window SSIM
(models/losses/ssim.py semantics), NHWC.  The synthesis, perceptual and GAN
losses belong to training and are not ported yet."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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
