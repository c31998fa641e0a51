"""Evaluation metrics on [0, 1] images (port of the PSNR and SSIM entries
of pixelsynth_tpu/eval/metrics.py): PSNR clamped at 100, with an optional
visibility mask (evaluation/metrics.py:6-19, calc_errors_quality.py:71-83),
and SSIM.  PercSim, LPIPS and FID are not ported yet."""

from __future__ import annotations

import torch

from pixelsynth_tpu_torch.models.losses import ssim as _ssim


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
