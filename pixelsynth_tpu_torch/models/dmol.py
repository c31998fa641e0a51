"""Discretized mixture-of-logistics losses and samplers, NHWC (port of
pixelsynth_tpu/models/dmol.py; the reference's models/lmconv/utils.py
:78-236,422+): the PixelCNN++ output distribution for a prior over RGB
rather than VQ codes.  The 3-channel variant with channel
autoregression, the 1-channel one, and the 4- / 6-channel layouts.

Logit layout per mixture (3 channels, nr_mix K): [K logit probs, 3K means,
3K log scales, 3K coeffs] = 10K channels.  The samplers draw from a
torch.Generator, or take the draws given (the tests give JAX's)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _log_prob_from_cdf_delta(centered, inv_stdv, bin_half):
    plus = inv_stdv * (centered + bin_half)
    minus = inv_stdv * (centered - bin_half)
    cdf_delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    log_cdf_plus = plus - F.softplus(plus)            # the left edge's log cdf
    log_one_minus_cdf_minus = -F.softplus(minus)      # the right edge's log sf
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - 2.0 * F.softplus(mid_in)
    # a tiny bin falls back to the midpoint's pdf times the bin's width
    log_delta = torch.where(cdf_delta > 1e-5,
                            torch.log(torch.clamp(cdf_delta, min=1e-12)),
                            log_pdf_mid + math.log(2.0 * bin_half))
    return torch.where(centered < -0.999, log_cdf_plus,
                       torch.where(centered > 0.999, log_one_minus_cdf_minus, log_delta))


def discretized_mix_logistic_loss(x, logits, n_bits: int = 8, *, reduce_sum: bool = True):
    """x (B, H, W, 3) in [-1, 1]; logits (B, H, W, 10K) -> the negative
    log-likelihood, summed (dmol.py:44-73)."""
    B, H, W, C = x.shape
    if C != 3:
        raise ValueError(f"x has {C} channels; this loss takes 3")
    K = logits.shape[-1] // 10
    logit_probs = logits[..., :K]
    rest = logits[..., K:].reshape(B, H, W, 3, 3 * K)
    means = rest[..., :K]
    log_scales = torch.clamp(rest[..., K:2 * K], min=-7.0)
    coeffs = torch.tanh(rest[..., 2 * K:])
    xx = x[..., None]
    m0 = means[..., 0, :]
    m1 = means[..., 1, :] + coeffs[..., 0, :] * xx[..., 0, :]
    m2 = (means[..., 2, :] + coeffs[..., 1, :] * xx[..., 0, :]
          + coeffs[..., 2, :] * xx[..., 1, :])
    centered = xx - torch.stack([m0, m1, m2], 3)
    bin_half = 1.0 / (2.0 ** n_bits - 1)
    log_probs = _log_prob_from_cdf_delta(centered, torch.exp(-log_scales), bin_half)
    log_probs = log_probs.sum(3) + torch.log_softmax(logit_probs, -1)
    nll = -torch.logsumexp(log_probs, -1)
    return nll.sum() if reduce_sum else nll


def discretized_mix_logistic_loss_1d(x, logits, n_bits: int = 8):
    """The 1-channel variant (dmol.py:76-90): logits (B, H, W, 3K)."""
    K = logits.shape[-1] // 3
    logit_probs = logits[..., :K]
    means = logits[..., K:2 * K]
    log_scales = torch.clamp(logits[..., 2 * K:], min=-7.0)
    bin_half = 1.0 / (2.0 ** n_bits - 1)
    log_probs = _log_prob_from_cdf_delta(x - means, torch.exp(-log_scales), bin_half)
    log_probs = log_probs + torch.log_softmax(logit_probs, -1)
    return -torch.logsumexp(log_probs, -1).sum()


def _nd_layout(logits, n_channels):
    """The reference's 4- / 6-channel layouts (dmol.py:93-116): 4 channels
    13K = K logits + (4, 3K) [means, scales, coeffs]; 6 channels 31K = K
    logits + (6, 5K), the (6, 3K) coefficient block read as 16 rows."""
    B, H, W, L = logits.shape
    if n_channels == 4:
        K = L // 13
        rest = logits[..., K:].reshape(B, H, W, 4, 3 * K)
        coeffs = torch.tanh(rest[..., 2 * K:3 * K])
    elif n_channels == 6:
        K = L // 31
        rest = logits[..., K:].reshape(B, H, W, 6, 5 * K)
        coeffs = torch.tanh(rest[..., 2 * K:5 * K])
        coeffs = coeffs.reshape(-1)[:B * H * W * 16 * K].reshape(B, H, W, 16, K)
    else:
        raise ValueError(n_channels)
    log_scales = torch.clamp(rest[..., K:2 * K], min=-7.0)
    return logits[..., :K], rest[..., :K], log_scales, coeffs, K


# the coefficient rows each channel's mean reads (dmol.py:119-127): the
# reference's 16-row layout for 6 channels (row 3 unused), and for 4 its
# sampler's rows 1-3, which the JAX package takes for the loss too
_COEFF_SLOTS = {
    4: [[], [0], [1, 2], [1, 2, 3]],
    6: [[], [0], [1, 2], [4, 5, 6], [7, 8, 9, 10], [11, 12, 13, 14, 15]],
}


def _nd_ar_means(means, coeffs, x, n_channels):
    out = [means[..., 0, :]]
    for c in range(1, n_channels):
        m = means[..., c, :]
        for j, slot in enumerate(_COEFF_SLOTS[n_channels][c]):
            m = m + coeffs[..., slot, :] * x[..., j, :]
        out.append(m)
    return torch.stack(out, -2)


def discretized_mix_logistic_loss_nd(x, logits, n_bits: int = 8, *,
                                     reduce_sum: bool = True):
    """The 4- / 6-channel negative log-likelihood (dmol.py:142-160): x (B,
    H, W, 4 | 6) in [-1, 1], logits (B, H, W, 13K | 31K)."""
    C = x.shape[-1]
    logit_probs, means, log_scales, coeffs, _ = _nd_layout(logits, C)
    xx = x[..., None]
    centered = xx - _nd_ar_means(means, coeffs, xx, C)
    bin_half = 1.0 / (2.0 ** n_bits - 1)
    log_probs = _log_prob_from_cdf_delta(centered, torch.exp(-log_scales), bin_half)
    log_probs = log_probs.sum(-2) + torch.log_softmax(logit_probs, -1)
    nll = -torch.logsumexp(log_probs, -1)
    return nll.sum() if reduce_sum else nll


def _draws(gen, logit_probs, temperature, shape, mix, u):
    """The mixture index (categorical over logit_probs / temperature, by
    the Gumbel-max rule as jax.random.categorical) and the uniforms in
    [1e-5, 1 - 1e-5), from `gen` unless given."""
    if mix is None:
        g = torch.rand(logit_probs.shape, generator=gen, device=logit_probs.device)
        gumbel = -torch.log(-torch.log(g.clamp(min=torch.finfo(g.dtype).tiny)))
        mix = torch.argmax(logit_probs / temperature + gumbel, -1)
    if u is None:
        u = torch.rand(shape, generator=gen, device=logit_probs.device) * (1 - 2e-5) + 1e-5
    return torch.as_tensor(mix, device=logit_probs.device).long(), \
        torch.as_tensor(u, device=logit_probs.device, dtype=logit_probs.dtype)


def sample_from_discretized_mix_logistic_nd(logits, n_channels: int,
                                            temperature: float = 1.0,
                                            gen: Optional[torch.Generator] = None, *,
                                            mix=None, u=None):
    """Sample (B, H, W, 4 | 6) from the n-channel DMoL (dmol.py:163-185)."""
    logit_probs, means, log_scales, coeffs, K = _nd_layout(logits, n_channels)
    mix, u = _draws(gen, logit_probs, temperature, means.shape[:-1], mix, u)
    sel = F.one_hot(mix, K).to(logits.dtype)
    means = (means * sel[..., None, :]).sum(-1)
    log_scales = torch.clamp((log_scales * sel[..., None, :]).sum(-1), min=-7.0)
    coeffs = (coeffs * sel[..., None, :]).sum(-1)
    raw = means + torch.exp(log_scales) * temperature * (torch.log(u) - torch.log1p(-u))
    xs = [torch.clamp(raw[..., 0], -1, 1)]
    for c in range(1, n_channels):
        v = raw[..., c]
        for j, slot in enumerate(_COEFF_SLOTS[n_channels][c]):
            v = v + coeffs[..., slot] * xs[j]
        xs.append(torch.clamp(v, -1, 1))
    return torch.stack(xs, -1)


def sample_from_discretized_mix_logistic(logits, temperature: float = 1.0,
                                         gen: Optional[torch.Generator] = None, *,
                                         mix=None, u=None):
    """Sample (B, H, W, 3) in [-1, 1] from 10K-channel logits
    (dmol.py:188-207)."""
    B, H, W, _ = logits.shape
    K = logits.shape[-1] // 10
    logit_probs = logits[..., :K]
    mix, u = _draws(gen, logit_probs, temperature, (B, H, W, 3), mix, u)
    sel = F.one_hot(mix, K).to(logits.dtype)
    rest = logits[..., K:].reshape(B, H, W, 3, 3 * K)
    means = (rest[..., :K] * sel[..., None, :]).sum(-1)
    log_scales = torch.clamp((rest[..., K:2 * K] * sel[..., None, :]).sum(-1), min=-7.0)
    coeffs = torch.tanh((rest[..., 2 * K:] * sel[..., None, :]).sum(-1))
    x = means + torch.exp(log_scales) * temperature * (torch.log(u) - torch.log1p(-u))
    x0 = torch.clamp(x[..., 0], -1, 1)
    x1 = torch.clamp(x[..., 1] + coeffs[..., 0] * x0, -1, 1)
    x2 = torch.clamp(x[..., 2] + coeffs[..., 1] * x0 + coeffs[..., 2] * x1, -1, 1)
    return torch.stack([x0, x1, x2], -1)
