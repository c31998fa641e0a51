"""K2 at C > 8 as csrc/splat_blend.cu's `blend_wide_kernel` computes it,
emulated on the CPU: each warp's 4 x 8 pixel rectangle walks the tile's
slots once, in chunks of 128 staged slots, keeping the slots that pass the
conservative culling test (the point's distance to the rectangle, squared,
within r^2 (1 + 1e-6)); each culled slot's weight for the warp's 32 pixels
goes into a weight tile of 16 slots, and each full tile (and a chunk's
last, padded with zero weights) is one product on the tensor cores,
summed in f32:
  * the bf16 entry: the weight and the features rounded to bf16 (nearest
    even), whose products are exact in f32;
  * the f32 entry: the three-product split on tf32, x = hi + lo, each part
    rounded to 10 mantissa bits (nearest, ties away from zero, as
    `cvt.rna.tf32.f32`), lo*hi + hi*lo + hi*hi.
The emulation is held to K2's plain version and to the JAX package's splat
on the same numpy-seeded inputs (W = 32, 2 images x 600 points, so a
tile's list spans two chunks), at C = 9, 24 and 64, in every accumulation:
the f32 entry to 1e-5 of the image's scale (`chip_smoke.py`
`k2_wide_check`'s bar on the card), the bf16 entry to the bars of
tests/test_torch_splat_bf16.py (1e-2 of the scale at most, 1e-6 of it on
average); the coverage bit for bit.  The split alone (tf32 without it
misses 1e-5) is checked beside."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.config import SplatConfig as JaxSplatConfig
from pixelsynth_tpu.ops.splat import splat as jax_splat
from pixelsynth_tpu_torch.config import SplatConfig
from pixelsynth_tpu_torch.ops import splat as K2
from torch_threads import _few_torch_threads  # noqa: F401

W = 32
CHANNELS = (9, 24, 64)
ACCUMULATIONS = ["alphacomposite", "wsum", "wsumnorm"]
CH, KT, RH, RW = 128, 16, 4, 8   # the kernel's chunk, weight tile and rectangle


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32 on the sign-magnitude bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 entry's three tf32 products, summed in f32 in the
    kernel's order (the small terms first)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _inputs(C, B=2, N=600, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, W + 5, (B, N)), rng.uniform(-6, W + 5, (B, N)),
                    rng.uniform(0.5, 10.0, (B, N))], -1).astype(np.float32)
    feats = rng.standard_normal((B, N, max(CHANNELS))).astype(np.float32)[..., :C]
    valid = rng.random((B, N)) < 0.9
    return pts, np.ascontiguousarray(feats), valid


def _cfg(accumulation, blend_dtype):
    kw = dict(max_points_per_tile=256, tile_size=16, tile_group=4,
              accumulation=accumulation, blend_dtype=blend_dtype)
    return SplatConfig(**kw), JaxSplatConfig(**kw)


def emulate_wide(points, feats, slot_idx, slot_valid, W, cfg):
    """K2's wide body on the CPU -> (out (B, W, W, C), covered (B, W, W))."""
    bf16 = cfg.blend_dtype == "bfloat16"
    B, nT, M = slot_idx.shape
    C = feats.shape[-1]
    TS, nside = cfg.tile_size, W // cfg.tile_size
    f32 = np.float32
    r2 = f32(cfg.radius * cfg.radius)
    r2_cull = f32(r2 * f32(f32(1) + f32(1e-6)))
    ss, denom = K2._alpha_consts(W, cfg)
    dscale = torch.tensor(ss / denom, dtype=torch.float32)
    fts = K2.round_bf16(feats) if bf16 else feats
    out = torch.zeros((B, W, W, C))
    cov = torch.zeros((B, W, W), dtype=torch.bool)
    lane = torch.arange(32)
    for b in range(B):
        for t in range(nT):
            v = slot_valid[b, t]
            n = int(torch.nonzero(v).max()) + 1 if bool(v.any()) else 0
            xy = torch.where(v[:n, None], points[b, slot_idx[b, t, :n], :2],
                             torch.tensor(3.0e30))
            for rect in range((TS // RH) * (TS // RW)):
                row0 = (t // nside) * TS + (rect // (TS // RW)) * RH
                col0 = (t % nside) * TS + (rect % (TS // RW)) * RW
                ex = torch.clamp(torch.maximum(col0 - xy[:, 0], xy[:, 0] - (col0 + RW - 1)), min=0)
                ey = torch.clamp(torch.maximum(row0 - xy[:, 1], xy[:, 1] - (row0 + RH - 1)), min=0)
                cull = torch.nonzero(ex * ex + ey * ey <= float(r2_cull)).flatten()
                rows = (row0 + lane // RW).float()
                cols = (col0 + lane % RW).float()
                dx = cols[:, None] - xy[cull, 0][None]
                dy = rows[:, None] - xy[cull, 1][None]
                d2 = dx * dx + dy * dy                              # (32, L) unfused
                cover = d2 < float(r2)
                keep = cover & (torch.cumsum(cover.int(), 1) <= cfg.pp_pixel)
                d = torch.clamp(d2 * dscale, 1e-3, 1.0)
                alpha = (1.0 - torch.sqrt(d)) ** cfg.tau * keep
                if cfg.accumulation == "alphacomposite":
                    trans = torch.cumprod(1.0 - alpha, 1)
                    w = alpha * torch.cat([torch.ones((32, 1)), trans[:, :-1]], 1)
                elif bf16 and cfg.accumulation == "wsumnorm":   # the f64 sum, walked first
                    total = alpha.sum(1, keepdim=True, dtype=torch.float64).float()
                    w = alpha / torch.clamp(total, min=1e-4)
                else:
                    w = alpha
                if bf16:
                    w = K2.round_bf16(w)
                acc = torch.zeros((32, C))
                f = fts[b, slot_idx[b, t, cull]]
                chunk = cull // CH
                for c in torch.unique(chunk).tolist():
                    pos = torch.nonzero(chunk == c).flatten()
                    for k0 in range(0, pos.numel(), KT):   # a weight tile, zero-padded
                        sel = pos[k0:k0 + KT]
                        a = torch.zeros((32, KT))
                        bm = torch.zeros((KT, C))
                        a[:, :sel.numel()] = w[:, sel]
                        bm[:sel.numel()] = f[sel]
                        acc = acc + (a @ bm if bf16 else split_product(a, bm))
                if cfg.accumulation == "wsumnorm" and not bf16:
                    acc = acc * (1.0 / torch.clamp(torch.cumsum(alpha, 1)[:, -1:]
                                                   if alpha.shape[1] else torch.zeros((32, 1)),
                                                   min=1e-4))
                rr, cc = rows.long(), cols.long()
                out[b, rr, cc] = acc
                cov[b, rr, cc] = cover.any(1)
    return out, cov


@functools.lru_cache(maxsize=None)
def _jax_images(accumulation, blend_dtype):
    """The JAX package's splat of the three widths' features at once (each
    channel is its own column of the product)."""
    pts, feats, valid = _inputs(max(CHANNELS))
    _, jcfg = _cfg(accumulation, blend_dtype)
    img, _ = jax_splat(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(valid), W=W,
                       cfg=jcfg)
    return np.asarray(img)


@pytest.mark.parametrize("blend_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accumulation", ACCUMULATIONS)
@pytest.mark.parametrize("C", CHANNELS)
def test_wide_formulation_matches_plain_and_jax(C, accumulation, blend_dtype):
    pts, feats, valid = _inputs(C)
    cfg, _ = _cfg(accumulation, blend_dtype)
    p, f, v = torch.as_tensor(pts), torch.as_tensor(feats), torch.as_tensor(valid)
    slot_idx, slot_valid = K2._bin_points_batched(p, v, W, cfg)
    assert int(slot_valid.sum(-1).max()) > CH   # a list spans two chunks
    got, cov = emulate_wide(p, f, slot_idx, slot_valid, W, cfg)
    plain, pcov = K2.blend_slots_plain(p, f, slot_idx, slot_valid, W, cfg)
    jax_img = _jax_images(accumulation, blend_dtype)[..., :C]
    assert torch.equal(cov, pcov) and bool(cov.any())
    for want in (plain.numpy(), jax_img):
        err = np.abs(got.numpy() - want)
        scale = float(np.abs(want).max())
        if blend_dtype == "float32":
            assert err.max() <= 1e-5 * scale, (err.max(), scale)
        else:
            assert err.max() <= 1e-2 * scale, (err.max(), scale)
            assert err.mean() <= 1e-6 * scale, (err.mean(), scale)


def test_tf32_split_is_needed_and_enough():
    """The f32 entry's product: tf32 alone keeps ~3 digits and misses 1e-5
    of scale; the three-product split is within it of the f32 product."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.random((32, KT)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((KT, 64)).astype(np.float32))
    want = (a.double() @ b.double())
    scale = float(want.abs().max())
    one = (tf32_rna(a) @ tf32_rna(b)).double()
    three = split_product(a, b).double()
    assert float((one - want).abs().max()) > 1e-5 * scale
    assert float((three - want).abs().max()) <= 1e-6 * scale
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10)]
