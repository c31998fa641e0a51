"""Soft z-buffer point splatter (port of pixelsynth_tpu/ops/splat.py) with
kernel K2 for the blend and kernel K5 for the binning sort.

  1. Bin: each point's radius-r footprint overlaps <= 4 image tiles; a
     fixed-capacity gather yields every tile's z-sorted slot list.
     `_bin_dispatch` picks the binner as the JAX package does:
       * `binning="argsort"`, `sort_backend="xla"` (the defaults): the whole
         batch's (image, tile, depth-bucket) keys, packed into 31 bits, go
         through ONE stable library sort, segment offsets from a binary
         search (`_bin_points_batched`, bit-equal to the JAX binning);
       * `sort_backend="pallas"`: per-image (tile, depth-bucket) keys
         sorted by kernel K5 (`_bin_points_batched_pallas`), while an
         image's 4N entries fit the kernel (<= 2^19); above that the
         whole-batch sort runs, as in the JAX package;
       * `binning="counting"`: a scatter into (tile, entry-rank) slots and
         an exact-f32 per-tile depth sort (`_bin_points_counting`).
  2. Blend (K2): per tile, radius coverage, the K-nearest-in-z cap,
     alpha = (1 - sqrt(clip(d, 1e-3, 1)))^tau and alphacomposite / wsum /
     wsumnorm accumulation, plus the coverage map (`blend_slots`: on the
     card the CUDA kernel of csrc/splat_blend.cu, which reads the binner's
     slot tables and gathers the points itself; on the CPU its plain
     version, `gather_slots` then `blend_tiles_plain` = `_blend_tiles`).
  3. The background mask is the dilated (max-filtered) uncovered map.

`blend_dtype="bfloat16"` (splat.py:438-441,480-481): the features are
rounded to bf16 once, before the per-tile gathers, and each slot's weight
(alpha x exclusive transmittance, alpha, or alpha / sum alpha) is rounded
to bf16 before the contraction, whose sums stay f32 (a bf16 x bf16
product is exact in f32).  Alpha, z and coverage stay f32, so the
background mask is the f32 blend's bit for bit.  On the card K2's bf16
entry (`splat_blend_bf16`) reads the bf16 rows; the plain version rounds
with `.to(torch.bfloat16)` where the JAX package casts.

Under a gradient (`blend_slots` with points or feats that require grad)
the blend is `_SplatBlendFn`, after the JAX package's `splat_pallas`
(ops/splat_pallas.py:193-251): the forward is the same K2 launch, the
backward the VJP of the plain blend with respect to points and feats
(`blend_slots_vjp`), recomputed one group of `tile_group` tiles at a time
so that no more than one group's intermediates live at once (at W=256,
batch 12 and M=1024 autograd through `blend_tiles_plain` would keep
~30 GB).  The binning takes no gradient (its outputs are integers), and
the background mask has no cotangent.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.config import SplatConfig
from pixelsynth_tpu_torch.ops import _cuda

LAUNCHES = {"splat_blend": 0, "splat_blend_bf16": 0}
PLAIN_CALLS = {"splat_blend": 0}   # calls that took the plain version (CPU)
_ACCUM = {"alphacomposite": 0, "wsum": 1, "wsumnorm": 2}
BLEND_DTYPES = ("float32", "bfloat16")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), kept in x's dtype: JAX's
    `astype(bfloat16)` followed by the f32 contraction's widening.  Under
    autograd the gradient is rounded to bf16 too, as `jax.grad` through
    the cast computes it."""
    return x.to(torch.bfloat16).to(x.dtype)


def _alpha_consts(W: int, cfg: SplatConfig) -> Tuple[float, float]:
    """(scale s*s, radius_ndc**rad_pow) of the NDC alpha (splat.py:52-64)."""
    s = 2.0 / W
    return s * s, (cfg.radius * s) ** cfg.rad_pow


def _alpha_from_dist2(dist2_px, W: int, cfg: SplatConfig):
    ss, denom = _alpha_consts(W, cfg)
    d = torch.clamp(dist2_px * ss / denom, 1e-3, 1.0)
    return (1.0 - torch.sqrt(d)) ** cfg.tau


def dilate_mask(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Binary dilation with a ksize x ksize window; (B, H, W) -> bool."""
    pad = ksize // 2
    out = F.max_pool2d(mask.float()[:, None], ksize, 1, pad)
    return out[:, 0] > 0


def _tile_entries(points, valid, W: int, cfg: SplatConfig):
    """(B, N, 3), (B, N) -> tile_id (B, 4, N) int32 (nT where masked),
    emask (B, 4, N), on_screen (B, N)."""
    TS = cfg.tile_size
    nside = W // TS
    nT = nside * nside
    r = cfg.radius
    col, row, depth = points[..., 0], points[..., 1], points[..., 2]
    on_screen = (valid & (col >= -r) & (col <= W - 1 + r) & (row >= -r)
                 & (row <= W - 1 + r) & (depth > 0))
    tx0 = torch.floor((col - r) / TS).to(torch.int32)
    tx1 = torch.floor((col + r) / TS).to(torch.int32)
    ty0 = torch.floor((row - r) / TS).to(torch.int32)
    ty1 = torch.floor((row + r) / TS).to(torch.int32)
    txs = torch.stack([tx0, tx1, tx0, tx1], 1)
    tys = torch.stack([ty0, ty0, ty1, ty1], 1)
    dup = torch.stack([torch.ones_like(on_screen), tx1 != tx0, ty1 != ty0,
                       (tx1 != tx0) & (ty1 != ty0)], 1)
    in_rng = (txs >= 0) & (txs < nside) & (tys >= 0) & (tys < nside)
    emask = dup & in_rng & on_screen[:, None, :]
    tile_id = torch.where(emask, tys * nside + txs,
                          torch.full_like(txs, nT)).to(torch.int32)
    return tile_id, emask, on_screen


def _bin_points_batched(points, valid, W: int, cfg: SplatConfig,
                        return_counts: bool = False):
    """Whole-batch binning with one stable sort of packed 31-bit keys.

    points (B, N, 3) [col, row, depth]; valid (B, N) bool.  Returns
    (slot_point_idx (B, nT, M) int64, slot_valid (B, nT, M) bool)
    [, entries per tile (B, nT) when return_counts]."""
    B, N, _ = points.shape
    nside = W // cfg.tile_size
    nT = nside * nside
    M = cfg.max_points_per_tile
    dev = points.device
    tile_id, emask, on_screen = _tile_entries(points, valid, W, cfg)

    seg_bits = max(1, (B * (nT + 1) - 1).bit_length())
    bucket_bits = min(16, 31 - seg_bits)
    bucket = _depth_buckets(points, on_screen, bucket_bits)

    img = torch.arange(B, dtype=torch.int32, device=dev)[:, None, None]
    seg = img * (nT + 1) + tile_id
    key = (seg << bucket_bits) + bucket[:, None, :]
    point_idx = torch.arange(N, device=dev).expand(B, 4, N)
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    sorted_point = point_idx.reshape(-1)[perm]
    sorted_seg = sorted_key >> bucket_bits

    want_seg = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * (nT + 1)
                + torch.arange(nT, dtype=torch.int32, device=dev)[None])
    offsets = torch.searchsorted(sorted_key, want_seg.reshape(-1) << bucket_bits)
    offsets = offsets.reshape(B, nT)
    E = B * 4 * N
    slot = torch.clamp(offsets[..., None] + torch.arange(M, device=dev), 0, E - 1)
    slot_point_idx = sorted_point[slot]
    slot_valid = sorted_seg[slot] == want_seg[..., None]
    if not return_counts:
        return slot_point_idx, slot_valid
    ends = torch.searchsorted(sorted_key, (want_seg.reshape(-1) + 1) << bucket_bits)
    return slot_point_idx, slot_valid, ends.reshape(B, nT) - offsets


def _depth_buckets(points, on_screen, bucket_bits: int):
    """Per-image depth bucket in [0, 2^bucket_bits) over the on-screen
    depth range, front to back.  -> (B, N) int32."""
    n_buckets = 1 << bucket_bits
    depth = points[..., 2]
    big = torch.tensor(3.0e38, dtype=torch.float32, device=points.device)
    dmin = torch.where(on_screen, depth, big).amin(1)
    dmax = torch.where(on_screen, depth, -big).amax(1)
    scale = (n_buckets - 1) / torch.clamp(dmax - dmin, min=1e-6)
    return torch.clamp((depth - dmin[:, None]) * scale[:, None], 0,
                       n_buckets - 1).to(torch.int32)


def _image_sort_keys(points, valid, W: int, cfg: SplatConfig):
    """Per-image binning keys for kernel K5: (tile << bucket_bits) + depth
    bucket for each of a point's 4 candidate entries ((4, N) flattening),
    the sentinel `nT << bucket_bits` for masked entries and for the
    padding up to E_pad = 2^max(14, ceil(log2(4N))).
    -> (key (B, E_pad) int32, bucket_bits)."""
    B, N, _ = points.shape
    nside = W // cfg.tile_size
    nT = nside * nside
    tile_id, emask, on_screen = _tile_entries(points, valid, W, cfg)
    # segment values span 0..nT (tiles + the masked segment nT)
    seg_bits = nT.bit_length()
    bucket_bits = min(16, 31 - seg_bits)
    bucket = _depth_buckets(points, on_screen, bucket_bits)
    sentinel = nT << bucket_bits
    key = (tile_id << bucket_bits) + bucket[:, None, :]
    key = torch.where(emask, key, torch.full_like(key, sentinel))
    key = key.reshape(B, 4 * N)
    E = 4 * N
    E_pad = 1 << max(14, (E - 1).bit_length())
    # padding entries sort behind every real tile segment and fail the
    # seg-equality slot check
    if E_pad > E:
        key = F.pad(key, (0, E_pad - E), value=sentinel)
    return key.contiguous(), bucket_bits


def _bin_points_batched_pallas(points, valid, W: int, cfg: SplatConfig):
    """Same contract as `_bin_points_batched`, with each image's entries
    sorted by kernel K5 (ops/sort_kernel.py) instead of one library sort
    over the batch.  The output is identical whenever the whole-batch key
    also had 16 depth-bucket bits (B * (nT + 1) <= 2^15); for larger
    batches the per-image key keeps finer z buckets.

    Tile segments never cross images, so each image's 4N entries sort
    independently.  The kernel carries the entry index, which gives the
    point as `entry % N` and the stable sort's tie order."""
    from pixelsynth_tpu_torch.ops.sort_kernel import sort_kv_kernel

    B, N, _ = points.shape
    nside = W // cfg.tile_size
    nT = nside * nside
    M = cfg.max_points_per_tile
    dev = points.device
    key, bucket_bits = _image_sort_keys(points, valid, W, cfg)
    E_pad = key.shape[1]

    sorted_key, sorted_entry = sort_kv_kernel(key)
    sorted_point = (sorted_entry % N).long()
    sorted_seg = sorted_key >> bucket_bits

    want_tile = torch.arange(nT, dtype=torch.int32, device=dev).expand(B, nT)
    offsets = torch.searchsorted(sorted_key, (want_tile << bucket_bits).contiguous())
    slot = torch.clamp(offsets[..., None] + torch.arange(M, device=dev), 0,
                       E_pad - 1).reshape(B, nT * M)
    slot_point_idx = torch.gather(sorted_point, 1, slot).reshape(B, nT, M)
    slot_valid = (torch.gather(sorted_seg, 1, slot).reshape(B, nT, M)
                  == want_tile[..., None])
    return slot_point_idx, slot_valid


def _bin_points_counting(points, valid, W: int, cfg: SplatConfig):
    """Counting-sort binning of ONE image: no global sort over fused keys.

    points (N, 3); valid (N,).  1. every entry's rank within its tile, in
    entry order; 2. one scatter with unique slot indices places entry
    (tile, rank) while rank < M, so an overfull tile keeps its first M
    entries in entry order; 3. a stable sort of exact f32 depths within
    each tile gives the front-to-back order (entries are in point-index
    order, so ties keep depth-then-index order).  Same contract as
    `_bin_points_batched` for one image: (nT, M) int64, (nT, M) bool."""
    N = points.shape[0]
    nside = W // cfg.tile_size
    nT = nside * nside
    M = cfg.max_points_per_tile
    dev = points.device
    tile_id, _, _ = _tile_entries(points[None], valid[None], W, cfg)
    tid = tile_id.reshape(-1).long()                 # (E,), nT = masked
    E = tid.shape[0]
    point_idx = torch.arange(N, device=dev).repeat(4)

    # rank = how many earlier entries share the tile: the entry's position
    # in a stable grouping by tile, minus its tile's start
    order = torch.argsort(tid, stable=True)
    counts = torch.bincount(tid, minlength=nT + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty(E, dtype=torch.long, device=dev)
    rank[order] = torch.arange(E, device=dev) - starts[tid[order]]

    keep = (tid < nT) & (rank < M)
    slot = (tid * M + rank)[keep]
    table = torch.zeros(nT * M, dtype=torch.long, device=dev)
    vtable = torch.zeros(nT * M, dtype=torch.bool, device=dev)
    table[slot] = point_idx[keep]
    vtable[slot] = True
    slot_point_idx = table.reshape(nT, M)
    slot_valid = vtable.reshape(nT, M)

    big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
    d = torch.where(slot_valid, points[:, 2][slot_point_idx], big)
    by_depth = torch.argsort(d, dim=1, stable=True)
    return (torch.gather(slot_point_idx, 1, by_depth),
            torch.gather(slot_valid, 1, by_depth))


# what the dispatch last took, for tests and smoke runs
BINNER_CALLS = {"counting": 0, "sort_kernel": 0, "batched": 0}


def _bin_dispatch(points, valid, W: int, cfg: SplatConfig):
    """Route to the configured binner (ops/splat.py:377-392); all three
    return (slot_point_idx (B, nT, M), slot_valid (B, nT, M)).

    `sort_backend="pallas"` takes the K5 binner while an image's 4N entries
    fit the kernel (<= MAX_E = 2^19); above that the whole-batch sort runs,
    as in the JAX package.  Unlike there, the route does not depend on the
    device: on CPU tensors the K5 wrapper runs its plain network, on CUDA
    tensors it launches the kernel or raises."""
    if cfg.binning == "counting":
        BINNER_CALLS["counting"] += 1
        per_image = [_bin_points_counting(p, v, W, cfg)
                     for p, v in zip(points, valid)]
        return (torch.stack([i for i, _ in per_image]),
                torch.stack([v for _, v in per_image]))
    if cfg.binning != "argsort":
        raise NotImplementedError(
            f'splat.binning={cfg.binning!r}: the port implements "argsort" '
            'and "counting"')
    if cfg.sort_backend == "pallas":
        from pixelsynth_tpu_torch.ops.sort_kernel import MAX_E

        if 4 * points.shape[1] <= MAX_E:
            BINNER_CALLS["sort_kernel"] += 1
            return _bin_points_batched_pallas(points, valid, W, cfg)
    elif cfg.sort_backend != "xla":
        raise NotImplementedError(
            f'splat.sort_backend={cfg.sort_backend!r}: the port implements '
            '"xla" (one library sort) and "pallas" (kernel K5)')
    BINNER_CALLS["batched"] += 1
    return _bin_points_batched(points, valid, W, cfg)


def blend_tiles_plain(slot_pts, slot_feats, slot_valid, tile_origin, W: int,
                      cfg: SplatConfig):
    """`_blend_tiles` (splat.py:395-446), in groups of cfg.tile_group tiles.

    slot_pts (T, M, >=2); slot_feats (T, M, C); slot_valid (T, M) bool;
    tile_origin (T, 2) [row0, col0].  Returns (out (T, TS, TS, C) f32,
    covered (T, TS, TS) bool).  With blend_dtype "bfloat16" the features
    and the weights are rounded to bf16 and multiplied and summed in f32."""
    bf16 = cfg.blend_dtype == "bfloat16"
    TS = cfg.tile_size
    P = TS * TS
    dev = slot_pts.device
    py = (torch.arange(P, device=dev) // TS).float()
    px = (torch.arange(P, device=dev) % TS).float()
    outs, covs = [], []
    G = max(1, cfg.tile_group)
    for g0 in range(0, slot_pts.shape[0], G):
        pts = slot_pts[g0:g0 + G]
        fts = slot_feats[g0:g0 + G] * slot_valid[g0:g0 + G, :, None]
        if bf16:
            fts = round_bf16(fts)
        vm = slot_valid[g0:g0 + G]
        org = tile_origin[g0:g0 + G]
        rows = py[None] + org[:, 0:1]
        cols = px[None] + org[:, 1:2]
        dx = cols[:, :, None] - pts[:, None, :, 0]
        dy = rows[:, :, None] - pts[:, None, :, 1]
        dist2 = dx * dx + dy * dy                               # (G, P, M)
        cover = (dist2 < cfg.radius * cfg.radius) & vm[:, None, :]
        rank = torch.cumsum(cover.to(torch.int32), dim=2)
        keep = cover & (rank <= cfg.pp_pixel)
        alpha = _alpha_from_dist2(dist2, W, cfg) * keep.float()
        if cfg.accumulation == "alphacomposite":
            trans = torch.cumprod(1.0 - alpha, dim=2)
            excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], 2)
            w = alpha * excl
        elif cfg.accumulation == "wsum":
            w = alpha
        elif cfg.accumulation == "wsumnorm":
            # under bf16 the sum is taken in f64 and rounded once, so that
            # its value does not depend on the order of a reduction (an ulp
            # of the denominator moves the weights' bf16 rounding)
            total = (alpha.sum(2, keepdim=True, dtype=torch.float64).to(alpha.dtype)
                     if bf16 else alpha.sum(2, keepdim=True))
            w = alpha / torch.clamp(total, min=1e-4)
        else:
            raise ValueError(f"unknown accumulation {cfg.accumulation}")
        if bf16:
            w = round_bf16(w)
        outs.append((w @ fts).reshape(-1, TS, TS, fts.shape[-1]))
        covs.append(cover.any(2).reshape(-1, TS, TS))
    return torch.cat(outs), torch.cat(covs)


def tile_origins(W: int, TS: int, device) -> torch.Tensor:
    nside = W // TS
    t = torch.arange(nside * nside, device=device)
    return torch.stack([(t // nside) * TS, (t % nside) * TS], -1).float()


def gather_slots(points, feats, slot_idx, slot_valid):
    """Per-tile slot lists: (B, N, 3), (B, N, C), (B, nT, M) ->
    (B*nT, M, 3), (B*nT, M, C) (invalid slots' features zeroed),
    (B*nT, M)."""
    B, nT, M = slot_idx.shape
    flat = slot_idx.reshape(B, nT * M)
    spts = torch.gather(points, 1, flat[..., None].expand(-1, -1, 3))
    sfts = torch.gather(feats, 1, flat[..., None].expand(-1, -1, feats.shape[-1]))
    sfts = sfts * slot_valid.reshape(B, nT * M, 1)
    return (spts.reshape(B * nT, M, 3).contiguous(),
            sfts.reshape(B * nT, M, -1).contiguous(),
            slot_valid.reshape(B * nT, M).contiguous())


def _splat_lib():
    lib = _cuda.load("splat_blend")
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.splat_blend, lib.splat_blend_bf16):
            fn.argtypes = [P] * 6 + [I] * 6 + [Fl] * 3 + [I] * 2 + [P]
            fn.restype = I
        lib._typed = True
    return lib


def untile(x: torch.Tensor, B: int, W: int, TS: int) -> torch.Tensor:
    """(B * nT, TS, TS, ...) tiles in row-major tile order -> (B, W, W, ...)."""
    nside = W // TS
    rest = x.shape[3:]
    x = x.reshape(B, nside, nside, TS, TS, *rest).transpose(2, 3)
    return x.reshape(B, W, W, *rest)


def blend_slots_plain(points, feats, slot_idx, slot_valid, W: int, cfg: SplatConfig):
    """K2's plain version: `gather_slots`, then `blend_tiles_plain`, laid
    out as the image.  -> (out (B, W, W, C), covered (B, W, W) bool); out
    is f32 for f32 inputs (float64 inputs are blended in float64)."""
    B = points.shape[0]
    TS = cfg.tile_size
    dt = torch.promote_types(torch.promote_types(points.dtype, feats.dtype),
                             torch.float32)
    spts, sfts, svld = gather_slots(points.to(dt), feats.to(dt), slot_idx, slot_valid)
    org = tile_origins(W, TS, points.device).repeat(B, 1).to(dt)
    out, cov = blend_tiles_plain(spts, sfts, svld, org, W, cfg)
    return untile(out, B, W, TS), untile(cov, B, W, TS)


def blend_slots(points, feats, slot_idx, slot_valid, W: int, cfg: SplatConfig):
    """K2.  points (B, N, 3) [col, row, depth], feats (B, N, C), the
    binner's slot_idx (B, nT, M) and slot_valid (B, nT, M) -> (out (B, W,
    W, C) f32, covered (B, W, W) bool).  On the card one launch of the
    CUDA kernel (`blend_slots_kernel`); on the CPU `blend_slots_plain`.
    Where points or feats require grad, the same forward inside
    `_SplatBlendFn`, whose backward is `blend_slots_vjp`."""
    if torch.is_grad_enabled() and (points.requires_grad or feats.requires_grad):
        return _SplatBlendFn.apply(points, feats, slot_idx, slot_valid, W, cfg)
    return _blend_forward(points, feats, slot_idx, slot_valid, W, cfg)


def _blend_forward(points, feats, slot_idx, slot_valid, W: int, cfg: SplatConfig):
    if not points.is_cuda:
        PLAIN_CALLS["splat_blend"] += 1
        return blend_slots_plain(points, feats, slot_idx, slot_valid, W, cfg)
    return blend_slots_kernel(points, feats, slot_idx, slot_valid, W, cfg)


def blend_slots_vjp(g_out, points, feats, slot_idx, slot_valid, W: int,
                    cfg: SplatConfig):
    """(d points (B, N, 3), d feats (B, N, C)) of `blend_slots_plain` for
    the cotangent g_out (B, W, W, C): the plain blend recomputed under
    autograd one group of cfg.tile_group tiles at a time, each group's
    slot gradients scattered back onto the points they were gathered
    from, each group over its slots up to its last valid one.  The depth
    column gets no gradient (the blend reads only col and row), nor do
    empty slots."""
    B, N, _ = points.shape
    C = feats.shape[-1]
    TS = cfg.tile_size
    nside = W // TS
    T, M = B * nside * nside, slot_idx.shape[-1]
    dev = points.device
    g_tiles = (g_out.reshape(B, nside, TS, nside, TS, C).transpose(2, 3)
               .reshape(T, TS, TS, C))
    flat_idx = (slot_idx + torch.arange(B, device=dev)[:, None, None] * N).reshape(T, M)
    svld = slot_valid.reshape(T, M)
    dt = torch.promote_types(torch.promote_types(points.dtype, feats.dtype),
                             torch.float32)
    pts = points.detach().to(dt).reshape(B * N, 3)
    fts = feats.detach().to(dt).reshape(B * N, C)
    org = tile_origins(W, TS, dev).repeat(B, 1).to(dt)
    dpts, dfts = torch.zeros_like(pts), torch.zeros_like(fts)
    G = max(1, cfg.tile_group)
    # each group is blended over its slots up to its last valid one (the
    # slots after it add nothing): one host read for all groups
    ends = (svld * torch.arange(1, M + 1, device=dev)).amax(1)
    ends = F.pad(ends, (0, -T % G)).reshape(-1, G).amax(1).clamp(min=1).tolist()
    for g0, m in zip(range(0, T, G), ends):
        idx = flat_idx[g0:g0 + G, :m]
        with torch.enable_grad():
            p = pts[idx].requires_grad_(True)
            f = fts[idx].requires_grad_(True)
            out, _ = blend_tiles_plain(p, f, svld[g0:g0 + G, :m], org[g0:g0 + G], W, cfg)
            gp, gf = torch.autograd.grad(out, (p, f), g_tiles[g0:g0 + G])
        dpts.index_add_(0, idx.reshape(-1), gp.reshape(-1, 3))
        dfts.index_add_(0, idx.reshape(-1), gf.reshape(-1, C))
    return (dpts.reshape(B, N, 3).to(points.dtype),
            dfts.reshape(B, N, C).to(feats.dtype))


class _SplatBlendFn(torch.autograd.Function):
    """K2 under a gradient: the forward of `blend_slots` (the kernel on the
    card), the backward `blend_slots_vjp` (plain PyTorch, as the JAX
    package's backward is plain XLA)."""

    @staticmethod
    def forward(ctx, points, feats, slot_idx, slot_valid, W, cfg):
        ctx.save_for_backward(points, feats, slot_idx, slot_valid)
        ctx.W, ctx.cfg = W, cfg
        with torch.no_grad():
            out, cov = _blend_forward(points, feats, slot_idx, slot_valid, W, cfg)
        ctx.mark_non_differentiable(cov)
        return out, cov

    @staticmethod
    def backward(ctx, g_out, _g_cov):
        points, feats, slot_idx, slot_valid = ctx.saved_tensors
        dp, df = blend_slots_vjp(g_out, points, feats, slot_idx, slot_valid,
                                 ctx.W, ctx.cfg)
        return dp, df, None, None, None, None


def blend_slots_kernel(points, feats, slot_idx, slot_valid, W: int, cfg: SplatConfig):
    """One launch of the CUDA kernel (csrc/splat_blend.cu), which gathers
    the slots' points itself: points f32, any C >= 1 (C <= 8 a thread a
    pixel; C > 8 one walk of a tile's slots, the weights times the
    features on the tensor cores); slot_idx int64; tile_size a multiple
    of 8 up to 32.  feats are cast once to
    f32, or with blend_dtype "bfloat16" to bf16 for the bf16 entry
    (`splat_blend_bf16`, counted under that name).  Takes no gradient:
    under one, `blend_slots` runs it inside `_SplatBlendFn`."""
    if torch.is_grad_enabled() and (points.requires_grad or feats.requires_grad):
        raise ValueError("blend_slots_kernel has no gradient: use blend_slots")
    B, N, _ = points.shape
    C = feats.shape[-1]
    TS = cfg.tile_size
    nT = (W // TS) ** 2
    M = slot_idx.shape[-1]
    dev = points.device
    if (C < 1 or TS % 8 or TS > 32 or W % TS
            or cfg.accumulation not in _ACCUM or cfg.blend_dtype not in BLEND_DTYPES):
        raise ValueError(f"K2 takes C >= 1, a tile size that is a multiple of 8 "
                         f"up to 32 and dividing W, one of {list(_ACCUM)}, one of "
                         f"{BLEND_DTYPES}; got C={C}, tile_size={TS}, W={W}, "
                         f"{cfg.accumulation!r}, {cfg.blend_dtype!r}")
    bf16 = cfg.blend_dtype == "bfloat16"
    fdt = torch.bfloat16 if bf16 else torch.float32
    points = points.float().contiguous()
    feats = feats.to(fdt).contiguous()
    _cuda.require(points, "points", dtype=torch.float32, shape=(B, N, 3))
    _cuda.require(feats, "feats", dtype=fdt, shape=(B, N, C), device=dev)
    _cuda.require(slot_idx, "slot_idx", dtype=torch.int64, shape=(B, nT, M),
                  device=dev)
    _cuda.require(slot_valid, "slot_valid", dtype=torch.bool, shape=(B, nT, M),
                  device=dev)
    out = torch.empty((B, W, W, C), dtype=torch.float32, device=dev)
    cov = torch.empty((B, W, W), dtype=torch.bool, device=dev)
    ss, denom = _alpha_consts(W, cfg)
    P = _cuda.ptr
    name = "splat_blend_bf16" if bf16 else "splat_blend"
    rc = getattr(_splat_lib(), name)(
        P(points), P(feats), P(slot_idx), P(slot_valid), P(out), P(cov), B, N, W, M,
        C, TS, float(cfg.radius * cfg.radius), ss / denom, float(cfg.tau),
        int(cfg.pp_pixel), _ACCUM[cfg.accumulation], _cuda.stream_of(points))
    _cuda.check(rc, name)
    LAUNCHES[name] += 1
    return out, cov


def splat(points, feats, valid=None, *, W: int, cfg: SplatConfig = None):
    """Splat (B, N, 3) [col, row, depth] points with (B, N, C) features
    into (B, W, W, C) f32 + the (B, W, W) bool background mask (point-free
    pixels, dilated by the background-smoothing max filter).  The blend
    reads the features in `cfg.blend_dtype` ("float32" or "bfloat16")."""
    cfg = cfg or SplatConfig()
    if cfg.blend_dtype not in BLEND_DTYPES:
        raise NotImplementedError(
            f'splat.blend_dtype={cfg.blend_dtype!r}: the port blends in '
            f'{BLEND_DTYPES}')
    B, N, _ = points.shape
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=points.device)
    slot_idx, slot_valid = _bin_dispatch(points.detach(), valid, W, cfg)
    img, covered = blend_slots(points, feats, slot_idx, slot_valid, W, cfg)
    return img, dilate_mask(~covered, cfg.background_smoothing_kernel_size)


def splat_dense(points, feats, valid=None, *, W: int, cfg: SplatConfig = None):
    """O(W^2 x N) dense oracle with the same semantics as `splat` (for
    tests at tiny sizes)."""
    cfg = cfg or SplatConfig()
    B, N, _ = points.shape
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=points.device)
    outs, covs = [], []
    P = W * W
    py = (torch.arange(P, device=points.device) // W).float()
    px = (torch.arange(P, device=points.device) % W).float()
    for b in range(B):
        order = torch.sort(points[b, :, 2], stable=True).indices
        pts, fts, vld = points[b][order], feats[b][order], valid[b][order]
        dist2 = (px[:, None] - pts[None, :, 0]) ** 2 + (py[:, None] - pts[None, :, 1]) ** 2
        vld = vld & (pts[:, 2] > 0)
        cover = (dist2 < cfg.radius * cfg.radius) & vld[None]
        keep = cover & (torch.cumsum(cover.int(), 1) <= cfg.pp_pixel)
        alpha = _alpha_from_dist2(dist2, W, cfg) * keep.float()
        if cfg.accumulation == "alphacomposite":
            trans = torch.cumprod(1.0 - alpha, 1)
            w = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
        elif cfg.accumulation == "wsum":
            w = alpha
        else:
            w = alpha / torch.clamp(alpha.sum(1, keepdim=True), min=1e-4)
        outs.append((w @ fts).reshape(W, W, -1))
        covs.append(cover.any(1).reshape(W, W))
    covered = torch.stack(covs)
    return torch.stack(outs), dilate_mask(~covered, cfg.background_smoothing_kernel_size)
