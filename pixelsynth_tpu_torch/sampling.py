"""Batched autoregressive outpainting and candidate re-ranking (port of
pixelsynth_tpu/sampling.py).

The whole candidate population advances together: every PixelCNN forward
runs on all candidates.  The JAX `while_loop` becomes a Python loop that
checks `t < n_bg` once per forward (one small device->host read).  Random
draws come from an explicit `torch.Generator`; they are not JAX's bits, so
the tests hold the sampler by exactness properties (argmax chains at low
temperature, an analytic two-cell joint), not by equal samples.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Sample the last axis by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp(u, min=1e-20, max=1.0 - 1e-7)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_positions(order: torch.Tensor, bg_ds: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat positions to sample, background cells first in generation
    order; a cell samples only when entirely background.

    order (B, HW, 2) [row, col]; bg_ds (B, H, W) in [0, 1].
    Returns (positions (B, HW) int64, n_bg (B,) int64)."""
    B, HW, _ = order.shape
    Wd = bg_ds.shape[-1]
    flat = (order[..., 0] * Wd + order[..., 1]).long()
    in_bg = torch.gather(bg_ds.reshape(B, -1), 1, flat) >= 1.0 - 1e-6
    rank = torch.arange(HW, device=order.device).expand(B, HW)
    key = torch.where(in_bg, rank, rank + HW)
    perm = torch.argsort(key, dim=1)
    return torch.gather(flat, 1, perm), in_bg.sum(1)


def _initial_state(codes, positions, n_bg):
    B, H, W = codes.shape
    HW = H * W
    live = (torch.arange(HW, device=codes.device)[None] < n_bg[:, None]).float()
    bg_sel = torch.zeros((B, HW), device=codes.device).scatter_add_(
        1, positions, live)
    return codes.reshape(B, HW).long().clone(), 1.0 - bg_sel


def ar_sample(logits_fn: Callable, codes: torch.Tensor, order: torch.Tensor,
              bg_ds: torch.Tensor, gen: torch.Generator, *,
              num_classes: int = 512, temperature: float = 1.0,
              max_steps: Optional[int] = None) -> torch.Tensor:
    """Fill the background cells of `codes` (B, H, W) one cell per
    forward.  logits_fn(codes, filled) -> (B, H, W, C); its `.at` fast
    path is used when present."""
    B, H, W = codes.shape
    positions, n_bg = sample_positions(order, bg_ds)
    steps = int(n_bg.max()) if max_steps is None else int(max_steps)
    cur, filled = _initial_state(codes, positions, n_bg)
    at = getattr(logits_fn, "at", None)
    for t in range(steps):
        pos = positions[:, t]
        if at is not None:
            sel = at(cur.reshape(B, H, W), filled.reshape(B, H, W), pos)
        else:
            logits = logits_fn(cur.reshape(B, H, W), filled.reshape(B, H, W))
            sel = logits.reshape(B, H * W, num_classes)[torch.arange(B), pos]
        new = _categorical(sel / temperature, gen)
        active = t < n_bg
        b = torch.nonzero(active).flatten()
        cur[b, pos[b]] = new[b]
        filled[b, pos[b]] = 1.0
    return cur.reshape(B, H, W)


def ar_sample_speculative(logits_fn: Callable, codes: torch.Tensor,
                          order: torch.Tensor, bg_ds: torch.Tensor,
                          gen: torch.Generator, *, num_classes: int = 512,
                          temperature: float = 1.0, spec: int = 12,
                          return_stats: bool = False):
    """`ar_sample` with exact speculative multi-cell decoding
    (sampling.py:126-253): one forward verifies the S drafted cells (the
    locally-masked convs make the logits at order-position t+j the true
    conditional given cells < t+j), accepts draft j with probability
    min(1, p/q), resamples the first rejection from normalize(max(p-q, 0))
    or takes a bonus sample, and redrafts from this forward's later rows.
    Commits 1..S+1 cells per forward from exactly the joint of
    `ar_sample`.  Needs logits_fn.at; falls back to `ar_sample`."""
    if getattr(logits_fn, "at", None) is None:
        out = ar_sample(logits_fn, codes, order, bg_ds, gen,
                        num_classes=num_classes, temperature=temperature)
        if return_stats:
            # one forward per step of the fullest candidate
            steps = int(sample_positions(order, bg_ds)[1].max())
            return out, {"n_forwards": steps, "max_n_bg": steps}
        return out
    S = int(spec)
    G = 2 * S + 1
    B, H, W = codes.shape
    HW = H * W
    dev = codes.device
    positions, n_bg = sample_positions(order, bg_ds)
    cur, fil = _initial_state(codes, positions, n_bg)
    # one trash column absorbs the writes that JAX drops (index HW)
    cur = torch.cat([cur, torch.zeros((B, 1), dtype=cur.dtype, device=dev)], 1)
    fil = torch.cat([fil, torch.zeros((B, 1), device=dev)], 1)
    trash = torch.full((B, 1), HW, device=dev)
    jS = torch.arange(S, device=dev)[None]
    eps = 1e-20
    t = torch.zeros(B, dtype=torch.long, device=dev)
    dvals = torch.zeros((B, S), dtype=torch.long, device=dev)
    qp = torch.zeros((B, S + 1, num_classes), device=dev)
    n_fwd = 0
    while bool((t < n_bg).any()):
        idx = torch.clamp(t[:, None] + torch.arange(G, device=dev)[None], max=HW - 1)
        probe = torch.gather(positions, 1, idx)                 # (B, G)
        draft_ok = (t[:, None] + jS) < n_bg[:, None]
        pos_d = torch.where(draft_ok, probe[:, :S], trash)
        cur_s = cur.scatter(1, pos_d, dvals)
        fil_s = fil.scatter(1, pos_d, torch.ones_like(dvals, dtype=fil.dtype))
        l = logits_fn.at(cur_s[:, :HW].reshape(B, H, W),
                         fil_s[:, :HW].reshape(B, H, W), probe)  # (B, G, C)
        n_fwd += 1
        p = torch.softmax(l[:, :S + 1] / temperature, -1)

        p_at_d = torch.gather(p[:, :S], -1, dvals[..., None])[..., 0]
        q_at_d = torch.gather(qp[:, :S], -1, dvals[..., None])[..., 0]
        ratio = torch.clamp(p_at_d / torch.clamp(q_at_d, min=eps), max=1.0)
        u = torch.rand((B, S), generator=gen, device=dev)
        accept = (u < ratio) & (q_at_d > eps) & draft_ok
        A = torch.cumprod(accept.long(), 1).sum(1)             # (B,)

        rowA = A[:, None, None].expand(B, 1, num_classes)
        pA = torch.gather(p, 1, rowA)[:, 0]
        qA = torch.gather(qp, 1, rowA)[:, 0]
        res = torch.clamp(pA - qA, min=0.0)
        rsum = res.sum(-1, keepdim=True)
        res = torch.where(rsum > eps, res / torch.clamp(rsum, min=eps), pA)
        r = _categorical(torch.log(res + 1e-30), gen)

        commit_n = torch.minimum(A + 1, torch.clamp(n_bg - t, min=0))
        vals = torch.cat([dvals, r[:, None]], 1).scatter(1, A[:, None], r[:, None])
        take = torch.arange(S + 1, device=dev)[None] < commit_n[:, None]
        pos_c = torch.where(take, probe[:, :S + 1], trash)
        cur = cur.scatter(1, pos_c, vals)
        fil = fil.scatter(1, pos_c, torch.ones_like(vals, dtype=fil.dtype))
        t = t + commit_n

        off = torch.clamp(A[:, None] + 1 + jS, max=G - 1)
        ql = torch.gather(l, 1, off[..., None].expand(B, S, num_classes))
        dvals = _categorical(ql / temperature, gen)
        qp = torch.cat([torch.softmax(ql / temperature, -1),
                        torch.zeros((B, 1, num_classes), device=dev)], 1)
    out = cur[:, :HW].reshape(B, H, W)
    if return_stats:
        return out, {"n_forwards": n_fwd, "max_n_bg": int(n_bg.max())}
    return out


# ---------------------------------------------------------------------------
# candidate re-ranking (get_best_sample, z_buffermodel.py:244-276)
# ---------------------------------------------------------------------------


def rank_candidates(discrim_scores: torch.Tensor,
                    entropy_scores: torch.Tensor) -> torch.Tensor:
    """(S,) scores -> best index: argmax of 0.5*(S-1-entropy_rank) +
    0.5*discrim_rank (high D_Fake loss and low entropy win)."""
    S = discrim_scores.shape[0]
    ar = torch.arange(S, device=discrim_scores.device)
    d_rank = torch.empty_like(ar).scatter_(
        0, torch.argsort(discrim_scores, stable=True), ar)
    e_rank = torch.empty_like(ar).scatter_(
        0, torch.argsort(entropy_scores, stable=True), ar)
    total = 0.5 * (S - 1 - e_rank) + 0.5 * d_rank
    return torch.argmax(total)


def d_fake_score(disc, gen_img: torch.Tensor, ref_img: torch.Tensor):
    """Per-candidate D_Fake hinge loss (gan_loss.py:88-93): the mean over
    scales of mean(relu(1 + D(fake))) per candidate."""
    S = gen_img.shape[0]
    both = torch.cat([gen_img, ref_img.expand_as(gen_img)], 0)
    per = [torch.relu(1.0 + scale[-1][:S]).reshape(S, -1).mean(1)
           for scale in disc(both)]
    return torch.stack(per).mean(0)
