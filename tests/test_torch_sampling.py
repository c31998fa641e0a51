"""The port's AR samplers, held by the exactness properties of
tests/test_sampling.py (the RNG streams differ from JAX's, so samples are
not compared draw for draw)."""

import numpy as np
import pytest
import torch

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops.lmconv_fused import (
    make_fused_logits_fn, pack_lmconv_params,
)
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
from pixelsynth_tpu_torch.sampling import (
    ar_sample, ar_sample_speculative, rank_candidates, sample_positions,
)
from torch_threads import _few_torch_threads  # noqa: F401

B, H, W, NC = 2, 8, 8, 16


@pytest.fixture(scope="module")
def setup():
    cfg = Config()
    l = cfg.model.lmconv
    l.nr_resnet, l.nr_filters, l.input_channels, l.num_classes = 1, 8, NC, NC
    params = random_pixelcnn_params(cfg, torch.Generator().manual_seed(0))
    packed = pack_lmconv_params(params, nr_resnet=1, compute_dtype="float32")
    bg = np.zeros((B, H, W), np.float32)
    bg[:, :, 4:] = 1.0
    dist = torch.as_tensor(((1 - bg) * 3 - bg * 2).astype(np.int32))
    order, masks = orders_and_masks(dist, 3, 2)
    fn = make_fused_logits_fn(packed, masks, nr_resnet=1, max_dilation=2,
                              num_classes=NC, compute_dtype="float32")
    return fn, order, torch.as_tensor(bg)


def test_positions_and_foreground_preserved(setup):
    fn, order, bg = setup
    pos, n_bg = sample_positions(order, bg)
    assert n_bg.tolist() == [32, 32]
    assert (bg.reshape(B, -1).gather(1, pos[:, :32]) == 1).all()
    codes = torch.full((B, H, W), 3)
    out = ar_sample_speculative(fn, codes, order, bg,
                                torch.Generator().manual_seed(11),
                                num_classes=NC, temperature=0.7, spec=3)
    assert (out[:, :, :4] == 3).all()
    again = ar_sample_speculative(fn, codes, order, bg,
                                  torch.Generator().manual_seed(11),
                                  num_classes=NC, temperature=0.7, spec=3)
    assert torch.equal(out, again)          # deterministic per generator


def test_speculative_matches_sequential_at_low_temperature(setup):
    """T -> 0 makes every conditional an argmax: the sequential sampler
    and the speculative one at every depth must agree exactly."""
    fn, order, bg = setup
    codes = torch.full((B, H, W), 3)
    seq = ar_sample(fn, codes, order, bg, torch.Generator().manual_seed(0),
                    num_classes=NC, temperature=1e-4)
    for spec in (1, 3, 12):
        spc, stats = ar_sample_speculative(
            fn, codes, order, bg, torch.Generator().manual_seed(4),
            num_classes=NC, temperature=1e-4, spec=spec, return_stats=True)
        assert torch.equal(seq, spc), spec
        assert stats["n_forwards"] <= 32


def test_speculative_without_at_falls_back_to_one_cell_per_forward(setup):
    """A logits closure with no `.at` (the per-layer engines) takes the
    sequential sampler: the same samples, and stats that count one forward
    per background cell."""
    fn, order, bg = setup
    calls = []

    def plain_fn(cur, filled):
        calls.append(1)
        return fn(cur, filled)

    codes = torch.full((B, H, W), 3)
    seq = ar_sample(fn, codes, order, bg, torch.Generator().manual_seed(0),
                    num_classes=NC, temperature=1e-4)
    out, stats = ar_sample_speculative(
        plain_fn, codes, order, bg, torch.Generator().manual_seed(4),
        num_classes=NC, temperature=1e-4, spec=12, return_stats=True)
    assert out.shape == (B, H, W) and torch.equal(out, seq)
    assert stats == {"n_forwards": 32, "max_n_bg": 32} and len(calls) == 32


def test_speculative_exact_joint_two_cell_chain():
    """A 2-cell chain whose second conditional depends on the first cell's
    committed value: the speculative path must hit the analytic joint."""
    Bc, Hc, Wc, C, T = 4096, 2, 2, 2, 1.0
    th0, tha, thb, thc = 0.8, 1.5, -1.2, 0.3
    l_p0 = torch.tensor([0.0, th0])
    la, lb, lc = (torch.tensor([0.0, t]) for t in (tha, thb, thc))

    def logits_fn(cur, filled):
        raise AssertionError("full-grid path must not be used")

    def at(cur, filled, pos):
        c, f = cur.reshape(Bc, 4), filled.reshape(Bc, 4)
        row1 = torch.where(f[:, :1] > 0,
                           torch.where((c[:, :1] == 1), la, lb), lc)
        table = torch.stack([l_p0.expand(Bc, C), row1, torch.zeros(Bc, C),
                             torch.zeros(Bc, C)], 1)
        return torch.gather(table, 1, pos[..., None].expand(-1, -1, C))

    logits_fn.at = at
    order = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]]).expand(Bc, 4, 2)
    bg = torch.zeros((Bc, Hc, Wc))
    bg[:, 0, :] = 1.0
    out = ar_sample_speculative(logits_fn, torch.zeros((Bc, Hc, Wc), dtype=torch.long),
                                order, bg, torch.Generator().manual_seed(7),
                                num_classes=C, temperature=T, spec=2)
    x0, x1 = out[:, 0, 0].numpy(), out[:, 0, 1].numpy()

    def sm(th):
        return np.exp(th) / (1.0 + np.exp(th))

    p0 = sm(th0)
    joint = {(0, 0): (1 - p0) * (1 - sm(thb)), (0, 1): (1 - p0) * sm(thb),
             (1, 0): p0 * (1 - sm(tha)), (1, 1): p0 * sm(tha)}
    for (a, b), want in joint.items():
        got = float(np.mean((x0 == a) & (x1 == b)))
        assert abs(got - want) < 0.035, f"joint{(a, b)}: {got} vs {want}"


def test_empty_background_is_a_no_op(setup):
    fn, order, _ = setup
    codes = torch.full((B, H, W), 7)
    none_bg = torch.zeros((B, H, W))
    for sampler in (ar_sample, ar_sample_speculative):
        out = sampler(fn, codes, order, none_bg, torch.Generator().manual_seed(0),
                      num_classes=NC)
        assert (out == 7).all()


def test_rank_candidates_matches_reference_rule():
    d = torch.tensor([0.3, 0.9, 0.1, 0.5])
    e = torch.tensor([2.0, 1.0, 0.5, 3.0])
    # ranks: d -> [1, 3, 0, 2], e -> [2, 1, 0, 3];
    # total = 0.5*(3 - e_rank) + 0.5*d_rank = [1.0, 2.5, 1.5, 1.0]
    assert int(rank_candidates(d, e)) == 1
