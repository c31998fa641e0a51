"""The port's average pool (`models/layers.py` `avg_pool`) and the tensors
the stage-2 step hands it.

On the card, `F.avg_pool2d`'s backward is wrong for an input with
channels-last strides (the forward is right): in float64 on an H100
(torch 2.11) its input gradient was 0.80-0.89 of its scale away from the
CPU's, for either padding rule (`scripts/dpr_bisect/op_grads.py`).  The
models take NHWC and permute it, and a convolution keeps that memory
format, so the discriminator's downsample and the decoder's Down blocks
received such tensors, and the generator's gradient through them was wrong
on the card.  `avg_pool` pools a contiguous copy and gives its output the
input's memory format back.  The CPU computes the right gradient either
way, so the tests here hold the invariant (every average pool of a train
step reads a contiguous tensor) and the helper's values and memory format;
the card's own comparison is in tests/test_torch_kernels_gpu.py."""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.data.synthetic import synthetic_pair_batch
from pixelsynth_tpu_torch.models.layers import avg_pool
from pixelsynth_tpu_torch.pipeline import PixelSynth
from pixelsynth_tpu_torch.train.dpr import create_dpr_state, make_dpr_train_step
from test_train_loops import tiny_cfg
from torch_threads import _few_torch_threads  # noqa: F401


def test_train_step_pools_contiguous_tensors():
    """Every `F.avg_pool2d` call of one stage-2 G+D step (the decoder's Down
    blocks, the discriminator's downsample in the G, D and advance passes,
    the masks' downsampling) reads a contiguous tensor, and there are such
    calls from both the decoder and D."""
    cfg = Config.from_json(tiny_cfg().to_json())
    ps = PixelSynth(cfg, device="cpu", seed=2, trainable=True)
    step = make_dpr_train_step(ps, create_dpr_state(ps))
    pool = F.avg_pool2d
    calls = []

    def checked(x, *args, **kw):
        calls.append((tuple(x.shape), x.is_contiguous(), x.requires_grad))
        return pool(x, *args, **kw)

    with mock.patch.object(F, "avg_pool2d", checked):
        step(synthetic_pair_batch(np.random.default_rng(0), 2, cfg.model.W),
             torch.Generator().manual_seed(0))
    assert [c for c in calls if not c[1]] == []
    assert sum(c[2] and c[0][1] == 3 for c in calls) >= 1    # D's downsample of G's image
    assert sum(c[2] and c[0][1] > 3 for c in calls) >= 1     # the decoder's Down blocks


@pytest.mark.parametrize("include", [True, False])
def test_avg_pool_of_channels_last_tensor(include):
    """`avg_pool` of an NHWC tensor seen through permute (channels-last
    strides) equals `F.avg_pool2d` of the contiguous tensor, values and
    input gradient, with either padding rule, and keeps the input's
    memory format (so the layers after it compute as before)."""
    g = torch.Generator().manual_seed(int(include))
    x = torch.randn(2, 9, 10, 4, generator=g, dtype=torch.float64)
    up = torch.randn(2, 4, 5, 5, generator=g, dtype=torch.float64)
    xa = x.clone().requires_grad_(True)
    ya = avg_pool(xa.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=include)
    xb = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    yb = F.avg_pool2d(xb, 3, 2, 1, count_include_pad=include)
    assert not xa.permute(0, 3, 1, 2).is_contiguous()
    assert ya.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    ga, = torch.autograd.grad(ya, xa, up)
    gb, = torch.autograd.grad(yb, xb, up)
    torch.testing.assert_close(ga.permute(0, 3, 1, 2), gb, rtol=0, atol=1e-15)
