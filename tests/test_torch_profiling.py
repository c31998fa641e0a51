"""utils/profiling.py and the two masked-conv formulations of
ops/masked_conv.py that no path selects (`unfold_patches`,
`locally_masked_conv2d_fused`), against the JAX package."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops import masked_conv as jmc
from pixelsynth_tpu.utils.profiling import SectionTimer as JaxSectionTimer
from pixelsynth_tpu_torch.ops import masked_conv as mc
from pixelsynth_tpu_torch.utils import profiling
from torch_threads import _few_torch_threads  # noqa: F401


def test_section_timer_summary_has_jax_keys():
    """The same sections in both timers: the same section names, in the
    same order, each with total_s, count and mean_ms, and the same
    counts; times are positive floats."""
    timers = (profiling.SectionTimer(), JaxSectionTimer())
    for t in timers:
        for name in ("splat", "decode", "splat"):
            with t.section(name):
                sum(range(1000))
    got, want = (t.summary() for t in timers)
    assert list(got) == list(want) == ["decode", "splat"]
    for name in got:
        assert list(got[name]) == list(want[name]) == ["total_s", "count", "mean_ms"]
        assert got[name]["count"] == want[name]["count"]
        assert isinstance(got[name]["mean_ms"], float) and got[name]["mean_ms"] >= 0
    assert got["splat"]["count"] == 2


@pytest.mark.parametrize("sync_each", [False, True])
def test_time_compiled_returns_mean_seconds(sync_each):
    x = torch.randn(64, 64)
    calls = []
    s = profiling.time_compiled(lambda a: calls.append(a @ a), x, reps=3, warmup=1,
                                sync_each=sync_each)
    assert isinstance(s, float) and 0 < s < 10
    assert len(calls) == 1 + 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _conv_inputs(dilation, seed=0, B=2, H=8, Cin=5, Cout=4, k=3):
    rng = np.random.default_rng(seed + dilation)
    x = rng.standard_normal((B, H, H, Cin)).astype(np.float32)
    mask = (rng.uniform(size=(B, k * k, H * H)) > 0.5).astype(np.float32)
    w = (rng.standard_normal((k * k, Cin, Cout)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(Cout) * 0.1).astype(np.float32)
    mw = (rng.standard_normal((k * k, Cout)) * 0.1).astype(np.float32)
    return x, mask, w, b, mw


@pytest.mark.parametrize("dilation", [1, 2])
def test_unfold_patches_matches_jax(dilation):
    """(B, H, W, C, k*k) channel-major patches, bit-equal (a copy)."""
    x = _conv_inputs(dilation)[0]
    got = mc.unfold_patches(torch.as_tensor(x), 3, dilation)
    want = jmc.unfold_patches(jnp.asarray(x), 3, dilation)
    assert got.shape == (2, 8, 8, 5, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_extras", [False, True])
@pytest.mark.parametrize("dilation", [1, 2])
def test_fused_masked_conv_matches_jax(dilation, with_extras):
    """locally_masked_conv2d_fused against JAX's, with and without the
    bias and mask_weight, to 1e-5; and against the port's unfold
    formulation to 1e-5."""
    x, mask, w, b, mw = _conv_inputs(dilation, seed=3)
    extras = (b, mw) if with_extras else (None, None)
    got = mc.locally_masked_conv2d_fused(
        torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(w),
        *[None if e is None else torch.as_tensor(e) for e in extras], dilation=dilation)
    want = jmc.locally_masked_conv2d_fused(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
        *[None if e is None else jnp.asarray(e) for e in extras], dilation=dilation)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    plain = mc.locally_masked_conv2d(
        torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(w),
        *[None if e is None else torch.as_tensor(e) for e in extras], dilation=dilation)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)


def test_fused_masked_conv_bf16_operands_match_jax():
    """compute_dtype bf16: the operands rounded, the products summed in
    f32, as JAX's preferred_element_type=float32, to 1e-5."""
    x, mask, w, b, _ = _conv_inputs(1, seed=7)
    got = mc.locally_masked_conv2d_fused(torch.as_tensor(x), torch.as_tensor(mask),
                                         torch.as_tensor(w), torch.as_tensor(b),
                                         compute_dtype=torch.bfloat16)
    want = jmc.locally_masked_conv2d_fused(jnp.asarray(x), jnp.asarray(mask),
                                           jnp.asarray(w), jnp.asarray(b),
                                           compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
