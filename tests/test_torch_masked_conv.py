"""The port's masked convolutions against the JAX package's, same numpy
inputs, on the CPU: the plain `locally_masked_conv2d`, kernel K3's plain
version against the Pallas kernel (interpret mode), and K3's differentiable
entry against `jax.vjp` of the Pallas custom-VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops.masked_conv import locally_masked_conv2d as jax_conv
from pixelsynth_tpu.ops.masked_conv_pallas import (
    locally_masked_conv2d_pallas, locally_masked_conv2d_pallas_vjp,
)
from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
from pixelsynth_tpu_torch.ops.masked_conv import locally_masked_conv2d

B, H, W, CIN, COUT = 2, 8, 8, 16, 32


def _inputs(seed, cin=CIN, cout=COUT, b=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, H, W, cin)).astype(np.float32)
    mask = (rng.uniform(size=(b, 9, H * W)) > 0.5).astype(np.float32)
    w = (rng.standard_normal((9, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    mw = (rng.standard_normal((9, cout)) * 0.1).astype(np.float32)
    return x, mask, w, bias, mw


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("with_mask_weight", [False, True])
def test_plain_conv_matches_jax(dilation, with_mask_weight):
    x, mask, w, bias, mw = _inputs(0)
    mw_j = jnp.asarray(mw) if with_mask_weight else None
    mw_t = torch.as_tensor(mw) if with_mask_weight else None
    want = jax_conv(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                    jnp.asarray(bias), mw_j, dilation=dilation)
    got = locally_masked_conv2d(torch.as_tensor(x), torch.as_tensor(mask),
                                torch.as_tensor(w), torch.as_tensor(bias), mw_t,
                                dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_conv_bf16_operands_match_jax():
    """compute_dtype: operands rounded to bf16, the sum in f32 (both sides
    round identically; the sums differ in order)."""
    x, mask, w, bias, _ = _inputs(1)
    want = jax_conv(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                    jnp.asarray(bias), dilation=1, compute_dtype=jnp.bfloat16)
    got = locally_masked_conv2d(torch.as_tensor(x), torch.as_tensor(mask),
                                torch.as_tensor(w), torch.as_tensor(bias),
                                dilation=1, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dilation", [1, 2])
def test_k3_plain_matches_pallas_f32(dilation):
    x, mask, w, bias, _ = _inputs(2)
    want = locally_masked_conv2d_pallas(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(bias),
        dilation=dilation, compute_dtype="float32")
    before = dict(K3.PLAIN_CALLS), dict(K3.LAUNCHES)
    got = K3.locally_masked_conv2d_kernel(
        torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(w),
        torch.as_tensor(bias), dilation=dilation, compute_dtype="float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # on CPU tensors the wrapper took the plain version and launched nothing
    assert K3.PLAIN_CALLS["masked_conv"] == before[0]["masked_conv"] + 1
    assert K3.LAUNCHES == before[1]
    # a prepared mask gives the same result
    pm = K3.prepare_mask(torch.as_tensor(mask))
    assert pm.rows.shape == (B, H * W, 9) and pm.rows.is_contiguous()
    again = K3.locally_masked_conv2d_kernel(
        torch.as_tensor(x), pm, torch.as_tensor(w), torch.as_tensor(bias),
        dilation=dilation, compute_dtype="float32")
    assert torch.equal(got, again)


def test_k3_vjp_matches_jax_vjp():
    x, mask, w, bias, _ = _inputs(3, cin=8, cout=8, b=1)
    g = np.random.default_rng(4).standard_normal((1, H, W, 8)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x_, w_, b_: locally_masked_conv2d_pallas_vjp(
            x_, jnp.asarray(mask), w_, b_, 2, "float32"),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    out = K3.locally_masked_conv2d_kernel_vjp(xt, torch.as_tensor(mask), wt, bt,
                                              2, "float32")
    out.backward(torch.as_tensor(g))
    for got_t, want_j in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j),
                                   atol=1e-4, rtol=1e-4)
    # and against autograd through the plain conv
    xa, wa, ba = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    locally_masked_conv2d(xa, torch.as_tensor(mask), wa, ba,
                          dilation=2).backward(torch.as_tensor(g))
    for a_, b_ in zip((xt.grad, wt.grad, bt.grad), (xa.grad, wa.grad, ba.grad)):
        torch.testing.assert_close(a_, b_, atol=1e-4, rtol=1e-4)


def test_k3_kernel_widths():
    """Which (Cin, Cout) the bf16 kernel takes: each F or 2F for one F."""
    assert K3.kernel_width(160, 80) == 80 and K3.kernel_width(160, 160) == 80
    assert K3.kernel_width(80, 80) == 80 and K3.kernel_width(16, 32) == 16
    assert K3.kernel_width(32, 16) == 16
    assert K3.kernel_width(513, 80) == 0 and K3.kernel_width(24, 24) == 0
    assert K3.kernel_width(96, 96) == 48 and K3.kernel_width(192, 192) == 0
