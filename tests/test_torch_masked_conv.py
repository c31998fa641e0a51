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
from torch_threads import _few_torch_threads  # noqa: F401

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


def _order_masks(order, side=32):
    """Mask triple (1, 3, 9, HW) of a generation order on a side x side grid."""
    from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
    from pixelsynth_tpu_torch.ops.orders import masks_from_rank, orders_and_masks

    hw = side * side
    if order == "half_grid":                      # the right half is outpainted
        bg = torch.zeros((1, side, side))
        bg[:, :, side // 2:] = 1.0
        return orders_and_masks(signed_distance_field(1.0 - bg, bg))[1]
    rank = (torch.arange(hw) if order == "raster"
            else torch.as_tensor(np.random.default_rng(11).permutation(hw)))
    return masks_from_rank(rank[None], H=side, W=side)


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("order", ["raster", "half_grid", "random"])
def test_tile_tap_table_is_any_over_the_folded_mask(order, dilation):
    """The (tile, tap) table the kernels skip by: 1 exactly where some
    position of the 128-position tile has the tap on in the folded mask."""
    from pixelsynth_tpu_torch.ops.conv_pack import TILE, skipped_share, tile_tap_table
    from pixelsynth_tpu_torch.ops.lmconv_fused import fold_boundary_masks

    side = 32
    masks = _order_masks(order, side)
    folded = fold_boundary_masks(masks[:, 1 if dilation == 1 else 2], side, side, 3,
                                 dilation)                     # (1, HW, 9)
    table = tile_tap_table(folded)
    assert table.dtype == torch.int32 and table.shape == (1, side * side // TILE, 9)
    rows = folded.numpy()
    for tile in range(side * side // TILE):
        for tap in range(9):
            want = bool((rows[0, tile * TILE:(tile + 1) * TILE, tap] != 0).any())
            assert bool(table[0, tile, tap]) == want, (tile, tap)
    assert bool(table[:, :, 4].all())             # the centre tap of a B mask is on
    if order == "raster":                         # nothing below or right of a pixel
        assert not bool(table[:, :, 5:].any())
        assert skipped_share(table) == pytest.approx(4 / 9)
    # the prepared mask carries the table of its own (raw) rows
    pm = K3.prepare_mask(masks[:, 1])
    assert torch.equal(pm.taps, tile_tap_table(pm.rows))
    with pytest.raises(ValueError):
        tile_tap_table(folded[:, :100])


def test_prepared_mask_without_whole_tiles_has_no_table():
    _, mask, _, _, _ = _inputs(5)                 # HW = 64: no bf16 kernel takes it
    assert K3.prepare_mask(torch.as_tensor(mask)).taps is None


def test_k3_takes_packed_taps():
    """PackedTaps in place of the weight: same forward, and the backward
    reads the plain weights they carry."""
    from pixelsynth_tpu_torch.ops.conv_pack import prepare_taps

    x, mask, w, bias, _ = _inputs(6, cin=16, cout=16)
    xt, mt, wt, bt = (torch.as_tensor(a) for a in (x, mask, w, bias))
    packed = prepare_taps(wt, 16)
    want = K3.locally_masked_conv2d_kernel(xt, mt, wt, bt, dilation=2)
    assert torch.equal(K3.locally_masked_conv2d_kernel(xt, mt, packed, bt, dilation=2),
                       want)
    xg = xt.clone().requires_grad_(True)
    out = K3.locally_masked_conv2d_kernel_vjp(xg, mt, packed, bt, 2, "bfloat16")
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    xr = xt.clone().requires_grad_(True)
    K3.locally_masked_conv2d_kernel_vjp(xr, mt, wt, bt, 2, "bfloat16").sum().backward()
    assert torch.equal(xg.grad, xr.grad)


@pytest.mark.parametrize("H,W,cin,dilation,cluster,route", [
    (32, 32, 160, 1, 1, "resident"),   # the view's grid: 194 rows of 336 B
    (32, 32, 80, 2, 1, "resident"),    # the dilated conv: 260 rows of 176 B
    (16, 16, 160, 1, 2, "resident"),   # the stitched walk's grid, two tiles a cluster
    (44, 44, 160, 1, 1, "resident"),   # 218 rows of 336 B: the widest grid at Cin = 160
    (45, 45, 160, 1, 1, "streamed"),   # 220 rows exceed the region
    (64, 64, 80, 2, 1, "resident"),    # 388 rows of 176 B
    (96, 96, 80, 2, 1, "streamed"),    # 516 rows of 176 B exceed it
    (16, 24, 160, 1, 2, "streamed"),   # three tiles do not pair into clusters of 2
    (16, 24, 160, 1, 1, "resident"),
])
def test_k3_route(H, W, cin, dilation, cluster, route):
    """The bf16 K3 route is a function of the shape (and the build's
    cluster size) alone: the resident route where a tile's rows and halo
    of x fit the region K1's pass uses (`rows_fit`)."""
    assert K3.k3_route(H, W, cin, dilation, cluster) == route


def test_lmconv_no_grad_calls_the_kernel_wrapper(monkeypatch):
    """LMConv(backend="pallas") under torch.no_grad() calls the K3 wrapper
    straight, not the autograd Function, and gives the autograd path's
    output exactly (on the CPU both take the plain version, once a call)."""
    from pixelsynth_tpu_torch.models.lmconv import LMConv

    x, mask, _, _, _ = _inputs(7, cin=16, cout=16)
    conv = LMConv(16, 32, dilation=2, compute_dtype="bfloat16", backend="pallas")
    with torch.no_grad():
        conv.reset(torch.Generator().manual_seed(0))
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    calls = dict(K3.PLAIN_CALLS)
    want = conv(xt.clone().requires_grad_(True), mt)     # the autograd path
    assert want.grad_fn is not None
    assert K3.PLAIN_CALLS["masked_conv"] == calls["masked_conv"] + 1

    def no_function(*a, **k):
        raise AssertionError("the no-grad call went through _MaskedConvFn")

    monkeypatch.setattr(K3._MaskedConvFn, "apply", no_function)
    with torch.no_grad():
        got = conv(xt, mt)
    assert K3.PLAIN_CALLS["masked_conv"] == calls["masked_conv"] + 2
    got_free = conv(xt, mt)                              # nothing requires grad
    assert K3.PLAIN_CALLS["masked_conv"] == calls["masked_conv"] + 3
    assert torch.equal(got, want.detach()) and torch.equal(got_free, got)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, 32)
