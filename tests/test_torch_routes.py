"""The routes of K1 and K4 on the card, held on the CPU: which dtype and
shape takes the kernel and which the "k3" route (every masked conv, and
the nin skip as a one-tap conv, a K3 call), that the rule reads nothing
but dtype and shape and nothing in the wrappers catches an error and
carries on, and the "k3" passes' arithmetic against the plain versions
(on the CPU each K3 call takes its plain version)."""

import ast
import inspect

import numpy as np
import pytest
import torch

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4
from pixelsynth_tpu_torch.ops import lmconv_fused as K1
from pixelsynth_tpu_torch.ops import masked_conv_kernel as K3
from pixelsynth_tpu_torch.ops.distance_transform import signed_distance_field
from pixelsynth_tpu_torch.ops.orders import orders_and_masks
from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
from torch_threads import _few_torch_threads  # noqa: F401

# (H, W, F, nr, dilation, compute_dtype) -> K1 route, K3 dtype of its convs
K1_CASES = [
    ((32, 32, 80, 2, 2, "bfloat16"), "fused", "bfloat16"),   # the main path
    ((16, 16, 80, 2, 2, "bfloat16"), "fused", "bfloat16"),   # the relay's grid
    ((8, 16, 80, 2, 2, "bfloat16"), "fused", "bfloat16"),    # one tile
    ((40, 48, 80, 2, 2, "bfloat16"), "k3", "bfloat16"),      # rows_fit false
    ((32, 32, 80, 2, 2, "float32"), "k3", "float32"),
    ((48, 48, 80, 2, 2, "bfloat16"), "k3", "bfloat16"),      # rows beyond the region
    ((12, 12, 80, 2, 2, "bfloat16"), "k3", "float32"),       # HW % 128 != 0
    ((16, 16, 96, 2, 2, "bfloat16"), "k3", "float32"),       # F > 80
    ((16, 16, 24, 2, 2, "bfloat16"), "k3", "float32"),       # F % 16 != 0
    ((16, 16, 80, 5, 2, "bfloat16"), "k3", "bfloat16"),      # nr > 4
]


@pytest.mark.parametrize("args,route,k3", K1_CASES)
def test_k1_route_rule(args, route, k3):
    H, W, Fc, nr, dil, cdt = args
    assert K1.k1_route(*args) == route
    assert K3.k3_dtype(H * W, 2 * Fc, Fc, cdt) == k3
    if route == "fused":
        assert K1.rows_fit(W, dil, Fc)


@pytest.mark.parametrize("H,W,Fc,cdt,route", [
    (32, 32, 80, "bfloat16", "fused"), (16, 16, 16, "bfloat16", "fused"),
    (32, 32, 80, "float32", "k3"), (12, 12, 80, "bfloat16", "k3"),
    (16, 16, 96, "bfloat16", "k3"), (16, 16, 40, "bfloat16", "k3")])
def test_k4_route_rule(H, W, Fc, cdt, route):
    assert K4.k4_route(H, W, Fc, cdt) == route


def test_routes_read_dtype_and_shape_only():
    """The rules take plain numbers and a dtype name (no tensor, nothing to
    fail on), and no wrapper module catches an exception: a kernel error on
    the card raises instead of taking another route."""
    for fn in (K1.k1_route, K4.k4_route, K3.k3_dtype, K3.k3_route):
        assert all(p.annotation in (int, str, "int", "str")
                   for p in inspect.signature(fn).parameters.values()), fn
    for mod in (K1, K3, K4):
        tree = ast.parse(open(mod.__file__).read())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], mod.__name__


def _masks(B, side):
    bg = np.zeros((B, side, side), np.float32)
    bg[:, :, side // 2:] = 1.0
    bg = torch.as_tensor(bg)
    _, masks = orders_and_masks(signed_distance_field(1.0 - bg, bg))
    return (K1.fold_boundary_masks(masks[:, 1], side, side, 3, 1),
            K1.fold_boundary_masks(masks[:, 2], side, side, 3, 2))


@pytest.mark.parametrize("side,Fc,cdt", [(8, 16, "float32"), (12, 24, "bfloat16")])
def test_k1_k3_passes_match_plain(side, Fc, cdt):
    """`up_k3` / `down_k3` against `up_plain` / `down_plain`, 40 K3 calls a
    forward.  float32: down (from the same stack) within atol 1e-4; the up
    stack is bf16, so where the two f32 sums straddle a bf16 rounding
    boundary an entry is one bf16 ulp off: each entry within atol 1e-4 or
    one ulp, and the forward's argmax agreement >= 0.99.  bfloat16: K1's
    tolerance on the card, 2% of the range and argmax >= 0.97."""
    cfg = Config()
    cfg.model.lmconv.nr_filters = Fc
    packed = K1.pack_lmconv_params(
        random_pixelcnn_params(cfg, torch.Generator().manual_seed(0)), nr_resnet=2,
        compute_dtype=cdt)
    mu, md = _masks(2, side)
    u0 = torch.randn(2, side * side, Fc, generator=torch.Generator().manual_seed(1))
    kw = dict(W=side, nr=2, dilation=2, compute_dtype=cdt)
    calls = K3.PLAIN_CALLS["masked_conv"]
    stack_k = K1.up_k3(u0, mu, md, packed, H=side, **kw)
    stack_p = K1.up_plain(u0, mu, md, packed, **kw)
    out_k = K1.down_k3(stack_p, mu, md, packed, H=side, **kw)
    out_p = K1.down_plain(stack_p, mu, md, packed, **kw)
    assert K3.PLAIN_CALLS["masked_conv"] - calls == 40
    elu = torch.nn.functional.elu
    lk = elu(K1.down_k3(stack_k, mu, md, packed, H=side, **kw)) @ packed["nin_w"]
    lp = elu(out_p) @ packed["nin_w"]
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    d_up = (stack_k.float() - stack_p.float()).abs()
    if cdt == "float32":
        ulp = torch.exp2(torch.floor(torch.log2(stack_p.float().abs().clamp(min=2.0 ** -126))) - 7)
        assert bool((d_up <= torch.maximum(ulp, torch.tensor(1e-4))).all())
        assert float((out_k - out_p).abs().max()) <= 1e-4
        assert agree >= 0.99
    else:
        assert float(d_up.max()) <= 0.02 * max(1.0, float(stack_p.float().abs().max()))
        assert float((out_k - out_p).abs().max()) <= 0.02 * max(1.0, float(out_p.abs().max()))
        assert agree >= 0.97


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [False, True])
def test_k4_k3_route_matches_plain(cdt, skip):
    """`gated_resnet_k3` against `gated_resnet_plain`: on the CPU both sum
    the same products in the same order, so they agree to 1e-6; the nin
    skip is one centre-tap K3 call."""
    g = torch.Generator().manual_seed(2)
    B, side, Fc = 2, 8, 16
    og, a = torch.randn(2, B, side, side, Fc, generator=g)
    mask = (torch.rand(B, 9, side * side, generator=g) < 0.7).float()
    w1 = torch.randn(9, 2 * Fc, Fc, generator=g) * 0.1
    w2 = torch.randn(9, 2 * Fc, 2 * Fc, generator=g) * 0.1
    b1, b2 = torch.randn(Fc, generator=g) * 0.1, torch.randn(2 * Fc, generator=g) * 0.1
    ws, bs = torch.randn(2 * Fc, Fc, generator=g) * 0.1, torch.randn(Fc, generator=g) * 0.1
    args = (og, a if skip else None, mask, w1, b1, ws if skip else None,
            bs if skip else None, w2, b2)
    calls = K3.PLAIN_CALLS["masked_conv"]
    got = K4.gated_resnet_k3(*args, compute_dtype=cdt)
    assert K3.PLAIN_CALLS["masked_conv"] - calls == 2 + skip
    want = K4.gated_resnet_plain(*args, compute_dtype=cdt)
    assert float((got - want).abs().max()) <= 1e-6


def test_centre_tap_conv_is_the_pointwise_product():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 6, 10, generator=g)
    w, b = torch.randn(10, 7, generator=g), torch.randn(7, generator=g)
    y = K3.k3_layer_conv(x, K3.centre_mask(2, 24, "cpu"), K3.centre_taps(w), b,
                         compute_dtype="float32")
    assert torch.allclose(y, x @ w + b, atol=1e-5)
