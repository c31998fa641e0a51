"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and nvcc: the kernels have no CPU mode, so on a
machine without a card they skip.  This file imports neither JAX nor the
JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch
from torch_threads import _few_torch_threads  # noqa: F401


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("width", [32, 80])
def test_k1_matches_plain_on_card(width):
    """K1a/K1b at 4 candidates, 32x32 codes, on the three mask cases; F=80
    is the main path's.  Also 33 candidates and 8 of 16x16, 20 repeated
    calls bit-identical, one device kernel a pass."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k1({}, B=4, side=32, Fc=width)


@pytest.mark.gpu
@pytest.mark.parametrize("B,side", [(33, 32), (16, 16), (2, 16)])
def test_k1_rounds_and_two_tiles_on_card(B, side):
    """33 candidates: more than the card runs at once, so rounds of one
    launch; 16x16 codes: two tiles a candidate, one cluster (the stitched
    walk's grid).  Each pass against its plain version, then 20 calls
    bit-identical."""
    _need_card()
    import torch
    import chip_smoke
    from pixelsynth_tpu_torch.ops import lmconv_fused as K1

    chip_smoke._k1_check(f"({B}, {side})", B, side, 80)
    packed, u0, mu, md, *_ = chip_smoke._k1_inputs(B, side, 80)
    kw = dict(H=side, W=side, nr=2, dilation=2, compute_dtype="bfloat16")
    stack = K1.up(u0, mu, md, packed, **kw)
    out = K1.down(stack, mu, md, packed, **kw)
    for _ in range(20):
        assert torch.equal(K1.up(u0, mu, md, packed, **kw), stack)
        assert torch.equal(K1.down(stack, mu, md, packed, **kw), out)


@pytest.mark.gpu
@pytest.mark.parametrize("B,side,Fc,dtype", [
    (4, 32, 80, "float32"), (2, 48, 80, "bfloat16"), (4, 12, 80, "bfloat16"),
    (4, 16, 96, "bfloat16")])
def test_k1_k3_route_on_card(B, side, Fc, dtype):
    """K1's "k3" route (f32 compute; rows beyond the resident region,
    HW % 128 != 0, F > 80 in bf16) through `up` / `down` against the plain
    versions: 14 / 26 K3 launches a pass, no K1 launch, no plain version;
    f32 down within 1e-4 and each up entry within 1e-4 or one bf16 ulp,
    bf16 at K1's tolerance."""
    _need_card()
    import chip_smoke

    chip_smoke._k1_route_check(f"({B}, {side}) F={Fc}", B, side, Fc, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,side,Fc,dtype", [
    (4, 32, 80, "float32"), (4, 12, 80, "bfloat16"), (4, 16, 96, "bfloat16")])
def test_k4_k3_route_on_card(B, side, Fc, dtype):
    """K4's "k3" route through `gated_resnet_kernel`, with and without the
    skip, against the plain version: f32 within 1e-4, bf16 at K4's
    tolerance."""
    _need_card()
    import torch
    import chip_smoke

    chip_smoke._k4_route_check(f"({B}, {side}) F={Fc}", B, side, Fc, dtype,
                               torch.Generator().manual_seed(4))


@pytest.mark.gpu
def test_k2_matches_plain_on_card():
    """K2 from the binner's tables, every accumulation, at the bench
    protocol's size; coverage on points at the radius from the edges of its
    warps' rectangles; `splat()` launches no slot gather."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k2({})


@pytest.mark.gpu
@pytest.mark.parametrize("C", [9, 16, 64])
def test_k2_wide_features_match_plain_on_card(C):
    """K2 at C > 8 channels (one launch of ceil(C / 8) channel groups) on a
    view's own points and on points at the radius, against its plain
    version to 1e-5 of the output's scale; one launch a call."""
    _need_card()
    import chip_smoke

    chip_smoke.k2_wide_check(C)


@pytest.mark.gpu
def test_k3_matches_plain_on_card():
    """K3, bf16 (resident route: three mask cases, 20 calls bit-identical,
    one device kernel a call, the other cluster size's build) and float32
    kernels at the trunk's three conv shapes; the streamed route at
    48x48."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k3({}, B=4, side=32, Fc=80)


@pytest.mark.gpu
@pytest.mark.parametrize("B,side", [(4, 16), (16, 32), (17, 32), (5, 64)])
def test_k4_matches_plain_on_card(B, side):
    """K4 with and without the skip: 2, 8 and 32 blocks an image; 17 images
    of 32x32 and 5 of 64x64 take two rounds inside the launch.  At 32x32
    and 64x64 also on masks with every tap on and with whole tiles off (the
    two edges of the (tile, tap) skip)."""
    _need_card()
    import chip_smoke

    if side == 16:      # 256 positions: the whole-tile case would blank the image
        import torch

        gen = torch.Generator().manual_seed(4)
        _, pm, og, a, (w1, b1, ws, bs, w2, b2) = chip_smoke._k4_case(B, side, 80,
                                                                     "order", gen)
        chip_smoke._k4_check("no skip", (og, None, pm, w1, b1, None, None, w2, b2))
        chip_smoke._k4_check("skip", (og, a, pm, w1, b1, ws, bs, w2, b2))
    else:
        chip_smoke.phase_k4({}, B=B, side=side, Fc=80, others=())


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 48])
def test_k4_other_widths_on_card(width):
    """The narrow widths the layer body is also built for."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k4({}, B=4, side=32, Fc=width, others=())


@pytest.mark.gpu
def test_k5_is_the_stable_sort_on_card():
    """K5 at (1, 2^19), (2, 2^17) and on the three hard rows of 2^14 (all
    keys equal, negative keys with both int32 extremes, descending keys):
    exact against torch.sort(stable=True) and both plain versions."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k5({})


@pytest.mark.gpu
def test_k5_many_rows_on_card():
    """More tiles than the card keeps resident (16 rows of 2^19: 2048
    blocks), so the look-back waits on tiles taken earlier by ticket."""
    _need_card()
    import torch
    from pixelsynth_tpu_torch.ops import sort_kernel as K5

    gen = torch.Generator().manual_seed(9)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (16, 1 << 19), generator=gen,
                         dtype=torch.int64).to(torch.int32).cuda()
    sk, sv = K5.sort_kv_kernel(keys)
    ref_k, ref_v = torch.sort(keys, dim=1, stable=True)
    assert torch.equal(sk, ref_k) and torch.equal(sv.long(), ref_v)


@pytest.mark.gpu
def test_k3_pixelcnn_without_a_gradient_on_card():
    """A "pallas" PixelCNN on one-hot codes without a gradient (the stage-3
    trainer's val pass): the first layer (Cin 513, a shape the bf16 kernel
    does not take) runs K3's f32 kernel as it does under a gradient, so
    the loss equals the one with a gradient, and is within 2e-2 relative
    of the plain masked conv's."""
    _need_card()
    import chip_smoke
    from pixelsynth_tpu_torch.ops import masked_conv_kernel
    from pixelsynth_tpu_torch.train.lmconv import lmconv_loss

    cfg, model, state, batch, orders, codes = chip_smoke._lm_setup(2)
    codes_b, masks_b = batch()
    model.eval()
    want = lmconv_loss(model, codes_b, masks_b)
    before = masked_conv_kernel.LAUNCHES["masked_conv"]
    with torch.no_grad():
        got = lmconv_loss(model, codes_b, masks_b)
    assert masked_conv_kernel.LAUNCHES["masked_conv"] - before == 33
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0)
    with chip_smoke.plain_kernels(), torch.no_grad():
        plain = lmconv_loss(model, codes_b, masks_b)
    assert abs(float(got) - float(plain)) <= 2e-2 * abs(float(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("B,side", [(1, 32), (64, 32), (4, 16), (3, 7), (2, 48)])
def test_order_kernel_matches_plain_and_heap_on_card(B, side):
    """The order kernel against its plain version and the host heap, bit
    for bit, on grids with many equal distances, one launch a call."""
    _need_card()
    import numpy as np
    from pixelsynth_tpu_torch.ops import orders as O
    from pixelsynth_tpu_torch.ops import orders_device as D

    rng = np.random.default_rng(side + B)
    dist = torch.as_tensor(rng.integers(-3, 4, (B, side, side + 1)).astype(np.int32),
                           device="cuda")
    before = D.LAUNCHES["custom_order"]
    got = D.custom_order_device(dist)
    assert D.LAUNCHES["custom_order"] == before + 1
    assert torch.equal(got, D.custom_order_plain(dist))
    assert np.array_equal(got.cpu().numpy(), O.custom_order_flat(dist.cpu().numpy()))
