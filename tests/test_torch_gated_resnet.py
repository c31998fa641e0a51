"""Kernel K4's plain version against the JAX package's fused gated-resnet
Pallas kernel (interpret mode), same numpy inputs, f32 compute.

atol 1e-4, not 1e-5: the block has two PONOs, whose rsqrt amplifies an f32
difference in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsynth_tpu.ops.gated_resnet_pallas import gated_resnet_pallas
from pixelsynth_tpu_torch.ops import gated_resnet_kernel as K4

B, H, W, F = 2, 8, 8, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(og=n(B, H, W, F), a=n(B, H, W, F),
                mask=(rng.uniform(size=(B, 9, H * W)) > 0.4).astype(np.float32),
                w1=n(9, 2 * F, F, s=0.1), b1=n(F, s=0.1),
                ws=n(2 * F, F, s=0.1), bs=n(F, s=0.1),
                w2=n(9, 2 * F, 2 * F, s=0.1), b2=n(2 * F, s=0.1))


@pytest.mark.parametrize("skip", [False, True])
def test_k4_plain_matches_pallas_f32(skip):
    d = _inputs(0)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    want = gated_resnet_pallas(
        j["og"], j["a"] if skip else None, j["mask"], j["w1"], j["b1"],
        j["ws"] if skip else None, j["bs"] if skip else None, j["w2"], j["b2"],
        compute_dtype="float32")
    before = dict(K4.PLAIN_CALLS), dict(K4.LAUNCHES)
    got = K4.gated_resnet_kernel(
        t["og"], t["a"] if skip else None, t["mask"], t["w1"], t["b1"],
        t["ws"] if skip else None, t["bs"] if skip else None, t["w2"], t["b2"],
        compute_dtype="float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert K4.PLAIN_CALLS["gated_resnet"] == before[0]["gated_resnet"] + 1
    assert K4.LAUNCHES == before[1]


def test_k4_plain_bf16_close_to_f32():
    """bf16 dot operands move the block's output by bf16 rounding only."""
    t = {k: torch.as_tensor(v) for k, v in _inputs(1).items()}
    args = (t["og"], t["a"], t["mask"], t["w1"], t["b1"], t["ws"], t["bs"],
            t["w2"], t["b2"])
    f32 = K4.gated_resnet_plain(*args, compute_dtype="float32")
    bf = K4.gated_resnet_plain(*args, compute_dtype="bfloat16")
    assert float((f32 - bf).abs().max()) < 0.1
    assert float((f32 - bf).abs().mean()) < 5e-3


@pytest.mark.parametrize("width", [16, 80])
@pytest.mark.parametrize("shape", ["conv1", "conv2", "skip", "dilated", "stacked"])
def test_packed_weight_image_unpacks_bit_for_bit(width, shape):
    """The shared-memory image the kernels copy in one piece per (tap, K
    slice): a permutation of the (taps, K, N) weights, element (k, n) of
    step (t, kc) where the `wgmma` descriptor looks for it."""
    from pixelsynth_tpu_torch.ops.conv_pack import pack_taps, unpack_taps

    Fw = width
    dims = {"conv1": (9, 2 * Fw, Fw), "conv2": (9, 2 * Fw, 2 * Fw),
            "skip": (1, 2 * Fw, Fw), "dilated": (9, Fw, Fw),
            "stacked": (3, 9, 2 * Fw, Fw)}[shape]
    rng = np.random.default_rng(width)
    w = torch.as_tensor(rng.standard_normal(dims).astype(np.float32)).to(torch.bfloat16)
    image = pack_taps(w, Fw)
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert image.shape == (*dims[:-3], dims[-3] * dims[-2] * dims[-1])
    T, K, N = dims[-3:]
    back = unpack_taps(image, T, K, N, Fw)
    assert torch.equal(back.view(torch.int16), w.view(torch.int16))
    # the documented place of single elements
    flat, w3 = image.reshape(-1, T * K * N)[-1], w.reshape(-1, T, K, N)[-1]
    for t, k, n in ((0, 0, 0), (T - 1, K - 1, N - 1), (T // 2, Fw + 3 if K > Fw else 5, 9),
                    (0, 8, 7), (T - 1, 7, 8)):
        kc, kk = divmod(k, Fw)
        at = (((t * (K // Fw) + kc) * (Fw // 8) + kk // 8) * N * 8
              + (n // 8) * 64 + (n % 8) * 8 + kk % 8)
        assert flat[at] == w3[t, k, n], (t, k, n)


def test_packed_taps_carry_the_plain_weights():
    """A wrapper given PackedTaps gives what it gives for the plain weights
    (on the CPU: through the plain version, which reads `.raw`)."""
    from pixelsynth_tpu_torch.ops.conv_pack import PackedTaps, prepare_taps, raw_taps

    t = {k: torch.as_tensor(v) for k, v in _inputs(2).items()}
    packed = {k: prepare_taps(t[k] if t[k].dim() == 3 else t[k][None], F)
              for k in ("w1", "ws", "w2")}
    assert all(isinstance(p, PackedTaps) and p.image.dtype == torch.bfloat16
               for p in packed.values())
    assert prepare_taps(packed["w1"], F) is packed["w1"]      # made once
    assert raw_taps(packed["w2"]) is t["w2"]
    with pytest.raises(ValueError):
        prepare_taps(packed["w1"], 2 * F)
    want = K4.gated_resnet_kernel(t["og"], t["a"], t["mask"], t["w1"], t["b1"],
                                  t["ws"], t["bs"], t["w2"], t["b2"])
    got = K4.gated_resnet_kernel(t["og"], t["a"], t["mask"], packed["w1"], t["b1"],
                                 packed["ws"], t["bs"], packed["w2"], t["b2"])
    assert torch.equal(got, want)
