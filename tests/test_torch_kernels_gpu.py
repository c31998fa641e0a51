"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and nvcc: the kernels have no CPU mode, so on a
machine without a card they skip.  This file imports neither JAX nor the
JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("width", [32, 80])
def test_k1_matches_plain_on_card(width):
    """K1a/K1b at 4 candidates, 32x32 codes; F=80 is the main path's."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k1({}, B=4, side=32, Fc=width)


@pytest.mark.gpu
def test_k2_matches_plain_on_card():
    """K2, every accumulation, at the bench protocol's size."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k2({})


@pytest.mark.gpu
def test_k3_matches_plain_on_card():
    """K3, bf16 and float32 kernels, at the trunk's three conv shapes."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k3({}, B=4, side=32, Fc=80)


@pytest.mark.gpu
@pytest.mark.parametrize("B,side", [(4, 16), (16, 32), (5, 64)])
def test_k4_matches_plain_on_card(B, side):
    """K4 with and without the skip: 2, 8 and 32 blocks an image; 5 images
    of 64x64 take two rounds inside the launch."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k4({}, B=B, side=side, Fc=80)


@pytest.mark.gpu
def test_k5_is_the_stable_sort_on_card():
    """K5 at (1, 2^19) and (2, 2^17), exact against torch.sort(stable=True)."""
    _need_card()
    import chip_smoke

    chip_smoke.phase_k5({})
