"""What the masked-conv layer body (csrc/lmconv_layer.cuh) wants laid out
once, outside the sampling loop: the conv weights as the exact
shared-memory image of every ring step, and the table of (tile, tap)
pairs that have any position on.

Weight image.  A ring step is (tap t, F-wide slice kc of K): its (F, N)
weights are read by `wgmma` as B, K-major without swizzle: core matrices
of 8 output channels x 8 input channels (128 contiguous bytes, an output
channel's 8 inputs 16 bytes), the N/8 core matrices of one input-channel
group after one another, then the next group.  So element (k, n) of step
(t, kc) lies at

    ((t * K/F + kc) * F/8 + k // 8) * N * 8 + (n // 8) * 64 + (n % 8) * 8 + k % 8

and one bulk copy of F * N contiguous elements brings a step's weights.

Tile table.  The body's block owns TILE = 128 flat positions; a tap whose
mask is 0 at all of them is no ring step.  `tile_tap_table` marks the
(tile, tap) pairs that have any position on.

Resident rows.  K1's pass and K3's resident route keep a tile's operand
rows and the halo each side in RESIDENT_ROW_BYTES of shared memory
(csrc/resident_rows.cuh A_REGION), a row of K channels in 2K + 16 bytes;
`resident_rows_fit` says whether a conv's rows fit.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

TILE = 128   # positions a block of the layer body owns (TP in the header)
RESIDENT_ROW_BYTES = 72 * 1024


def resident_rows_fit(W: int, dilation: int, K: int, tile: int = TILE) -> bool:
    """Whether a tile's rows of K channels and the halo each side (the
    largest shift of a 3x3 conv at `dilation` on a width-W grid: d W + d
    rows) fit the resident region."""
    halo = dilation * W + dilation
    return (tile + 2 * halo) * (2 * K + 16) <= RESIDENT_ROW_BYTES


def pack_taps(w: torch.Tensor, F: int) -> torch.Tensor:
    """(..., T, K, N) weights, K and N each F or 2F -> the flat image of
    every (tap, K slice) step, same dtype and element count, with the
    leading dimensions kept: (..., T * K * N)."""
    *lead, T, K, N = w.shape
    if K % F or N % 8 or F % 8:
        raise ValueError(f"cannot pack (K, N) = ({K}, {N}) at width {F}")
    L = len(lead)
    x = w.reshape(*lead, T, K // F, F // 8, 8, N // 8, 8)   # t, kc, kj, ki, nj, ni
    x = x.permute(*range(L), L, L + 1, L + 2, L + 4, L + 5, L + 3)
    return x.reshape(*lead, T * K * N).contiguous()


def unpack_taps(image: torch.Tensor, T: int, K: int, N: int, F: int) -> torch.Tensor:
    """The inverse of `pack_taps`: (..., T * K * N) -> (..., T, K, N)."""
    lead = image.shape[:-1]
    L = len(lead)
    x = image.reshape(*lead, T, K // F, F // 8, N // 8, 8, 8)  # t, kc, kj, nj, ni, ki
    x = x.permute(*range(L), L, L + 1, L + 2, L + 5, L + 3, L + 4)
    return x.reshape(*lead, T, K, N).contiguous()


class PackedTaps(NamedTuple):
    """Conv weights in the kernels' layout beside the ones they came from."""

    image: torch.Tensor   # (T * K * N,) bf16: `pack_taps` of the weights
    raw: torch.Tensor     # (T, K, N): the plain versions and the backward read these
    width: int            # the layer width F the image was packed at


TapsArg = Union[torch.Tensor, PackedTaps]


def prepare_taps(w: TapsArg, F: int) -> PackedTaps:
    """(T, K, N) weights (any float dtype) -> PackedTaps at width F: cast to
    bf16 and laid out once.  A model does this where it casts its weights,
    outside the sampling loop; a wrapper given plain weights does it at
    every call."""
    if isinstance(w, PackedTaps):
        if w.width != F:
            raise ValueError(f"weights packed at width {w.width}, the layer has {F}")
        return w
    return PackedTaps(pack_taps(w.detach().to(torch.bfloat16).contiguous(), F), w, F)


def raw_taps(w: TapsArg) -> torch.Tensor:
    return w.raw if isinstance(w, PackedTaps) else w


def tile_tap_table(rows: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """rows (B, HW, k2) mask rows (folded or raw), HW a multiple of `tile`
    -> (B, HW // tile, k2) int32: 1 where any position of the tile has
    the tap on."""
    B, HW, K2 = rows.shape
    if HW % tile:
        raise ValueError(f"HW = {HW} is not a multiple of the tile {tile}")
    on = (rows != 0).reshape(B, HW // tile, tile, K2).any(2)
    return on.to(torch.int32).contiguous()


def skipped_share(table: torch.Tensor) -> float:
    """Share of (tile, tap) steps the table turns off."""
    return 1.0 - float(table.float().mean())
