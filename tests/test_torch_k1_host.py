"""The host side of K1's persistent passes (ops/lmconv_fused.py), on the
CPU: the dependency window from the tap shifts, the one-time check of the
packed weights, and the workspace cache."""

import pytest
import torch

from pixelsynth_tpu_torch.config import Config
from pixelsynth_tpu_torch.ops import lmconv_fused as K1
from pixelsynth_tpu_torch.pipeline import random_pixelcnn_params
from torch_threads import _few_torch_threads  # noqa: F401


@pytest.mark.parametrize("W,dilation,want", [
    (32, 2, 1),     # the main path: |s| <= 66 rows, within one tile
    (16, 2, 1),     # the stitched walk's grid
    (64, 2, 2),     # 2 * 64 + 2 = 130 > 128
    (64, 1, 1),
    (128, 2, 3),    # 258 rows
])
def test_dependency_window(W, dilation, want):
    assert K1.dependency_window(W, dilation) == want
    reach = max(abs(s) for d in (1, dilation) for s in K1.shifts(3, d, W))
    assert (want - 1) * K1.TILE < reach <= want * K1.TILE


@pytest.mark.parametrize("W,dilation,Fc,fits", [
    (32, 2, 80, True),      # the main path: 194 rows of 336 B, 260 of 176 B
    (16, 2, 80, True),      # the stitched walk's grid
    (44, 2, 80, True),      # 218 rows of 336 B: the widest grid at F = 80
    (45, 2, 80, False),
    (64, 2, 32, True),      # narrower rows: 258 of 144 B
])
def test_rows_fit(W, dilation, Fc, fits):
    assert K1.rows_fit(W, dilation, Fc) is fits


@pytest.fixture(scope="module")
def packed():
    cfg = Config()
    cfg.model.lmconv.nr_filters = 16
    cfg.model.lmconv.input_channels = cfg.model.lmconv.num_classes = 16
    params = random_pixelcnn_params(cfg, torch.Generator().manual_seed(0))
    return K1.pack_lmconv_params(params, nr_resnet=2, compute_dtype="bfloat16")


def test_packed_weights_checked_once(packed):
    assert packed["k1_checked"] == (2, 16, "cpu")
    shapes = K1.packed_shapes(2, 16)
    assert shapes["dw2_img"] == (torch.bfloat16, (8, 9 * 32 * 32))
    for name, (dt, shape) in shapes.items():
        assert packed[name].dtype == dt and tuple(packed[name].shape) == shape
    bad = dict(packed)
    bad["db2"] = bad["db2"][:, :16].contiguous()
    with pytest.raises(ValueError, match="db2"):
        K1.check_packed(bad, 2)
    bad = dict(packed)
    bad["uw2_img"] = bad["uw2_img"].float()
    with pytest.raises(ValueError, match="uw2_img"):
        K1.check_packed(bad, 2)
    with pytest.raises(ValueError, match="lack"):
        K1.check_packed({k: v for k, v in packed.items() if k != "ddw_img"}, 2)
    # f32 packing has no images: nothing to check for the kernel
    cfg_f32 = {k: v for k, v in packed.items() if not k.endswith("_img")}
    with pytest.raises(ValueError, match="lack"):
        K1.check_packed(cfg_f32, 2)


def test_workspace_cache():
    K1._WORKSPACES.clear()
    a = K1.workspace(2, 256, 16, "cpu")
    assert K1.workspace(2, 256, 16, torch.device("cpu")) is a
    assert a.ue.shape == a.xe.shape == (2, 256, 32) and a.ubf.shape == (2, 256, 16)
    assert a.ue.dtype == a.ubf.dtype == torch.bfloat16
    # one counter a (candidate, tile), one grid-wide count, zero when made
    assert a.flags.shape == (2 * 2 + 1,) and not a.flags.any()
    assert [a.next_epoch(), a.next_epoch()] == [1, 2]
    assert K1.workspace(3, 256, 16, "cpu") is not a
    for b in range(K1.WORKSPACES_KEPT):
        K1.workspace(4 + b, 256, 16, "cpu")
    assert len(K1._WORKSPACES) == K1.WORKSPACES_KEPT
    assert K1.workspace(2, 256, 16, "cpu") is not a     # the oldest was dropped
    K1._WORKSPACES.clear()


def test_profile_stage_names_and_times():
    from pixelsynth_tpu_torch.tools.profile_k1 import layer_kinds, stage_us

    up, down = layer_kinds(2, True), layer_kinds(2, False)
    assert len(up) == 1 + 14 and len(down) == 1 + 18
    assert up[:4] == ["phase 0", "gated conv 1", "gated conv 2", "gated conv 1"]
    assert up.count("dilated") == down.count("dilated") == 2
    assert down.count("gated conv 2") == 3 * 2 + 2
    # two blocks that ran, one that did not: phase 0 and one layer
    st = torch.zeros(3, 256, dtype=torch.int64)
    for blk, base in ((0, 1000), (1, 2000)):
        st[blk, 255] = base
        st[blk, 0] = base + 2000                                  # phase 0 published
        st[blk, 8:15] = torch.tensor([12000, 4000, 5000, 7000, 8000, 10000, 10500]) + base
    got = stage_us(st.flatten(), 2)
    assert got[0] == {"stage": pytest.approx(2.0)}
    assert got[1] == {"stage": pytest.approx(10.0), "neighbours": pytest.approx(2.0),
                      "rows": pytest.approx(1.0), "products": pytest.approx(2.0),
                      "products, warpgroup 1 after 0": pytest.approx(1.0),
                      "epilogue 0": pytest.approx(3.0), "epilogue 1": pytest.approx(2.5),
                      "publish": pytest.approx(1.5)}
