"""The bookkeeping of the kernels' build, which needs no compiler: a library's
name covers the source and every local header it includes, so an edited
header rebuilds each kernel that shares it."""

import os

import pytest

from pixelsynth_tpu_torch.ops import _cuda

SHARED = "lmconv_layer.cuh"


@pytest.mark.parametrize("name,shares_layer", [
    ("lmconv_fused", True), ("masked_conv", True), ("gated_resnet", True),
    ("sort_kv", False), ("splat_blend", False)])
def test_source_files_follow_local_includes(name, shares_layer):
    files = [os.path.basename(p) for p in _cuda.source_files(name)]
    assert files[0] == f"{name}.cu"
    assert (SHARED in files) == shares_layer


def test_library_name_changes_with_a_shared_header(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(tmp_path))
    a0, b0 = _cuda._lib_path("a"), _cuda._lib_path("b")
    (tmp_path / "g.cuh").write_text("#pragma once\n// edited\n")
    assert _cuda._lib_path("a") != a0       # through h.cuh -> g.cuh
    assert _cuda._lib_path("b") == b0


def test_cuda_wrappers_refuse_cpu_tensors():
    import torch

    with pytest.raises(ValueError, match="CUDA"):
        _cuda.require(torch.zeros(2), "x", dtype=torch.float32)


def test_variant_build_is_a_library_of_its_own(tmp_path, monkeypatch):
    """Macros of a variant build (a part compiled out, for profiling) go
    into the library's name and into nvcc's command."""
    (tmp_path / "a.cu").write_text("int a;\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(tmp_path))
    plain = _cuda._lib_path("a")
    assert _cuda._lib_path("a", ()) == plain
    variant = _cuda._lib_path("a", ["LMK_NO_MMA"])
    assert variant != plain and variant != _cuda._lib_path("a", ["LMK_NO_COPY"])
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: "nvcc")
    cmd = _cuda._nvcc_cmd("a", "out.so", False, ["LMK_NO_MMA", "N=2"])
    assert "-DLMK_NO_MMA" in cmd and "-DN=2" in cmd
