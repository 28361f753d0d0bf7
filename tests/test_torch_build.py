"""The port's kernel build cache on the CPU (no nvcc needed): a library's
name hashes its source and the ``csrc`` headers the source includes,
followed transitively, so editing a header rebuilds only the libraries that
include it."""
import pytest

from nif_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "common.cuh").write_text("// shared helpers\n#pragma once\n")
    (tmp_path / "mma.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\n// v1\n")
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "b.cu").write_text('#include "mma.cuh"\n  #  include "common.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_includes(csrc):
    assert [p.name for p in _build._sources("a")] == ["a.cu", "common.cuh"]
    assert [p.name for p in _build._sources("b")] == ["b.cu", "mma.cuh", "common.cuh",
                                                      "inner.cuh"]


@pytest.mark.parametrize("header", ["mma.cuh", "inner.cuh"])
def test_header_edit_renames_only_its_users(csrc, header):
    a0, b0 = _build._target("a"), _build._target("b")
    (csrc / header).write_text((csrc / header).read_text() + "// edited\n")
    assert _build._target("a") == a0
    assert _build._target("b") != b0


def test_shared_header_edit_renames_every_user(csrc):
    a0, b0 = _build._target("a"), _build._target("b")
    (csrc / "common.cuh").write_text("// shared helpers, edited\n#pragma once\n")
    assert _build._target("a") != a0 and _build._target("b") != b0


def test_new_header_renames_nothing(csrc):
    a0, b0 = _build._target("a"), _build._target("b")
    (csrc / "new.cuh").write_text("#pragma once\n")
    assert (_build._target("a"), _build._target("b")) == (a0, b0)


def test_port_sources_include_what_they_use():
    names = {p.name for p in _build._sources("shapenet_linear_tc")}
    assert names == {"shapenet_linear_tc.cu", "mma_sm90.cuh", "shapenet_common.cuh"}
    assert "mma_sm90.cuh" not in {p.name for p in _build._sources("shapenet_linear")}


TC_HEADERS = {"stack_tc.cuh", "mma_sm90.cuh"}


def test_k8_tensor_core_sources():
    """The tensor-core K8 builds against the stacked-stream machinery it
    shares with the tensor-core K6, the mma helpers and the shared header;
    the CUDA-core K7/K8 library includes neither tensor-core header."""
    names = {p.name for p in _build._sources("shapenet_hess_tc")}
    assert names == {"shapenet_hess_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert not TC_HEADERS & {p.name for p in _build._sources("shapenet_hess")}


def test_k6_tensor_core_sources():
    """The tensor-core K6 builds against the same headers as the tensor-core
    K8; the CUDA-core K5/K6 library and the header every kernel includes
    include neither tensor-core header, so an edit to those rebuilds only
    the two tensor-core libraries."""
    names = {p.name for p in _build._sources("shapenet_jac_tc")}
    assert names == {"shapenet_jac_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert not TC_HEADERS & {p.name for p in _build._sources("shapenet_jac")}
    common = (_build.CSRC / "shapenet_common.cuh").read_bytes()
    assert not TC_HEADERS & {inc.decode() for inc in _build._INCLUDE.findall(common)}
    users = {path.stem for path in _build.CSRC.glob("*.cu")
             if "stack_tc.cuh" in {p.name for p in _build._sources(path.stem)}}
    assert users == {"shapenet_hess_tc", "shapenet_jac_tc"}
