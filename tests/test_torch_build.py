"""The port's kernel build cache on the CPU (no nvcc needed): a library's
name hashes its source and the ``csrc`` headers the source includes,
followed transitively, so editing a header rebuilds only the libraries that
include it."""
import importlib.util
import re

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
    # the CUDA-core K4 reaches the mma helpers only through the f32 tile header
    assert {p.name for p in _build._sources("shapenet_linear")} == {
        "shapenet_linear.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
        "shapenet_common.cuh"}
    # the CUDA-core K1 and K5 reverse body reach them only through it too
    assert {p.name for p in _build._sources("shapenet_fwd")} == {
        "shapenet_fwd.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
        "shapenet_common.cuh"}


# The sources that include the f32 tile header: the CUDA-core K1 and K5
# reverse body, the CUDA-core K2/K3 body, the CUDA-core K7/K8 body, the
# CUDA-core K5 tangent body / K6 source (K6's body for si <= 4) and the
# CUDA-core K4 body.
SIMT_USERS = {"shapenet_fwd", "shapenet_bwd", "shapenet_hess", "shapenet_jac",
              "shapenet_linear"}

# Each tensor-core header and the sources that include it, directly or not:
# the tensor-core sources, and the CUDA-core bodies on the f32 tile header
# (SIMT_USERS), whose bf16 instances take the bf16 sine from stack_tc.cuh;
# the wgmma K2/K3 and K7/K8 bodies take the sine and the split reduce from it
# too, the wgmma K1/K5 body the sine.
TC_USERS = {
    "mma_sm90.cuh": {"shapenet_bwd_tc", "shapenet_fwd_tc", "shapenet_hess_tc",
                     "shapenet_jac_tc", "shapenet_linear_tc", "shapenet_bwd_wgmma",
                     "shapenet_fwd_wgmma", "shapenet_hess_wgmma"} | SIMT_USERS,
    "stack_tc.cuh": {"shapenet_bwd_tc", "shapenet_fwd_tc", "shapenet_hess_tc",
                     "shapenet_jac_tc", "shapenet_bwd_wgmma", "shapenet_fwd_wgmma",
                     "shapenet_hess_wgmma"} | SIMT_USERS,
}
TC_HEADERS = set(TC_USERS)


def _entries(name):
    """The C entries ``int nif_...(`` that ``csrc/<name>.cu`` defines."""
    return set(re.findall(r"^int (nif_\w+)\(", (_build.CSRC / f"{name}.cu").read_text(),
                          re.MULTILINE))


def test_k8_tensor_core_sources():
    """The tensor-core K8 and K7 build into one library, against the
    stacked-stream machinery they share with the tensor-core K6 and K2, the
    mma helpers and the shared header; the CUDA-core K7/K8 library builds on
    the f32 tile header, which includes the tensor-core headers for the bf16
    sine (as the CUDA-core K2/K3 library does), and keeps its own entries."""
    names = {p.name for p in _build._sources("shapenet_hess_tc")}
    assert names == {"shapenet_hess_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert {p.name for p in _build._sources("shapenet_hess")} == {
        "shapenet_hess.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
        "shapenet_common.cuh"}
    assert {"nif_shapenet_hess_tc_workspace", "nif_shapenet_hessian_grads_tc",
            "nif_shapenet_fwd_hess_tc_workspace", "nif_shapenet_fwd_hess_tc"} <= _entries(
                "shapenet_hess_tc")
    assert {"nif_shapenet_fwd_hess", "nif_shapenet_hessian_grads"} <= _entries("shapenet_hess")


def test_k6_tensor_core_sources():
    """The tensor-core K6 builds against the stacked-stream machinery, the mma
    helpers and the shared header; the CUDA-core K5/K6 library reaches the
    tensor-core headers only through the f32 tile header (K6's bf16 sine),
    and the header every kernel includes includes none, so an edit to one
    rebuilds only its users."""
    names = {p.name for p in _build._sources("shapenet_jac_tc")}
    assert names == {"shapenet_jac_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert {p.name for p in _build._sources("shapenet_jac")} == {
        "shapenet_jac.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
        "shapenet_common.cuh"}
    common = (_build.CSRC / "shapenet_common.cuh").read_bytes()
    assert not TC_HEADERS & {inc.decode() for inc in _build._INCLUDE.findall(common)}
    for header, expected in TC_USERS.items():
        users = {path.stem for path in _build.CSRC.glob("*.cu")
                 if header in {p.name for p in _build._sources(path.stem)}}
        assert users == expected, header


def test_k2_tensor_core_sources():
    """The tensor-core K2 builds against the same headers as the tensor-core
    K7 and K8; the CUDA-core K2/K3 library includes them too (its bf16
    instances take stack_tc.cuh's bf16 sine), so an edit to one rebuilds
    both, and each library defines the entries its wrapper loads (the
    tensor-core library K2's and K3's)."""
    names = {p.name for p in _build._sources("shapenet_bwd_tc")}
    assert names == {"shapenet_bwd_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert TC_HEADERS <= {p.name for p in _build._sources("shapenet_bwd")}
    assert {"nif_shapenet_mse_tc_workspace", "nif_shapenet_mse_grads_tc",
            "nif_shapenet_bwd_tc_workspace", "nif_shapenet_bwd_tc"} <= _entries("shapenet_bwd_tc")
    assert {"nif_shapenet_mse_grads", "nif_shapenet_bwd"} <= _entries("shapenet_bwd")


def test_k2_k3_wgmma_sources():
    """The wgmma K2/K3 body builds against its PTX header (wgmma, TMA,
    mbarriers, setmaxnreg) and the stacked-stream header (the bf16 sine and
    the ordered split reduce, with what that includes); it defines the
    entries its wrapper loads, K2's and K3's under the mma.sync entries'
    signatures."""
    names = {p.name for p in _build._sources("shapenet_bwd_wgmma")}
    assert names == {"shapenet_bwd_wgmma.cu", "wgmma_sm90.cuh", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    entries = _entries("shapenet_bwd_wgmma")
    assert {"nif_shapenet_mse_wg_workspace", "nif_shapenet_mse_grads_wg",
            "nif_shapenet_bwd_wg_workspace", "nif_shapenet_bwd_wg"} <= entries
    signature = re.compile(r"^int (nif_\w+)\(([^)]*)\)", re.MULTILINE)
    tc = dict(signature.findall((_build.CSRC / "shapenet_bwd_tc.cu").read_text()))
    wg = dict(signature.findall((_build.CSRC / "shapenet_bwd_wgmma.cu").read_text()))
    for mine, theirs in (("nif_shapenet_mse_grads_wg", "nif_shapenet_mse_grads_tc"),
                         ("nif_shapenet_bwd_wg", "nif_shapenet_bwd_tc"),
                         ("nif_shapenet_mse_wg_workspace", "nif_shapenet_mse_tc_workspace"),
                         ("nif_shapenet_bwd_wg_workspace", "nif_shapenet_bwd_tc_workspace")):
        assert " ".join(wg[mine].split()) == " ".join(tc[theirs].split()), mine


def test_k1_k5_wgmma_sources():
    """The wgmma K1/K5 reverse body builds against the same headers as the
    wgmma K2/K3 body (the PTX header, and the stacked-stream header for the
    bf16 sine) and defines the entries its wrapper loads, K1's and K5's
    under the mma.sync entries' signatures (``shapenet_fwd_tc.cu``)."""
    names = {p.name for p in _build._sources("shapenet_fwd_wgmma")}
    assert names == {"shapenet_fwd_wgmma.cu", "wgmma_sm90.cuh", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert {"nif_shapenet_fwd_wg_workspace", "nif_shapenet_fwd_wg",
            "nif_shapenet_fwd_jac_wg_workspace", "nif_shapenet_fwd_jac_wg"} <= _entries(
                "shapenet_fwd_wgmma")
    signature = re.compile(r"^int (nif_\w+)\(([^)]*)\)", re.MULTILINE)
    tc = dict(signature.findall((_build.CSRC / "shapenet_fwd_tc.cu").read_text()))
    wg = dict(signature.findall((_build.CSRC / "shapenet_fwd_wgmma.cu").read_text()))
    for mine, theirs in (("nif_shapenet_fwd_wg", "nif_shapenet_fwd_tc"),
                         ("nif_shapenet_fwd_jac_wg", "nif_shapenet_fwd_jac_tc"),
                         ("nif_shapenet_fwd_wg_workspace", "nif_shapenet_fwd_tc_workspace"),
                         ("nif_shapenet_fwd_jac_wg_workspace", "nif_shapenet_fwd_jac_tc_workspace")):
        assert " ".join(wg[mine].split()) == " ".join(tc[theirs].split()), mine


def test_k7_k8_wgmma_sources():
    """The wgmma K7/K8 body builds against the same headers as the other
    wgmma bodies (the PTX header, and the stacked-stream header for the bf16
    sine, the pair order and the ordered split reduce) and defines the
    entries its wrapper loads, K7's and K8's under the mma.sync entries'
    signatures (``shapenet_hess_tc.cu``), and the counter entry of its
    phase-clock build."""
    names = {p.name for p in _build._sources("shapenet_hess_wgmma")}
    assert names == {"shapenet_hess_wgmma.cu", "wgmma_sm90.cuh", "stack_tc.cuh",
                     "mma_sm90.cuh", "shapenet_common.cuh"}
    assert {"nif_shapenet_hess_wg_workspace", "nif_shapenet_hessian_grads_wg",
            "nif_shapenet_fwd_hess_wg_workspace", "nif_shapenet_fwd_hess_wg",
            "nif_hwg_phase_cycles"} <= _entries("shapenet_hess_wgmma")
    signature = re.compile(r"^int (nif_\w+)\(([^)]*)\)", re.MULTILINE)
    tc = dict(signature.findall((_build.CSRC / "shapenet_hess_tc.cu").read_text()))
    wg = dict(signature.findall((_build.CSRC / "shapenet_hess_wgmma.cu").read_text()))
    for mine, theirs in (("nif_shapenet_hessian_grads_wg", "nif_shapenet_hessian_grads_tc"),
                         ("nif_shapenet_fwd_hess_wg", "nif_shapenet_fwd_hess_tc"),
                         ("nif_shapenet_hess_wg_workspace", "nif_shapenet_hess_tc_workspace"),
                         ("nif_shapenet_fwd_hess_wg_workspace",
                          "nif_shapenet_fwd_hess_tc_workspace")):
        assert " ".join(wg[mine].split()) == " ".join(tc[theirs].split()), mine


def test_wgmma_header_edit_renames_only_the_wgmma_library(tmp_path, monkeypatch):
    """On a copy of the port's sources: editing the wgmma/TMA/mbarrier
    header renames the three wgmma libraries (K1/K5, K2/K3 and K7/K8) and
    no other."""
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = sorted(path.stem for path in tmp_path.glob("*.cu"))
    before = {name: _build._target(name) for name in names}
    header = tmp_path / "wgmma_sm90.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert {name for name in names if _build._target(name) != before[name]} == {
        "shapenet_bwd_wgmma", "shapenet_fwd_wgmma", "shapenet_hess_wgmma"}


def test_k1_k5_tensor_core_sources():
    """The tensor-core K1 and K5's tensor-core reverse body build into one
    library against the same headers as the other tensor-core kernels; the
    CUDA-core K1 and K5 reverse body (one body) reach the tensor-core headers
    only through the f32 tile header (their bf16 sine), as the CUDA-core K5
    tangent body / K6 library does; each library defines every entry its
    wrapper loads, the reverse body's beside K1's."""
    names = {p.name for p in _build._sources("shapenet_fwd_tc")}
    assert names == {"shapenet_fwd_tc.cu", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    assert {p.name for p in _build._sources("shapenet_fwd")} == {
        "shapenet_fwd.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
        "shapenet_common.cuh"}
    assert "stack_simt.cuh" in {p.name for p in _build._sources("shapenet_jac")}
    assert {"nif_shapenet_fwd_tc_workspace", "nif_shapenet_fwd_tc",
            "nif_shapenet_fwd_jac_tc_workspace", "nif_shapenet_fwd_jac_tc"} <= _entries(
                "shapenet_fwd_tc")
    assert {"nif_shapenet_fwd", "nif_shapenet_fwd_geometry", "nif_shapenet_fwd_jac_rev",
            "nif_shapenet_fwd_jac_rev_workspace"} <= _entries("shapenet_fwd")
    assert {"nif_shapenet_fwd_jac", "nif_shapenet_jac_workspace"} <= _entries("shapenet_jac")


def test_k2_k3_cuda_core_sources():
    """The CUDA-core K2/K3 body builds against the f32 tile header, the
    shared one and stack_tc.cuh (one bf16 sine for every fused kernel on
    Hopper, with what it includes); the f32 tile header has five users, the
    K1/K5-reverse, K2/K3, K7/K8, K5-tangent/K6 and K4 libraries, so an edit to
    it rebuilds those alone; each defines the entries its wrapper loads."""
    names = {p.name for p in _build._sources("shapenet_bwd")}
    assert names == {"shapenet_bwd.cu", "stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh",
                     "shapenet_common.cuh"}
    users = {path.stem for path in _build.CSRC.glob("*.cu")
             if "stack_simt.cuh" in {p.name for p in _build._sources(path.stem)}}
    assert users == SIMT_USERS
    assert {"nif_shapenet_bwd_workspace", "nif_shapenet_mse_grads",
            "nif_shapenet_bwd"} <= _entries("shapenet_bwd")
    assert {"nif_shapenet_hess_workspace", "nif_shapenet_fwd_hess",
            "nif_shapenet_hessian_grads"} <= _entries("shapenet_hess")
    assert {"nif_shapenet_jac_workspace", "nif_shapenet_sobolev_grads"} <= _entries(
        "shapenet_jac")
    assert {"nif_linear_workspace", "nif_linear_mse_grads"} <= _entries("shapenet_linear")


def test_simt_header_edit_renames_only_the_k2_k3_library(tmp_path, monkeypatch):
    """On a copy of the port's sources: editing the f32 tile header renames
    the libraries of its users, the CUDA-core K1/K5-reverse, K2/K3, K7/K8,
    K5-tangent/K6 and K4 sources, and no other."""
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = sorted(path.stem for path in tmp_path.glob("*.cu"))
    before = {name: _build._target(name) for name in names}
    header = tmp_path / "stack_simt.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert {name for name in names if _build._target(name) != before[name]} == SIMT_USERS


def test_phase_probe_reads_every_counter_array():
    """The phase probe's counter buffer holds the longest array a probe
    build's C entry copies out, so no read runs past it; and each kernel the
    probe splits (the float32 K1/K5-reverse, K4, K6 and K7/K8 bodies' and
    K5's tangent bodies among them) names a source that builds its counter
    array under the probe's define, defines the entry the probe reads, and
    counts at least the phases the probe prints in that array."""
    path = _build.CSRC.parents[1] / "scripts" / "port_phase_probe.py"
    probe = path.read_text()
    room = int(re.search(r"^COUNTER_ROOM = (\d+)$", probe, re.MULTILINE).group(1))
    counts = [int(n) for path in _build.CSRC.glob("*.cu")
              for n in re.findall(r"constexpr int k\w*Phases = (\d+);", path.read_text())]
    assert counts and room >= max(counts)
    spec = importlib.util.spec_from_file_location("port_phase_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert {"k1f32", "k2f32", "k3f32", "k4f32", "k5f32", "k5tan", "k5tanf32", "k6f32", "k7f32",
            "k8f32"} <= set(module.KERNELS)
    for kernel, (name, define, entry, phases) in module.KERNELS.items():
        source = (_build.CSRC / f"{name}.cu").read_text()
        block = source[source.index(f"#ifdef {define}"):]
        assert re.search(rf"^int {entry}\(unsigned long long\* out\)", block, re.MULTILINE), kernel
        size = re.search(r"__device__ unsigned long long \w+\[(\w+)\];", block).group(1)
        n = re.search(rf"constexpr int {size} = (\d+);", source)
        assert n and len(phases) <= int(n.group(1)) <= room, kernel


@pytest.mark.parametrize("header", sorted(TC_HEADERS))
def test_tensor_core_header_edit_renames_only_the_tensor_core_libraries(header, tmp_path,
                                                                       monkeypatch):
    """On a copy of the port's sources: editing a tensor-core header renames
    the libraries of the tensor-core sources that include it, and of the
    CUDA-core sources on the f32 tile header (their bf16 sine), and no other."""
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = sorted(path.stem for path in tmp_path.glob("*.cu"))
    before = {name: _build._target(name) for name in names}
    (tmp_path / header).write_text((tmp_path / header).read_text() + "// edited\n")
    renamed = {name for name in names if _build._target(name) != before[name]}
    assert renamed == TC_USERS[header]
