"""The routing of the port's kernel wrappers between their variants, and
their ctypes bindings, on the CPU (no nvcc needed).

K1, K2, K3, K5 and K7, like K4, K6 and K8, have a tensor-core variant for
bfloat16 and a CUDA-core one for float32: without a chain the choice reads
the dtype alone, a float32 input never asks a library, and a bfloat16 one
with a chain asks only the library of the tensor-core body its mode takes
(K5's reverse body, so < si, or its tangent body). On CPU tensors the entries run the
plain versions and launch nothing, and the CUDA wrappers refuse CPU tensors
before they load a library. Each wrapper's ``argtypes`` must match the C
signature of the entry in its source (a ctypes mismatch passes a pointer as
a 32-bit int and would show only on the card)."""
import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_derivatives as fd
from nif_tpu_torch.ops import fused_hessian as fh
from nif_tpu_torch.ops import fused_linear as fl
from nif_tpu_torch.ops import fused_shapenet as fs

torch.set_num_threads(1)

SIREN = (3, 1, 16, 2, "sine", False, 30.0)
RESBLOCK = (2, 2, 16, 1, "sine", True, 10.0)


def _data(cfg, G, P, dtype, seed):
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    tgt = rng.standard_normal((G, P, cfg.output_dim))
    w = rng.uniform(0.5, 1.5, (G, P))
    to = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(dt)  # noqa: E731
    return to(wb), to(x), to(tgt, torch.float32), to(w, torch.float32)


@pytest.mark.parametrize("pick", [fs.k1_variant, fs.k2_variant, fs.k3_variant, fd.k5_variant,
                                  fh.k7_variant], ids=["k1", "k2", "k3", "k5", "k7"])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tc"), (torch.float32, "simt"),
                                           (torch.float64, "simt")], ids=["bf16", "f32", "f64"])
def test_variant_by_dtype_asks_no_library(pick, dtype, variant, monkeypatch):
    """bfloat16 prefers the tensor-core kernel; float32 (and any other dtype,
    which the wrappers refuse) runs the CUDA-core one, and with a chain given
    it still asks no kernel library."""
    def no_library(name):
        raise AssertionError(f"asked the {name} library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert pick(dtype) == variant
    if dtype != torch.bfloat16:
        assert pick(dtype, ShapeNetConfig(*SIREN), "siren") == "simt"


TANGENT_CHAINS = [(2, 2, 16, 1, "sine", False, 30.0), RESBLOCK, (1, 3, 16, 2, "sine", False, 30.0)]
TANGENT_IDS = ["so2-si2", "resblock", "so3-si1"]


@pytest.mark.parametrize("args", TANGENT_CHAINS, ids=TANGENT_IDS)
def test_k5_tangent_body_runs_on_the_cuda_core_kernel_without_a_library(args, monkeypatch):
    """so >= si takes K5's tangent body: float32 runs it on the CUDA-core
    kernel, decided without asking any library, with the chain given or not;
    bfloat16 without a chain prefers the tensor-core kernel, also without a
    library."""
    def no_library(name):
        raise AssertionError(f"asked the {name} library")

    monkeypatch.setattr(_build, "load_library", no_library)
    cfg = ShapeNetConfig(*args)
    assert fd._jac_mode(cfg, cfg.input_dim) == "tangent"
    assert fd.k5_variant(torch.float32, cfg, "siren") == "simt"
    assert fd.k5_variant(torch.float32, cfg, "siren", cfg.input_dim) == "simt"
    assert fd.k5_variant(torch.bfloat16) == "tc"


class _StatusLibrary:
    """A library whose entries return a fixed status and record their calls
    (the last arguments of each in ``args``)."""

    def __init__(self, status):
        self.status, self.calls, self.args = status, [], {}

    def __getattr__(self, name):
        if not name.startswith("nif_"):
            raise AttributeError(name)
        entry = _StatusEntry(self, name)
        setattr(self, name, entry)
        return entry


class _StatusEntry:
    argtypes = None
    restype = None

    def __init__(self, lib, name):
        self.lib, self.name = lib, name

    def __call__(self, *args):
        self.lib.calls.append(self.name)
        self.lib.args[self.name] = args
        return self.lib.status


@pytest.mark.parametrize("status,kernel", [(0, "tc"), (2, "simt")], ids=["fits", "refused"])
@pytest.mark.parametrize("args", TANGENT_CHAINS, ids=TANGENT_IDS)
def test_k5_tangent_body_in_bf16_asks_only_the_tensor_core_library(args, status, kernel,
                                                                   monkeypatch):
    """Given a chain, bfloat16 K5 at so >= si asks the tensor-core tangent
    body's workspace entry (``shapenet_jac_tc``), and nothing else, whether
    it takes the shape: "tc" where it does, "simt" (the CUDA-core body)
    where it does not."""
    libs = {"shapenet_jac_tc": _StatusLibrary(status)}

    def load(name):
        if name not in libs:
            raise AssertionError(f"asked the {name} library")
        return libs[name]

    monkeypatch.setattr(_build, "load_library", load)
    cfg = ShapeNetConfig(*args)
    assert fd.k5_variant(torch.bfloat16, cfg, "siren") == kernel
    assert libs["shapenet_jac_tc"].calls == ["nif_shapenet_fwd_jac_tan_tc_workspace"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("args", [SIREN, RESBLOCK], ids=["siren", "resblock"])
def test_cpu_entries_run_the_plain_versions(args, dtype):
    """On CPU tensors ``shapenet_grouped_fused``, ``shapenet_mse_grads``,
    ``shapenet_fwd_jac`` and ``shapenet_fwd_hess`` return exactly what their
    plain versions return, and launch no kernel."""
    cfg = ShapeNetConfig(*args)
    wb, x, tgt, w = _data(cfg, 2, 24, dtype, seed=1)
    before = dict(_build.LAUNCHES)
    out = fs.shapenet_grouped_fused(wb, x, cfg, "siren")
    ref = fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren")
    assert torch.equal(out, ref) and out.dtype == dtype
    for mine, ref in zip(fd.shapenet_fwd_jac(wb, x, cfg, "siren"),
                         fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")):
        assert torch.equal(mine, ref) and mine.dtype == dtype
    loss, d_wb = fs.shapenet_mse_grads(wb, x, tgt, cfg, "siren", w)
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert torch.equal(loss, l_ref) and torch.equal(d_wb, g_ref) and d_wb.dtype == dtype
    outs = fh.shapenet_fwd_hess(wb, x, cfg, "siren")
    for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        assert torch.equal(mine, ref) and mine.dtype == dtype
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("launch", [
    lambda wb, x, tgt, cfg: fs.shapenet_fwd_cuda(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fs._shapenet_fwd_simt(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fd._shapenet_fwd_jac_simt(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, "siren"),
    lambda wb, x, tgt, cfg: fs._shapenet_mse_grads_simt(wb, x, tgt, cfg, "siren"),
    lambda wb, x, tgt, cfg: fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fh._shapenet_fwd_hess_simt(wb, x, cfg, "siren"),
    lambda wb, x, tgt, cfg: fs.shapenet_bwd_cuda(wb, x, tgt.to(x.dtype), cfg, "siren"),
    lambda wb, x, tgt, cfg: fs._shapenet_bwd_simt(wb, x, tgt.to(x.dtype), cfg, "siren"),
], ids=["k1", "k1-simt", "k5", "k5-simt", "k2", "k2-simt", "k7", "k7-simt", "k3", "k3-simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wrappers_refuse_cpu_tensors_before_any_library(launch, dtype, monkeypatch):
    def no_library(name):
        raise AssertionError(f"asked the {name} library")

    monkeypatch.setattr(_build, "load_library", no_library)
    cfg = ShapeNetConfig(*SIREN)
    wb, x, tgt, _ = _data(cfg, 2, 16, dtype, seed=2)
    with pytest.raises(ValueError, match="one CUDA device"):
        launch(wb, x, tgt, cfg)


class _FakeEntry:
    argtypes = None
    restype = None


class _FakeLibrary:
    """Stands in for a loaded library: any entry the wrapper names exists
    and records the argument types the wrapper gives it."""

    def __getattr__(self, name):
        entry = _FakeEntry()
        setattr(self, name, entry)
        return entry


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_signatures(source: str):
    """``{entry: [ctypes type per parameter]}`` of the ``int nif_...``
    entries of a source: pointers as ``c_void_p``."""
    sigs = {}
    for name, params in re.findall(r"^int (nif_\w+)\(([^)]*)\)", source, re.MULTILINE):
        types = []
        for param in params.split(","):
            decl = param.strip().rsplit(" ", 1)[0].replace("const ", "").strip()
            types.append(ctypes.c_void_p if decl.endswith("*") else _C_TYPES[decl])
        sigs[name] = types
    return sigs


LOADERS = {
    "shapenet_fwd": fs._library,
    "shapenet_fwd_tc": fs._fwd_tc_library,
    "shapenet_fwd_wgmma": fs._fwd_wg_library,
    "shapenet_bwd": fs._bwd_library,
    "shapenet_bwd_tc": fs._bwd_tc_library,
    "shapenet_bwd_wgmma": fs._bwd_wg_library,
    "shapenet_jac": lambda: fd._library("simt"),
    "shapenet_jac_tc": lambda: fd._library("tc"),
    "shapenet_hess": lambda: fh._library("simt"),
    "shapenet_hess_tc": lambda: fh._library("tc"),
    "shapenet_hess_wgmma": lambda: fh._library("wgmma"),
    "shapenet_linear": lambda: fl._library("simt"),
    "shapenet_linear_tc": lambda: fl._library("tc"),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_bindings_match_the_c_signatures(name, monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda lib: fake if lib == name else None)
    LOADERS[name]()
    sigs = _c_signatures((_build.CSRC / f"{name}.cu").read_text())
    bound = {k: v for k, v in vars(fake).items() if k != "nif_cuda_error_string"}
    assert bound, "the wrapper binds no entry"
    for entry, fn in bound.items():
        assert entry in sigs, f"{entry} is not defined in {name}.cu"
        assert list(fn.argtypes) == sigs[entry], entry
        assert fn.restype is ctypes.c_int, entry


@pytest.mark.parametrize("args,dtype,library,entry", [
    (SIREN, torch.float32, "shapenet_fwd", "nif_shapenet_fwd_jac_rev"),
    (RESBLOCK, torch.float32, "shapenet_jac", "nif_shapenet_fwd_jac"),
    ((1, 3, 16, 2, "sine", False, 30.0), torch.bfloat16, "shapenet_jac", "nif_shapenet_fwd_jac"),
], ids=["f32-reverse", "f32-tangent", "bf16-tangent"])
def test_k5_cuda_core_bodies_launch_from_their_libraries(args, dtype, library, entry,
                                                          monkeypatch):
    """K5 on the CUDA cores: the reverse body (so < si) launches the
    ``shapenet_fwd`` library's reverse entry, one body with the CUDA-core
    K1; the tangent body (so >= si) ``shapenet_jac``'s entry, one body
    template with the CUDA-core K6 (bfloat16 where the tensor-core tangent
    body refuses the shape: of its library only the workspace entry is
    asked). Stub libraries stand in for the built ones, and each loads only
    its own."""
    libs = {name: _FakeLibrary() for name in ("shapenet_fwd", "shapenet_jac", "shapenet_fwd_tc")}
    libs["shapenet_jac_tc"] = _StatusLibrary(2)
    monkeypatch.setattr(_build, "load_library", lambda name: libs[name])
    cfg = ShapeNetConfig(*args)
    kernel = fd.k5_variant(dtype, cfg, "siren")
    assert kernel == "simt"
    asked = [] if dtype == torch.float32 else ["nif_shapenet_fwd_jac_tan_tc_workspace"]
    assert libs["shapenet_jac_tc"].calls == asked
    lib, fn = fd._k5_entry(kernel, fd._jac_mode(cfg, cfg.input_dim))
    assert lib is libs[library] and fn is getattr(libs[library], entry)
    assert fn.argtypes is not None and fn.restype is ctypes.c_int
    others = set(libs) - {library, "shapenet_jac_tc"}
    assert not any(vars(libs[name]) for name in others), "another library was bound"


def test_k5_tensor_core_body_launches_from_the_tensor_core_library(monkeypatch):
    """The tensor-core K5 reverse body launches ``shapenet_fwd_tc``'s entry,
    whatever the mode the CUDA-core kernels would take."""
    libs = {name: _FakeLibrary() for name in ("shapenet_fwd", "shapenet_jac", "shapenet_fwd_tc")}
    monkeypatch.setattr(_build, "load_library", lambda name: libs[name])
    lib, fn = fd._k5_entry("tc", "reverse")
    assert lib is libs["shapenet_fwd_tc"] and fn is libs["shapenet_fwd_tc"].nif_shapenet_fwd_jac_tc
    assert not vars(libs["shapenet_fwd"]) and not vars(libs["shapenet_jac"])


@pytest.mark.parametrize("args", TANGENT_CHAINS, ids=TANGENT_IDS)
def test_k5_tensor_core_tangent_body_launches_from_the_k6_tensor_core_library(args,
                                                                              monkeypatch):
    """Where the tensor-core tangent body takes a bfloat16 chain
    (so >= si), K5 launches ``shapenet_jac_tc``'s tangent entry, beside the
    tensor-core K6, with the argument types of its C signature, and binds
    no other library."""
    names = ("shapenet_fwd", "shapenet_jac", "shapenet_fwd_tc")
    libs = {name: _FakeLibrary() for name in names}
    libs["shapenet_jac_tc"] = _StatusLibrary(0)
    monkeypatch.setattr(_build, "load_library", lambda name: libs[name])
    cfg = ShapeNetConfig(*args)
    kernel = fd.k5_variant(torch.bfloat16, cfg, "siren")
    assert kernel == "tc"
    lib, fn = fd._k5_entry(kernel, fd._jac_mode(cfg, cfg.input_dim))
    assert lib is libs["shapenet_jac_tc"] and fn is lib.nif_shapenet_fwd_jac_tan_tc
    sig = _c_signatures((_build.CSRC / "shapenet_jac_tc.cu").read_text())
    assert list(fn.argtypes) == sig["nif_shapenet_fwd_jac_tan_tc"]
    assert fn.restype is ctypes.c_int
    assert not any(vars(libs[name]) for name in names), "another library was bound"


@pytest.mark.parametrize("policy,dtype", [("float32", torch.float32),
                                          ("mixed_bfloat16", torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_hessian_evaluation_gates_k7_on_the_compute_dtype(policy, dtype, monkeypatch):
    """``output_jacobian_hessian_grouped`` asks K7's gate for the kernel of
    the model's compute dtype (a float32 model is held to the CUDA-core
    K7's limits, a bfloat16 one to the tensor-core K7's); a gate that
    refuses sends the evaluation to the eager path."""
    import nif_tpu_torch
    from nif_tpu_torch.ops import derivatives

    seen = []

    def gate(cfg, variant, P, si, device=None, dtype=torch.bfloat16):
        seen.append(dtype)
        return "refused"

    monkeypatch.setattr(derivatives, "fwd_hess_unsupported_reason", gate)
    cfg_s = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1, "activation": "sine"}
    cfg_p = {"input_dim": 2, "latent_dim": 3, "units": 8, "nlayers": 1, "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, device="cpu", seed=0)
    rng = np.random.default_rng(26)
    t = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 2)).astype(np.float32))
    _, _, hess = derivatives.output_jacobian_hessian_grouped(model, t, x)
    assert seen == [dtype]
    assert hess.shape == (2, 8, 1, 2, 2) and bool(torch.isfinite(hess).all())


@pytest.mark.parametrize("policy,dtype", [("float32", torch.float32),
                                          ("mixed_bfloat16", torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_jacobian_evaluation_gates_k5_on_the_compute_dtype(policy, dtype, monkeypatch):
    """``output_and_jacobian_grouped`` asks K5's gate for the kernel of the
    model's compute dtype (a float32 model is held to the CUDA-core K5's
    limits, a bfloat16 one to those of the kernel ``k5_variant`` picks); a
    gate that refuses sends the evaluation to the eager path."""
    import nif_tpu_torch
    from nif_tpu_torch.ops import derivatives

    seen = []

    def gate(cfg, variant, P, si, device=None, dtype=torch.bfloat16, kernel=None):
        seen.append(dtype)
        return "refused"

    monkeypatch.setattr(derivatives, "fwd_jac_unsupported_reason", gate)
    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 16, "nlayers": 1, "activation": "sine"}
    cfg_p = {"input_dim": 2, "latent_dim": 3, "units": 8, "nlayers": 1, "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, device="cpu", seed=0)
    rng = np.random.default_rng(27)
    t = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 3)).astype(np.float32))
    y, jac = derivatives.output_and_jacobian_grouped(model, t, x)
    assert seen == [dtype]
    assert y.shape == (2, 8, 1) and jac.shape == (2, 8, 1, 3)
    assert bool(torch.isfinite(jac).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_hessian_weights_stage_with_16_byte_copies(dtype):
    """wb' as each Hessian kernel's library reads it: the tensor-core
    kernels' in wb's dtype with rows padded to 8 values, the CUDA-core
    body's widened to f32 with rows padded to 4 floats (its C entries refuse
    another row stride); the padding is zero and the values exact."""
    cfg = ShapeNetConfig(*SIREN)
    wb = _data(cfg, 2, 4, dtype, seed=3)[0]
    assert wb.shape[1] % 4 != 0  # po = 625: the padding is exercised
    tc, simt = fh._hess_weights("tc", wb), fh._hess_weights("simt", wb)
    assert tc.dtype == dtype and tc.shape[1] % 8 == 0 and tc.is_contiguous()
    assert simt.dtype == torch.float32 and simt.shape[1] % 4 == 0 and simt.is_contiguous()
    for padded in (tc, simt):
        assert torch.equal(padded[:, :wb.shape[1]].float(), wb.float())
        assert not padded[:, wb.shape[1]:].any()


class _GateLibrary(_StatusLibrary):
    """The tensor-core K2/K3 library's workspace gate on the CPU: status 3
    for what its C entries refuse outright (a chain other than sine or
    resblock SIREN, si outside 1-4), else 0."""

    def __init__(self):
        super().__init__(0)

    def __getattr__(self, name):
        entry = super().__getattr__(name)
        lib = self

        def gate(n, si, so, n_mats, chain, *rest):
            lib.calls.append(name)
            sine = chain in (fs._CHAIN_CODES["siren"], fs._CHAIN_CODES["siren_resblock"])
            return 0 if sine and 1 <= si <= 4 else 3

        setattr(self, name, gate)
        gate.argtypes, gate.restype = entry.argtypes, entry.restype
        return gate


@pytest.mark.parametrize("args,variant,kernel", [
    (SIREN, "siren", "tc"),
    (RESBLOCK, "siren", "tc"),
    ((5, 1, 16, 2, "sine", False, 30.0), "siren", "simt"),
    ((2, 1, 16, 2, "tanh"), "vanilla", "simt"),
], ids=["siren", "resblock", "si5", "vanilla"])
def test_k3_variant_follows_the_tensor_core_geometry(args, variant, kernel, monkeypatch):
    """Given a bfloat16 chain, ``k3_variant`` asks the tensor-core K3's
    workspace entry (beside the tensor-core K2's, ``shapenet_bwd_tc``) and
    nothing else: a sine or resblock SIREN chain with si <= 4 takes the
    tensor cores, a vanilla chain or si = 5 the CUDA-core body."""
    libs = {"shapenet_bwd_tc": _GateLibrary()}

    def load(name):
        if name not in libs:
            raise AssertionError(f"asked the {name} library")
        return libs[name]

    monkeypatch.setattr(_build, "load_library", load)
    assert fs.k3_variant(torch.bfloat16, ShapeNetConfig(*args), variant) == kernel
    assert libs["shapenet_bwd_tc"].calls == ["nif_shapenet_bwd_tc_workspace"]


# (the launch, its tensor-core and CUDA-core C entries, pointers before the shape)
TRAIN_LAUNCHES = {
    "k2": (lambda wb, x, third, cfg: fs.shapenet_mse_grads_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_mse_grads_tc", "nif_shapenet_mse_grads", 8),
    "k3": (lambda wb, x, third, cfg: fs.shapenet_bwd_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_bwd_tc", "nif_shapenet_bwd", 7),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(TRAIN_LAUNCHES))
def test_k2_k3_cuda_launch_asks_only_its_kernels_library(kernel, dtype, monkeypatch):
    """A K2 or K3 launch (``shapenet_mse_grads_cuda``, ``shapenet_bwd_cuda``;
    the device checks stubbed so CPU tensors stand in for the card's):
    bfloat16 asks only ``shapenet_bwd_tc``, its geometry and then its
    tensor-core entry with wb' in bf16 rows padded to 8 values (16 bytes);
    float32 asks only ``shapenet_bwd``, its geometry and then its CUDA-core
    entry with wb' widened to f32 rows padded to 4. Each call matches its
    entry's argument types, and the launch counters count the kernel that
    ran."""
    launch, tc_entry, simt_entry, n_ptrs = TRAIN_LAUNCHES[kernel]
    libs = {"shapenet_bwd_tc": _StatusLibrary(0), "shapenet_bwd": _StatusLibrary(0)}

    def load(name):
        if name not in libs:
            raise AssertionError(f"asked the {name} library")
        return libs[name]

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(fs, "_check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    cfg = ShapeNetConfig(*SIREN)
    wb, x, tgt, _ = _data(cfg, 2, 16, dtype, seed=4)
    po = wb.shape[1]
    assert po % 8 != 0  # the padding is exercised
    counter = {"k2": "shapenet_mse_grads", "k3": "shapenet_bwd"}[kernel]
    before = dict(_build.LAUNCHES)
    outs = launch(wb, x, tgt.to(dtype), cfg)
    assert outs[-1].dtype == dtype
    tc = dtype == torch.bfloat16
    name, other = ("shapenet_bwd_tc", "shapenet_bwd") if tc else ("shapenet_bwd", "shapenet_bwd_tc")
    entry = tc_entry if tc else simt_entry
    workspace = "nif_shapenet_mse_tc_workspace" if tc and kernel == "k2" else (
        "nif_shapenet_bwd_tc_workspace" if tc else "nif_shapenet_bwd_workspace")
    lib = libs[name]
    assert lib.calls == [workspace, entry] and not libs[other].calls
    call = lib.args[entry]
    assert len(call) == len(getattr(lib, entry).argtypes)
    assert call[n_ptrs:n_ptrs + 9] == (
        2, 16, cfg.input_dim, cfg.output_dim, cfg.units, 2, fs._CHAIN_CODES["siren"],
        fs._train_act_code(cfg, "siren", dtype), po)
    assert call[n_ptrs + 9] == po + (-po % (8 if tc else 4))  # wb's row stride
    if not tc:
        assert call[-2] == fs._DTYPE_CODES[torch.float32]
    assert _build.LAUNCHES[counter] == before[counter] + 1
    assert _build.LAUNCHES[counter + "_tc"] == before[counter + "_tc"] + int(tc)
