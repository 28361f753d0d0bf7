"""The routing of bf16 K1, K2, K3, K5's reverse body, K7 and K8 to their
wgmma bodies on the CPU (no nvcc needed): ``k1_variant``, ``k2_variant``,
``k3_variant``, ``k5_variant``, ``k7_variant``, ``k8_variant`` and a launch
take ``csrc/shapenet_fwd_wgmma.cu`` (K1, K5), ``csrc/shapenet_bwd_wgmma.cu``
(K2, K3) or ``csrc/shapenet_hess_wgmma.cu`` (K7, K8) where that library's
geometry takes the chain, else the ``mma.sync`` body (``"tc"``:
``shapenet_fwd_tc.cu``, ``shapenet_bwd_tc.cu``, ``shapenet_hess_tc.cu``),
else the CUDA-core one (``"simt"``); a named body asks only its own
library; float32 never reaches a wgmma body, a width (or, for K7 and K8,
an si) it has no instance for never asks its library, and its private
launchers refuse CPU tensors before any library loads. Stub libraries stand
in for the built ones: each records the entries asked and returns a fixed
status."""
import contextlib

import numpy as np
import pytest
import torch

from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_derivatives as fd
from nif_tpu_torch.ops import fused_hessian as fh
from nif_tpu_torch.ops import fused_shapenet as fs

torch.set_num_threads(1)

FLAGSHIP = (3, 1, 128, 2, "sine", False, 30.0)
W64 = (3, 1, 64, 4, "sine", False, 30.0)
# si = 3 > so = 2: K5's reverse body takes them too
RESBLOCK_128 = (3, 2, 128, 1, "sine", True, 10.0)
RESBLOCK_64 = (3, 2, 64, 2, "sine", True, 10.0)
WGMMA_CHAINS = [FLAGSHIP, W64, RESBLOCK_128, RESBLOCK_64]
WGMMA_IDS = ["flagship", "w64_d4", "resblock_w128", "resblock_w64"]
# chains without a wgmma instance: bench.py's w256_d2, narrow widths, a vanilla chain
NO_INSTANCE = [((3, 1, 256, 2, "sine", False, 30.0), "siren"),
               ((3, 1, 16, 2, "sine", False, 30.0), "siren"),
               ((3, 1, 96, 2, "sine", False, 30.0), "siren"),
               ((2, 1, 64, 2, "relu"), "vanilla")]
NO_INSTANCE_IDS = ["w256_d2", "w16", "w96", "vanilla_w64"]

# each kernel's routing, its wgmma and mma.sync libraries and their
# workspace entries
PICKS = {"k1": (fs.k1_variant, "shapenet_fwd_wgmma", "nif_shapenet_fwd_wg_workspace",
                "shapenet_fwd_tc", "nif_shapenet_fwd_tc_workspace"),
         "k2": (fs.k2_variant, "shapenet_bwd_wgmma", "nif_shapenet_mse_wg_workspace",
                "shapenet_bwd_tc", "nif_shapenet_mse_tc_workspace"),
         "k3": (fs.k3_variant, "shapenet_bwd_wgmma", "nif_shapenet_bwd_wg_workspace",
                "shapenet_bwd_tc", "nif_shapenet_bwd_tc_workspace"),
         "k5": (fd.k5_variant, "shapenet_fwd_wgmma", "nif_shapenet_fwd_jac_wg_workspace",
                "shapenet_fwd_tc", "nif_shapenet_fwd_jac_tc_workspace"),
         "k7": (fh.k7_variant, "shapenet_hess_wgmma", "nif_shapenet_fwd_hess_wg_workspace",
                "shapenet_hess_tc", "nif_shapenet_fwd_hess_tc_workspace"),
         "k8": (fh.k8_variant, "shapenet_hess_wgmma", "nif_shapenet_hess_wg_workspace",
                "shapenet_hess_tc", "nif_shapenet_hess_tc_workspace")}
# each kernel's geometry on a named body (or the routed one, body None)
GEOMETRY = {
    "k1": lambda cfg, G, P, dtype, body: fs.k1_geometry(cfg, "siren", G, P, dtype, kernel=body),
    "k2": lambda cfg, G, P, dtype, body: fs.k2_geometry(cfg, "siren", G, P, dtype, kernel=body),
    "k3": lambda cfg, G, P, dtype, body: fs.k3_geometry(cfg, "siren", G, P, dtype, kernel=body),
    "k5": lambda cfg, G, P, dtype, body: fd._geometry("reverse", cfg, "siren", G, P, dtype,
                                                      kernel=body),
    "k7": lambda cfg, G, P, dtype, body: fh.hessian_geometry("eval", cfg, "siren", G, P, dtype,
                                                             kernel=body),
    "k8": lambda cfg, G, P, dtype, body: fh.hessian_geometry("train", cfg, "siren", G, P, dtype,
                                                             kernel=body),
}


class _Entry:
    argtypes = None
    restype = None

    def __init__(self, lib, name):
        self.lib, self.name = lib, name

    def __call__(self, *args):
        self.lib.calls.append(self.name)
        self.lib.args[self.name] = args
        return self.lib.status


class _Library:
    """A loaded library whose entries return ``status`` and record their calls."""

    def __init__(self, status):
        self.status, self.calls, self.args = status, [], {}

    def __getattr__(self, name):
        if not name.startswith("nif_"):
            raise AttributeError(name)
        entry = _Entry(self, name)
        setattr(self, name, entry)
        return entry


def _libraries(monkeypatch, **status):
    """Stub libraries by name; asking any other raises."""
    libs = {name: _Library(s) for name, s in status.items()}

    def load(name):
        if name not in libs:
            raise AssertionError(f"asked the {name} library")
        return libs[name]

    monkeypatch.setattr(_build, "load_library", load)
    return libs


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("args", WGMMA_CHAINS, ids=WGMMA_IDS)
def test_bf16_chains_route_to_the_wgmma_body(args, kernel, monkeypatch):
    """Where the wgmma library's geometry takes a bf16 chain (the flagship,
    width 64 with four hidden layers, resblock chains at both widths), K1,
    K2, K3 and K5's reverse body route to it, asking its workspace entry of
    their mode and no other library."""
    pick, wg_lib, wg_entry, _, _ = PICKS[kernel]
    libs = _libraries(monkeypatch, **{wg_lib: 0})
    assert pick(torch.bfloat16, ShapeNetConfig(*args), "siren") == "wgmma"
    assert libs[wg_lib].calls == [wg_entry]


@pytest.mark.parametrize("body", ["wgmma", "tc"])
@pytest.mark.parametrize("kernel", sorted(PICKS))
def test_a_named_body_asks_only_its_library(kernel, body, monkeypatch):
    """Timing one body alone names it: its geometry asks that body's
    library for the mode's workspace entry, and no other library."""
    _, wg_lib, wg_entry, tc_lib, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, **{wg_lib: 0, tc_lib: 0})
    geo = GEOMETRY[kernel](ShapeNetConfig(*FLAGSHIP), 32, 32768, torch.bfloat16, body)
    assert geo["kernel"] == body
    assert libs[wg_lib].calls == ([wg_entry] if body == "wgmma" else [])
    assert libs[tc_lib].calls == ([tc_entry] if body == "tc" else [])


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("tc_status,expected", [(0, "tc"), (2, "simt")],
                         ids=["tc-takes-it", "tc-refuses"])
def test_chains_the_wgmma_body_refuses_route_to_tc_then_simt(tc_status, expected, kernel,
                                                             monkeypatch):
    """A chain whose layout the wgmma body refuses (status 2: it exceeds a
    block's shared memory) goes to the ``mma.sync`` body where that one's
    geometry takes it, else to the CUDA-core body; each library is asked
    once, in that order."""
    pick, wg_lib, wg_entry, tc_lib, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, **{wg_lib: 2, tc_lib: tc_status})
    assert pick(torch.bfloat16, ShapeNetConfig(*FLAGSHIP), "siren") == expected
    assert libs[wg_lib].calls == [wg_entry]
    assert libs[tc_lib].calls == [tc_entry]


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("args,variant", NO_INSTANCE, ids=NO_INSTANCE_IDS)
def test_widths_without_a_wgmma_instance_never_ask_its_library(args, variant, kernel,
                                                               monkeypatch):
    """The wgmma bodies have instances for widths 64 and 128 of sine chains;
    any other chain goes straight to the ``mma.sync`` body's geometry (which
    takes width 256 at two hidden layers) without loading the wgmma
    library."""
    pick, _, _, tc_lib, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, **{tc_lib: 0})
    assert pick(torch.bfloat16, ShapeNetConfig(*args), variant) == "tc"
    assert libs[tc_lib].calls == [tc_entry]


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("args", WGMMA_CHAINS, ids=WGMMA_IDS)
def test_float32_never_reaches_the_wgmma_body(args, kernel, monkeypatch):
    """float32 runs the CUDA-core body, decided without asking any library,
    and the wgmma body refuses a float32 launch by name."""
    pick = PICKS[kernel][0]
    _libraries(monkeypatch)
    cfg = ShapeNetConfig(*args)
    assert pick(torch.float32, cfg, "siren") == "simt"
    with pytest.raises(ValueError, match="takes bfloat16"):
        GEOMETRY[kernel](cfg, 2, 64, torch.float32, "wgmma")


@pytest.mark.parametrize("kernel", ["k7", "k8"])
@pytest.mark.parametrize("si", [1, 2, 4])
def test_k7_k8_si_without_a_wgmma_instance_never_ask_its_library(si, kernel, monkeypatch):
    """The wgmma K7/K8 body has instances for si = 3 (ten streams a point)
    only: a flagship-width chain of any other si goes straight to the
    ``mma.sync`` body's geometry without loading the wgmma library."""
    pick, _, _, tc_lib, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, **{tc_lib: 0})
    assert pick(torch.bfloat16, ShapeNetConfig(si, 1, 128, 2, "sine", False, 30.0), "siren") == "tc"
    assert libs[tc_lib].calls == [tc_entry]


def _data(cfg, G, P, dtype, seed):
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    tgt = rng.standard_normal((G, P, cfg.output_dim))
    to = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(dt)  # noqa: E731
    return to(wb), to(x), to(tgt)


def _hessian_targets(x, cfg):
    """Zero Jacobian and unique-pair Hessian targets of x's shape."""
    G, P, si = x.shape
    so = cfg.output_dim
    return (torch.zeros((G, P, si * so), dtype=x.dtype),
            torch.zeros((G, P, si * (si + 1) // 2 * so), dtype=x.dtype))


LAUNCHERS = {
    "k1": lambda wb, x, third, cfg: fs._shapenet_fwd_on("wgmma", wb, x, cfg),
    "k2": lambda wb, x, third, cfg: fs._shapenet_mse_grads_on("wgmma", wb, x, third, cfg),
    "k3": lambda wb, x, third, cfg: fs._shapenet_bwd_on("wgmma", wb, x, third, cfg),
    "k5": lambda wb, x, third, cfg: fd._shapenet_fwd_jac_on("wgmma", wb, x, cfg),
    "k7": lambda wb, x, third, cfg: fh._shapenet_fwd_hess_on("wgmma", wb, x, cfg),
    "k8": lambda wb, x, third, cfg: fh._shapenet_hessian_grads_on(
        "wgmma", wb, x, third, *_hessian_targets(x, cfg), cfg),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(LAUNCHERS))
def test_wgmma_launchers_refuse_cpu_tensors_before_any_library(kernel, dtype, monkeypatch):
    _libraries(monkeypatch)
    cfg = ShapeNetConfig(*FLAGSHIP)
    wb, x, tgt = _data(cfg, 2, 16, dtype, seed=2)
    with pytest.raises(ValueError, match="one CUDA device"):
        LAUNCHERS[kernel](wb, x, tgt.to(dtype), cfg)


# what a refused named body's geometry says, and an unknown name's
REFUSALS = {"k1": ("wgmma K1 cannot take", "unknown K1 body"),
            "k2": ("wgmma K2/K3 body cannot take", "unknown K2/K3 body"),
            "k3": ("wgmma K2/K3 body cannot take", "unknown K2/K3 body"),
            "k5": ("shared memory per block in the wgmma Jacobian kernel", "unknown K5 body"),
            "k7": ("shared memory per block in the wgmma Hessian evaluation kernel",
                   "unknown K7/K8 body"),
            "k8": ("shared memory per block in the wgmma Hessian train kernel",
                   "unknown K7/K8 body")}


@pytest.mark.parametrize("kernel", sorted(PICKS))
def test_a_refused_forced_body_raises(kernel, monkeypatch):
    """Timing one body alone names it; where its geometry refuses the shape
    the geometry (and so the launch) raises instead of running another."""
    _, wg_lib, wg_entry, _, _ = PICKS[kernel]
    libs = _libraries(monkeypatch, **{wg_lib: 2})
    refused, unknown = REFUSALS[kernel]
    with pytest.raises(ValueError, match=refused):
        GEOMETRY[kernel](ShapeNetConfig(*FLAGSHIP), 32, 32768, torch.bfloat16, "wgmma")
    assert libs[wg_lib].calls == [wg_entry]
    with pytest.raises(ValueError, match=unknown):
        GEOMETRY[kernel](ShapeNetConfig(*FLAGSHIP), 32, 32768, torch.bfloat16, "mma")


# (the routed launch, the wgmma C entry, its counter, pointers before the
# shape, the workspace queries a launch makes). The public wrappers of K5,
# K7 and K8 route only CUDA tensors, so their stand-ins route as they do
# (k5_variant, k7_variant or k8_variant, then the launch at [G, P]: two
# queries).
ROUTED = {
    "k1": (lambda wb, x, third, cfg: fs.shapenet_fwd_cuda(wb, x, cfg, "siren"),
           "nif_shapenet_fwd_wg", "shapenet_fwd", 4, 1),
    "k2": (lambda wb, x, third, cfg: fs.shapenet_mse_grads_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_mse_grads_wg", "shapenet_mse_grads", 8, 1),
    "k3": (lambda wb, x, third, cfg: fs.shapenet_bwd_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_bwd_wg", "shapenet_bwd", 7, 1),
    "k5": (lambda wb, x, third, cfg: fd._launch_k5(fd.k5_variant(x.dtype, cfg, "siren"), wb, x,
                                                   cfg, "siren"),
           "nif_shapenet_fwd_jac_wg", "shapenet_fwd_jac", 5, 2),
    "k7": (lambda wb, x, third, cfg: fh._launch_k7(fh.k7_variant(x.dtype, cfg, "siren"), wb, x,
                                                   cfg, "siren"),
           "nif_shapenet_fwd_hess_wg", "shapenet_fwd_hess", 6, 2),
    "k8": (lambda wb, x, third, cfg: fh._launch_k8(
        fh.k8_variant(x.dtype, cfg, "siren"), wb, x, third, *_hessian_targets(x, cfg), cfg,
        "siren", 1.0, 1.0, 1.0, None, None, None, None),
           "nif_shapenet_hessian_grads_wg", "shapenet_hessian_grads", 13, 2),
}


@pytest.mark.parametrize("args", [FLAGSHIP, RESBLOCK_64], ids=["flagship", "resblock_w64"])
@pytest.mark.parametrize("kernel", sorted(ROUTED))
def test_wgmma_launch_asks_only_its_library(kernel, args, monkeypatch):
    """A routed bf16 K1, K2, K3, K5, K7 or K8 launch of a chain the wgmma geometry
    takes (the device checks stubbed so CPU tensors stand in for the
    card's) asks only its wgmma library: its geometry, then its entry, with
    wb' in bf16 rows padded to 8 values (16 bytes: the TMA tensor map's
    group stride) and the mma.sync entry's arguments; the launch counts
    under the kernel's name and its ``_wg`` counter, not the ``_tc`` one."""
    launch, entry, counter, n_ptrs, queries = ROUTED[kernel]
    _, wg_lib, workspace, _, _ = PICKS[kernel]
    libs = _libraries(monkeypatch, **{wg_lib: 0})

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(fs, "_check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(fd, "_check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(fh, "_check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    cfg = ShapeNetConfig(*args)
    wb, x, tgt = _data(cfg, 2, 16, torch.bfloat16, seed=4)
    po = wb.shape[1]
    before = dict(_build.LAUNCHES)
    outs = launch(wb, x, tgt.to(torch.bfloat16), cfg)
    assert (outs[-1] if isinstance(outs, tuple) else outs).dtype == torch.bfloat16
    lib = libs[wg_lib]
    assert lib.calls == [workspace] * queries + [entry]
    call = lib.args[entry]
    assert len(call) == len(getattr(lib, entry).argtypes)
    assert call[n_ptrs:n_ptrs + 9] == (
        2, 16, cfg.input_dim, cfg.output_dim, cfg.units, fs._n_mats(cfg),
        fs._chain_code(cfg, "siren"), fs._train_act_code(cfg, "siren", torch.bfloat16), po)
    assert call[n_ptrs + 9] == po + (-po % 8)
    assert _build.LAUNCHES[counter] == before[counter] + 1
    assert _build.LAUNCHES[counter + "_wg"] == before[counter + "_wg"] + 1
    assert _build.LAUNCHES[counter + "_tc"] == before[counter + "_tc"]
