"""The routing of bf16 K2 and K3 to their wgmma body on the CPU (no nvcc
needed): ``k2_variant``/``k3_variant`` and a launch take
``csrc/shapenet_bwd_wgmma.cu`` where its library's geometry takes the chain,
else the ``mma.sync`` body (``"tc"``), else the CUDA-core one (``"simt"``);
a named body asks only its own library; float32 never reaches the wgmma
body, a width it has no instance for never asks its library, and its
private launchers refuse CPU tensors before any library loads. Stub
libraries stand in for the built ones: each records the entries asked and
returns a fixed status."""
import contextlib

import numpy as np
import pytest
import torch

from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_shapenet as fs

torch.set_num_threads(1)

FLAGSHIP = (3, 1, 128, 2, "sine", False, 30.0)
W64 = (3, 1, 64, 4, "sine", False, 30.0)
RESBLOCK_128 = (2, 2, 128, 1, "sine", True, 10.0)
RESBLOCK_64 = (2, 2, 64, 2, "sine", True, 10.0)
WGMMA_CHAINS = [FLAGSHIP, W64, RESBLOCK_128, RESBLOCK_64]
WGMMA_IDS = ["flagship", "w64_d4", "resblock_w128", "resblock_w64"]
# chains without a wgmma instance: bench.py's w256_d2, narrow widths, a vanilla chain
NO_INSTANCE = [((3, 1, 256, 2, "sine", False, 30.0), "siren"),
               ((3, 1, 16, 2, "sine", False, 30.0), "siren"),
               ((1, 1, 96, 2, "sine", False, 30.0), "siren"),
               ((2, 1, 64, 2, "relu"), "vanilla")]
NO_INSTANCE_IDS = ["w256_d2", "w16", "w96", "vanilla_w64"]

PICKS = {"k2": (fs.k2_variant, "nif_shapenet_mse_wg_workspace", "nif_shapenet_mse_tc_workspace"),
         "k3": (fs.k3_variant, "nif_shapenet_bwd_wg_workspace", "nif_shapenet_bwd_tc_workspace")}


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
    width 64 with four hidden layers, resblock chains at both widths), K2
    and K3 route to it, asking its workspace entry of their mode and no
    other library."""
    pick, wg_entry, _ = PICKS[kernel]
    libs = _libraries(monkeypatch, shapenet_bwd_wgmma=0)
    assert pick(torch.bfloat16, ShapeNetConfig(*args), "siren") == "wgmma"
    assert libs["shapenet_bwd_wgmma"].calls == [wg_entry]


@pytest.mark.parametrize("body", ["wgmma", "tc"])
@pytest.mark.parametrize("kernel", sorted(PICKS))
def test_a_named_body_asks_only_its_library(kernel, body, monkeypatch):
    """Timing one body alone names it: its geometry asks that body's
    library for the mode's workspace entry, and no other library."""
    _, wg_entry, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, shapenet_bwd_wgmma=0, shapenet_bwd_tc=0)
    geometry = fs.k2_geometry if kernel == "k2" else fs.k3_geometry
    geo = geometry(ShapeNetConfig(*FLAGSHIP), "siren", 32, 32768, torch.bfloat16, kernel=body)
    assert geo["kernel"] == body
    assert libs["shapenet_bwd_wgmma"].calls == ([wg_entry] if body == "wgmma" else [])
    assert libs["shapenet_bwd_tc"].calls == ([tc_entry] if body == "tc" else [])


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("tc_status,expected", [(0, "tc"), (2, "simt")],
                         ids=["tc-takes-it", "tc-refuses"])
def test_chains_the_wgmma_body_refuses_route_to_tc_then_simt(tc_status, expected, kernel,
                                                             monkeypatch):
    """A chain whose layout the wgmma body refuses (status 2: it exceeds a
    block's shared memory) goes to the ``mma.sync`` body where that one's
    geometry takes it, else to the CUDA-core body; each library is asked
    once, in that order."""
    pick, wg_entry, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, shapenet_bwd_wgmma=2, shapenet_bwd_tc=tc_status)
    assert pick(torch.bfloat16, ShapeNetConfig(*FLAGSHIP), "siren") == expected
    assert libs["shapenet_bwd_wgmma"].calls == [wg_entry]
    assert libs["shapenet_bwd_tc"].calls == [tc_entry]


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("args,variant", NO_INSTANCE, ids=NO_INSTANCE_IDS)
def test_widths_without_a_wgmma_instance_never_ask_its_library(args, variant, kernel,
                                                               monkeypatch):
    """The wgmma body has instances for widths 64 and 128 of sine chains;
    any other chain goes straight to the ``mma.sync`` body's geometry (which
    takes width 256 at two hidden layers) without loading the wgmma
    library."""
    pick, _, tc_entry = PICKS[kernel]
    libs = _libraries(monkeypatch, shapenet_bwd_tc=0)
    assert pick(torch.bfloat16, ShapeNetConfig(*args), variant) == "tc"
    assert libs["shapenet_bwd_tc"].calls == [tc_entry]


@pytest.mark.parametrize("kernel", sorted(PICKS))
@pytest.mark.parametrize("args", WGMMA_CHAINS, ids=WGMMA_IDS)
def test_float32_never_reaches_the_wgmma_body(args, kernel, monkeypatch):
    """float32 runs the CUDA-core body, decided without asking any library,
    and the wgmma body refuses a float32 launch by name."""
    pick = PICKS[kernel][0]
    _libraries(monkeypatch)
    cfg = ShapeNetConfig(*args)
    assert pick(torch.float32, cfg, "siren") == "simt"
    geometry = fs.k2_geometry if kernel == "k2" else fs.k3_geometry
    with pytest.raises(ValueError, match="takes bfloat16"):
        geometry(cfg, "siren", 2, 64, torch.float32, kernel="wgmma")


def _data(cfg, G, P, dtype, seed):
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    tgt = rng.standard_normal((G, P, cfg.output_dim))
    to = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(dt)  # noqa: E731
    return to(wb), to(x), to(tgt)


LAUNCHERS = {
    "k2": lambda wb, x, third, cfg: fs._shapenet_mse_grads_on("wgmma", wb, x, third, cfg),
    "k3": lambda wb, x, third, cfg: fs._shapenet_bwd_on("wgmma", wb, x, third, cfg),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(LAUNCHERS))
def test_wgmma_launchers_refuse_cpu_tensors_before_any_library(kernel, dtype, monkeypatch):
    _libraries(monkeypatch)
    cfg = ShapeNetConfig(*FLAGSHIP)
    wb, x, tgt = _data(cfg, 2, 16, dtype, seed=2)
    with pytest.raises(ValueError, match="one CUDA device"):
        LAUNCHERS[kernel](wb, x, tgt.to(dtype), cfg)


@pytest.mark.parametrize("kernel", sorted(PICKS))
def test_a_refused_forced_body_raises(kernel, monkeypatch):
    """Timing one body alone names it; where its geometry refuses the shape
    the geometry (and so the launch) raises instead of running another."""
    libs = _libraries(monkeypatch, shapenet_bwd_wgmma=2)
    geometry = fs.k2_geometry if kernel == "k2" else fs.k3_geometry
    with pytest.raises(ValueError, match="wgmma K2/K3 body cannot take"):
        geometry(ShapeNetConfig(*FLAGSHIP), "siren", 32, 32768, torch.bfloat16, kernel="wgmma")
    assert libs["shapenet_bwd_wgmma"].calls == [PICKS[kernel][1]]
    with pytest.raises(ValueError, match="unknown K2/K3 body"):
        geometry(ShapeNetConfig(*FLAGSHIP), "siren", 32, 32768, torch.bfloat16, kernel="mma")


# (the routed launch, the wgmma C entry, its counter, pointers before the shape)
ROUTED = {
    "k2": (lambda wb, x, third, cfg: fs.shapenet_mse_grads_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_mse_grads_wg", "shapenet_mse_grads", 8),
    "k3": (lambda wb, x, third, cfg: fs.shapenet_bwd_cuda(wb, x, third, cfg, "siren"),
           "nif_shapenet_bwd_wg", "shapenet_bwd", 7),
}


@pytest.mark.parametrize("args", [FLAGSHIP, RESBLOCK_64], ids=["flagship", "resblock_w64"])
@pytest.mark.parametrize("kernel", sorted(ROUTED))
def test_wgmma_launch_asks_only_its_library(kernel, args, monkeypatch):
    """A routed bf16 K2 or K3 launch of a chain the wgmma geometry takes (the
    device checks stubbed so CPU tensors stand in for the card's) asks only
    ``shapenet_bwd_wgmma``: its geometry, then its entry, with wb' in bf16
    rows padded to 8 values (16 bytes: the TMA tensor map's group stride)
    and the mma.sync entry's arguments; the launch counts under the kernel's
    name and its ``_wg`` counter, not the ``_tc`` one."""
    launch, entry, counter, n_ptrs = ROUTED[kernel]
    libs = _libraries(monkeypatch, shapenet_bwd_wgmma=0)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(fs, "_check_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    cfg = ShapeNetConfig(*args)
    wb, x, tgt = _data(cfg, 2, 16, torch.bfloat16, seed=4)
    po = wb.shape[1]
    before = dict(_build.LAUNCHES)
    outs = launch(wb, x, tgt.to(torch.bfloat16), cfg)
    assert outs[-1].dtype == torch.bfloat16
    workspace = PICKS[kernel][1]
    lib = libs["shapenet_bwd_wgmma"]
    assert lib.calls == [workspace, entry]
    call = lib.args[entry]
    assert len(call) == len(getattr(lib, entry).argtypes)
    assert call[n_ptrs:n_ptrs + 9] == (
        2, 16, cfg.input_dim, cfg.output_dim, cfg.units, fs._n_mats(cfg),
        fs._chain_code(cfg, "siren"), fs._train_act_code(cfg, "siren", torch.bfloat16), po)
    assert call[n_ptrs + 9] == po + (-po % 8)
    assert _build.LAUNCHES[counter] == before[counter] + 1
    assert _build.LAUNCHES[counter + "_wg"] == before[counter + "_wg"] + 1
    assert _build.LAUNCHES[counter + "_tc"] == before[counter + "_tc"]
