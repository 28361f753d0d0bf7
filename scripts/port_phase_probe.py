#!/usr/bin/env python3
"""Where a hand-written kernel spends its time, phase by phase, on a CUDA
card: the tensor-core K1 or K5's reverse body
(``nif_tpu_torch/csrc/shapenet_fwd_tc.cu``), K2 (``csrc/shapenet_bwd_tc.cu``),
K4 (``csrc/shapenet_linear_tc.cu``), K6 (``csrc/shapenet_jac_tc.cu``), K7 or
K8 (``csrc/shapenet_hess_tc.cu``, the ``mma.sync`` body, or
``csrc/shapenet_hess_wgmma.cu``, the wgmma one), the float32 K2 or K3 on the CUDA cores
(``csrc/shapenet_bwd.cu``), the float32 K7 or K8 on the CUDA cores
(``csrc/shapenet_hess.cu``), the float32 K6 or K5's float32 tangent body
on the CUDA cores (one body template, ``csrc/shapenet_jac.cu``), K5's
bf16 tangent body on the tensor cores (``csrc/shapenet_jac_tc.cu``), the
float32 K4 on the CUDA cores (``csrc/shapenet_linear.cu``) or the float32
K1 or K5's float32 reverse body on the CUDA cores (one body,
``csrc/shapenet_fwd.cu``).

    python3 scripts/port_phase_probe.py [--kernel k1|k1f32|k1wg|k2|k2f32|k2wg|k3f32|k3wg|k4|k4f32|
                                                  k5|k5f32|k5tan|k5tanf32|k5wg|k6|k6f32|k7|
                                                  k7f32|k7wg|k8|k8f32|k8wg]
                                        [--ablate] [--one-block]

Builds the kernel's source once more with ``-DK1_PHASE_CLOCKS``,
``-DK1F_PHASE_CLOCKS`` (k1f32, k5f32), ``-DK2_PHASE_CLOCKS``,
``-DK2F_PHASE_CLOCKS`` (k2f32, k3f32), ``-DK8F_PHASE_CLOCKS``
(k7f32, k8f32), ``-DK6F_PHASE_CLOCKS`` (k6f32, k5tanf32),
``-DK4F_PHASE_CLOCKS`` (k4f32), ``-DK5T_PHASE_CLOCKS`` (k5tan),
``-DWG_PHASE_CLOCKS`` (k2wg, k3wg: the wgmma K2/K3 body of
``csrc/shapenet_bwd_wgmma.cu``, whose thread 0 of each consumer warpgroup
keeps the counters, so its split is of a consumer's time a tile: the
products' share, the epilogues' and the dW and bias flushes'),
``-DFWG_PHASE_CLOCKS`` (k1wg, k5wg: the wgmma K1/K5 reverse body of
``csrc/shapenet_fwd_wgmma.cu``, kept likewise by each consumer: its
products, epilogues, first and last layers and K5's sweeps),
``-DHWG_PHASE_CLOCKS`` (k7wg, k8wg: the wgmma K7/K8 body of
``csrc/shapenet_hess_wgmma.cu``, kept likewise by each consumer, a
consumer's eight points of each 16-point tile: products, epilogues, the
last layer, the backward and the first layer's backward),
``-DK4_PHASE_CLOCKS``, ``-DK5_PHASE_CLOCKS``, ``-DK6_PHASE_CLOCKS``,
``-DK7_PHASE_CLOCKS`` or ``-DK8_PHASE_CLOCKS`` (into
``build/nif_tpu_torch/probe/``), in which thread 0 of every block adds the
``clock64()`` cycles between consecutive marks into phase counters (four
for K1, K7, K5's tangent bodies, the float32 K1 and the float32 K7, seven
for K5's float32 reverse body, ten for the float32 K2, K3, K4, K6 and K8,
eight for the others), and runs it
through the usual wrapper at the kernel's flagship shape (G=32, P=32768,
bf16, random weights from a seed: the NIF-linear trunk for K4, the flagship
chain alone for K1, K5 and K7, with targets and point weights for K2, with
Jacobian targets for K6, and with Jacobian and Hessian targets for K8;
float32 for k2f32, with targets and point weights, k3f32, with an output
cotangent, k7f32, k8f32, with Jacobian and Hessian targets, k6f32, with
Jacobian targets, k4f32, the NIF-linear trunk, and k1f32 and k5f32, the
chain alone; k5tan in bf16 and k5tanf32 on the chain alone with si = so =
3, the shape PERF.md times K5's tangent body at). Prints the
kernel's time (CUDA events, the instrumented build beside the plain one)
and each phase's share of the blocks' critical path; for the float32
kernels also the plain build's ptxas lines and the device time of each
kernel of a call (``torch.profiler``: the main kernel and the split
reduce). The counters cost a few instructions at each mark; the plain
build's time says how much. Nothing is asserted.

With ``--kernel k1 --one-block`` it also builds a variant of the source (a
text edit of a copy, as the ablations are) with K1 on 128-point tiles at up
to 255 registers a thread, one block per SM, in place of 64-point tiles at
128 registers, two blocks per SM, and times it beside the source as it is,
in turns (as built, one block, one block, as built); with ``--kernel k1f32
--one-block`` likewise the float32 K1 at one block per SM (up to 255
registers a thread) in place of two (up to 128), and with ``--kernel k5tan``
or ``k5tanf32`` K5's tangent body at one block per SM (its geometry then
stages every W_m once a group in the tensor-core body).

With ``--kernel k1wg|k5wg --ablate`` it also builds the wgmma K1/K5 body
with the sine's range reduction rounding by two adds of 1.5 * 2^23 in
place of ``rintf`` (the same bits for |z| < 2^22 * 2 pi), with the hidden
epilogue's sine left out, and with the hidden products left out, and times
them beside the source as it is, in turns (the last two compute wrong
values). With ``--kernel k8wg --ablate`` it also builds the wgmma K7/K8
body without the loads and stores of its dW partial (the products kept
alive) and with the sine's range reduction rounding by two adds, and times
them beside the source as it is, in turns. With ``--kernel k2wg|k3wg
--ablate`` it also builds the wgmma body without
the loads and stores of its dW partial (the products kept alive) and times
it beside the source as it is, in turns. With ``--kernel k2|k6|k8 --ablate``
it also builds three variants of the
kernel's source and its shared header ``stack_tc.cuh`` (text edits of a copy,
checked to apply) and times them beside the source as it is, in turns:
without the loads of the f32 dW partials, without their loads and stores (the
products kept alive), and without the hidden dW at all. The variants compute
wrong gradients; only their times mean anything.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nif_tpu_torch.config import ShapeNetConfig  # noqa: E402
from nif_tpu_torch.ops import _build  # noqa: E402
from nif_tpu_torch.ops import fused_derivatives as fd  # noqa: E402
from nif_tpu_torch.ops import fused_hessian as fh  # noqa: E402
from nif_tpu_torch.ops import fused_linear as fl  # noqa: E402
from nif_tpu_torch.ops import fused_shapenet as fs  # noqa: E402
from nif_tpu_torch.utils.bench import FLAGSHIP_SHAPE, cuda_ms  # noqa: E402

# The phases of the CUDA-core K2/K3 body (csrc/shapenet_bwd.cu)
SIMT_PHASES = [
    "x tile + first layer",
    "hidden forward products",
    "hidden forward epilogues (thread 0's)",
    "last product + loss (or g_out)",
    "last layer's backward (dW_l, db_l, du)",
    "dz epilogues",
    "hidden dW + db (partial updates included)",
    "du products",
    "first layer's backward (dW0, db0, dx)",
    "the group's loss partial (and set-up)",
]

# The phases of a consumer warpgroup of the wgmma K2/K3 body
# (csrc/shapenet_bwd_wgmma.cu), a consumer's half (64 points) of a tile
WG_PHASES = [
    "waiting for the tile's inputs (the ring)",
    "first layer (x, sine, S_0 store)",
    "forward products (issue, wait)",
    "forward epilogues (bias, sine, S stores)",
    "last layer, loss, dW_last product, du",
    "backward products (recompute; du + dW)",
    "dz epilogues (act', roundings, dz store)",
    "dW stores, bias sums, first layer's backward",
]

# The phases of a consumer warpgroup of the wgmma K1/K5 reverse body
# (csrc/shapenet_fwd_wgmma.cu), a consumer's half (64 points) of a tile; K1
# marks the first five
FWG_PHASES = [
    "waiting for the tile's x (and a group's W)",
    "first layer (x rows, sine, pack)",
    "hidden products (issue, wait)",
    "hidden epilogues (bias, sine, K5 act', pack)",
    "last product + y stores",
    "sweep: dz epilogues (act' loads, pack)",
    "sweep: du = dz W^T (issue, wait)",
    "sweep: dz0 (act'(z0) kept), jac product, stores",
]

# The phases of a consumer warpgroup of the wgmma K7/K8 body
# (csrc/shapenet_hess_wgmma.cu), a consumer's eight points of a tile, in
# counter order; K7 marks the first six (its counter 5: the stores)
HWG_PHASES = [
    "waiting for the tile's inputs (the ring)",
    "first layer (all streams, S_0 store)",
    "forward products (issue)",
    "forward epilogues (waits, pair rules, sine, S stores)",
    "last product (wgmma, O to shared memory)",
    "backward: Z recomputed, D epilogues and stores",
    "backward: dS + dW products, partial flush, waits",
    "first layer's backward (dW0, db0)",
    "loss and D_out",
    "dW_l (wgmma), db_l, dS of the last layer",
]
HWG7_PHASES = HWG_PHASES[:5] + ["y, jac, hp stores"]

# The phases of the CUDA-core K7/K8 body (csrc/shapenet_hess.cu); K7 marks
# the first four
HESS_PHASES = [
    "x tile + first layer (all streams)",
    "hidden forward products",
    "hidden forward epilogues (thread 0's)",
    "last product + loss (K7: y, jac, hp stores)",
    "last layer's backward (dW_l, db_l, dS)",
    "backward epilogues (D over Z; app 0's recomputes S_0)",
    "hidden dW + db (partial updates included)",
    "dS products",
    "first layer's backward (dW0, db0)",
    "the group's loss partials (and set-up)",
]

# The phases of the float32 K6 on the CUDA cores (csrc/shapenet_jac.cu)
SOB_PHASES = [
    "x tile + first layer (all streams)",
    "hidden forward products",
    "hidden forward epilogues (thread 0's)",
    "last product + loss",
    "last layer's backward (dW_l, db_l, dS)",
    "backward epilogues (D over Z; app 0's recomputes S_0)",
    "hidden dW + db (partial updates included)",
    "dS products",
    "first layer's backward (dW0, db0)",
    "the group's loss partials (and set-up)",
]

# The phases of the float32 K4 on the CUDA cores (csrc/shapenet_linear.cu)
LINEAR_PHASES = [
    "x tile + first layer",
    "hidden forward products",
    "hidden forward epilogues (thread 0's)",
    "bottleneck + contraction + loss",
    "d_bias, d_a, d_phi, bottleneck dW/db, du",
    "dz epilogues",
    "hidden dW + db (partial updates included)",
    "du products",
    "first layer's backward (dW0, db0)",
    "the group's loss partial (and set-up)",
]

# The phases of K5's float32 tangent body (K6's forward half; the first
# four marks of SOB_PHASES)
TAN_PHASES = SOB_PHASES[:3] + ["last product + y, jac stores"]

# The phases of the float32 K1 and K5's float32 reverse body; K1 marks the
# first four
FWD_PHASES = [
    "x tile (and the group's set-up)",
    "forward products",
    "forward epilogues",
    "last layer (y)",
    "sweep products",
    "sweep epilogues",
    "jac tail (dz0 @ W0'^T)",
]

# The longest counter array a C entry copies out (the kPhases of
# shapenet_bwd.cu, shapenet_hess.cu, shapenet_jac.cu and shapenet_linear.cu)
COUNTER_ROOM = 10

# source, its define, its counter entry, and the phases in counter order
KERNELS = {
    "k1": ("shapenet_fwd_tc", "K1_PHASE_CLOCKS", "nif_fwd_tc_phase_cycles", [
        "x tile + first layer",
        "hidden forward (products + sine)",
        "last product + thread 0's y stores",
        "the other y stores (and the group's set-up)",
    ]),
    "k5": ("shapenet_fwd_tc", "K5_PHASE_CLOCKS", "nif_fwd_jac_tc_phase_cycles", [
        "x tile + first layer",
        "hidden forward (products + sine and act')",
        "last product + thread 0's y stores",
        "sweep: dz epilogues (act' from the planes)",
        "sweep: du = D @ W^T",
        "sweep: first layer's dz0 (z0 recomputed)",
        "sweep: dx product + thread 0's jac stores",
        "the other jac stores (and the group's set-up)",
    ]),
    "k2": ("shapenet_bwd_tc", "K2_PHASE_CLOCKS", "nif_mse_tc_phase_cycles", [
        "x tile + first layer",
        "hidden forward (products + sine)",
        "last product + loss",
        "last layer's backward (dW_l, db_l, du)",
        "S copy-back + Z recompute + epilogue",
        "hidden dW (thread 0's own tasks)",
        "du = D @ W^T (and the wait for dW)",
        "first layer's backward (dW0, db0)",
    ]),
    "k4": ("shapenet_linear_tc", "K4_PHASE_CLOCKS", "nif_linear_tc_phase_cycles", [
        "x tile",
        "first layer + hidden forward",
        "bottleneck forward + contraction",
        "loss and dL/du (target, weight)",
        "d_bias, d_a sums, d_phi",
        "d_a, bottleneck dW/db, du",
        "hidden layers' backward",
        "first layer's backward (dW0, db0)",
    ]),
    "k6": ("shapenet_jac_tc", "K6_PHASE_CLOCKS", "nif_sob_tc_phase_cycles", [
        "x tile + first layer (all streams)",
        "hidden forward (products + epilogues)",
        "last product + loss",
        "last layer's backward (dW_l, db_l, dS)",
        "S copy-back + Z recompute + epilogue",
        "hidden dW (thread 0's own tasks)",
        "dS = D @ W^T (and the wait for dW)",
        "first layer's backward (dW0, db0)",
    ]),
    "k7": ("shapenet_hess_tc", "K7_PHASE_CLOCKS", "nif_fwd_hess_tc_phase_cycles", [
        "x tile + first layer (all streams)",
        "hidden forward (products + epilogues)",
        "last product",
        "y, jac, hp stores (and the group's set-up)",
    ]),
    "k2wg": ("shapenet_bwd_wgmma", "WG_PHASE_CLOCKS", "nif_wg_phase_cycles", WG_PHASES),
    "k7wg": ("shapenet_hess_wgmma", "HWG_PHASE_CLOCKS", "nif_hwg_phase_cycles", HWG7_PHASES),
    "k8wg": ("shapenet_hess_wgmma", "HWG_PHASE_CLOCKS", "nif_hwg_phase_cycles", HWG_PHASES),
    "k1wg": ("shapenet_fwd_wgmma", "FWG_PHASE_CLOCKS", "nif_fwg_phase_cycles", FWG_PHASES[:5]),
    "k5wg": ("shapenet_fwd_wgmma", "FWG_PHASE_CLOCKS", "nif_fwg_phase_cycles", FWG_PHASES),
    "k3wg": ("shapenet_bwd_wgmma", "WG_PHASE_CLOCKS", "nif_wg_phase_cycles", WG_PHASES),
    "k2f32": ("shapenet_bwd", "K2F_PHASE_CLOCKS", "nif_bwd_phase_cycles", SIMT_PHASES),
    "k3f32": ("shapenet_bwd", "K2F_PHASE_CLOCKS", "nif_bwd_phase_cycles", SIMT_PHASES),
    "k7f32": ("shapenet_hess", "K8F_PHASE_CLOCKS", "nif_hess_phase_cycles", HESS_PHASES[:4]),
    "k6f32": ("shapenet_jac", "K6F_PHASE_CLOCKS", "nif_jac_phase_cycles", SOB_PHASES),
    "k5tanf32": ("shapenet_jac", "K6F_PHASE_CLOCKS", "nif_jac_phase_cycles", TAN_PHASES),
    "k5tan": ("shapenet_jac_tc", "K5T_PHASE_CLOCKS", "nif_fwd_jac_tan_tc_phase_cycles", [
        "x tile + first layer (all streams)",
        "hidden forward (products + epilogues)",
        "last product",
        "y, jac stores (and the group's set-up)",
    ]),
    "k4f32": ("shapenet_linear", "K4F_PHASE_CLOCKS", "nif_linear_phase_cycles", LINEAR_PHASES),
    "k1f32": ("shapenet_fwd", "K1F_PHASE_CLOCKS", "nif_fwd_phase_cycles", FWD_PHASES[:4]),
    "k5f32": ("shapenet_fwd", "K1F_PHASE_CLOCKS", "nif_fwd_phase_cycles", FWD_PHASES),
    "k8f32": ("shapenet_hess", "K8F_PHASE_CLOCKS", "nif_hess_phase_cycles", HESS_PHASES),
    "k8": ("shapenet_hess_tc", "K8_PHASE_CLOCKS", "nif_hess_tc_phase_cycles", [
        "x tile + first layer (all streams)",
        "hidden forward (products + epilogues)",
        "last product + loss",
        "last layer's backward (dW_l, db_l, dS)",
        "S copy-back + Z recompute + epilogue",
        "hidden dW (thread 0's own tasks)",
        "dS = D @ W^T (and the wait for dW)",
        "first layer's backward (dW0, db0)",
    ]),
}


def build_probe(name: str, define: str, entry: str) -> ctypes.CDLL:
    """The source built with ``-D<define>``, named by its library's hash, so
    a second run on the same sources (k3f32 after k2f32) reuses it."""
    out = _build.BUILD_DIR / "probe" / f"{_build._target(name).stem}-{define}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}", "-o", str(out),
                               str(_build.CSRC / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
        for line in proc.stdout.splitlines():
            if "registers" in line or "spill" in line:
                print(f"probe build ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    getattr(lib, entry).argtypes = [ctypes.c_void_p]
    getattr(lib, entry).restype = ctypes.c_int
    return lib


# The ablation variants of K2, K6 and K8: (file, snippet, replacement) edits
# of their shared header (the dW partials) or of the kernel's own source (the
# hidden dW call, the same line in all three)
_LOAD = ("""          const float2 w = !first && o[0] >= 0 ? *reinterpret_cast<const float2*>(out + o[0])
                                               : make_float2(0.f, 0.f);""",
         "          const float2 w = make_float2(0.f, 0.f);")
_STORE = ("          if (at[t][e] >= 0) *reinterpret_cast<float2*>(out + at[t][e]) = make_float2(v0, v1);",
          "          if (at[t][e] >= 0 && v0 == 12345.f) out[at[t][e]] = v1;")
ABLATIONS = {
    "no dW partial loads": [("stack_tc.cuh", *_LOAD)],
    "no dW partial loads or stores": [("stack_tc.cuh", *_LOAD), ("stack_tc.cuh", *_STORE)],
    "no hidden dW": [(None,
        "        weight_grad_stack(Sm, Dp, ld, n, n16, TR, part + o_wh + (long long)m * n * n, first, l);",
        "")],
}
# The wgmma K2/K3 body's variant: without the loads and stores of its dW
# partial (the products kept alive)
WG_ABLATIONS = {
    "wgmma no dW partial loads or stores": [
        (None, "        if (owns && !first) dw_load<N>(dw, dw_c, th);\n", ""),
        (None, "        if (owns) dw_store<N>(dw, dw_c, th);",
         "        if (owns && dw[0] == 1.2345e30f) dw_store<N>(dw, dw_c, th);")],
}
# The wgmma K1/K5 body's variants: rint by two adds, no hidden sine, no
# hidden products
FWG_ABLATIONS = {
    "wgmma rint by two adds": [
        ("shapenet_common.cuh", "  return t - rintf(t);",
         "  return t - ((t + 12582912.f) - 12582912.f);")],
    "wgmma no hidden sine": [
        (None, "        v = sine_at<DEG9>(z, sp);", "        v = z;")],
    "wgmma no hidden products": [
        (None, "        for (int kk = 0; kk < KS; ++kk) mma_rs<N, 1>(acc, A + 4 * kk, w_mn<N>(w_u, kk), kk > 0);\n",
         "")],
}
# The wgmma K7/K8 body's variants: without the loads and stores of its dW
# partial (the products kept alive), and rint by two adds
HWG_ABLATIONS = {
    "hess wgmma no dW partial loads or stores": [
        (None, "          if (owns && !first) dw_load<N>(dw, dw_c, th);\n", ""),
        (None, "          if (owns) dw_store<N>(dw, dw_c, th);",
         "          if (owns && dw[0] == 1.2345e30f) dw_store<N>(dw, dw_c, th);")],
    "hess wgmma rint by two adds": FWG_ABLATIONS["wgmma rint by two adds"],
}
HEADERS = ("stack_simt.cuh", "stack_tc.cuh", "mma_sm90.cuh", "shapenet_common.cuh",
           "wgmma_sm90.cuh")


def build_variant(name: str, label: str, edits) -> ctypes.CDLL:
    """``csrc/<name>.cu`` and its headers with ``edits`` applied (file None:
    the source), built in a directory of their own (once: a directory that
    holds the same texts and its library is reused)."""
    files = {f: (_build.CSRC / f).read_text() for f in (f"{name}.cu", *HEADERS)}
    for file, old, new in edits:
        file = file or f"{name}.cu"
        if files[file].count(old) != 1:
            raise RuntimeError(f"ablation {label!r}: its snippet is not in {file} once")
        files[file] = files[file].replace(old, new)
    out = _build.BUILD_DIR / "probe" / "ablate" / label.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    if lib.exists() and all((out / f).exists() and (out / f).read_text() == text
                            for f, text in files.items()):
        return ctypes.CDLL(str(lib))
    lib.unlink(missing_ok=True)
    for file, text in files.items():
        (out / file).write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
                           str(out / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on ablation {label!r}:\n{proc.stdout}")
    for line in proc.stdout.splitlines():
        if "registers" in line or "spill" in line:
            print(f"{label} build ptxas: {line.strip()}")
    return ctypes.CDLL(str(out / f"lib{name}.so"))


def ablate(name: str, argtypes, run, ablations=ABLATIONS) -> None:
    """Time the kernel as built and its ablation variants, in turns, twice."""
    libs = {"as built": _build.load_library(name)}
    libs.update((label, build_variant(name, label, edits)) for label, edits in ablations.items())
    for rnd in range(2):
        for label, lib in libs.items():
            _build._LIBS[name] = lib
            argtypes()
            print(f"ablation round {rnd}: {label:32s} {cuda_ms(run, reps=5, warmup=1):.4f} ms",
                  flush=True)
    _build._LIBS[name] = libs["as built"]


def k1_case(G: int, P: int):
    """K1's launcher and (tile, splits) at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=206)
    return lambda: fs.shapenet_fwd_cuda(wb, x, cfg, "siren"), fs._k1_tc_status(cfg, "siren",
                                                                               G, P)[1]


def k5_case(G: int, P: int):
    """K5's launcher and (tile, splits) at the flagship chain (the reverse body)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=207)
    geo = fd.derivative_geometry("reverse", cfg, "siren", G, P, torch.bfloat16)
    return lambda: fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren"), geo


# One block per SM: the tensor-core K1 on 128-point tiles (the edits of its
# two constants), the float32 K1 on its own tiles at up to 255 registers a
# thread, and K5's tangent bodies likewise (the edit of their blocks-per-SM
# constant)
_TAN_ONE = (None, "constexpr int kTanBlocksPerSm = 2;", "constexpr int kTanBlocksPerSm = 1;")
ONE_BLOCK = {
    "k1": ("shapenet_fwd_tc", [
        (None, "constexpr int kFwdTp = 64; ", "constexpr int kFwdTp = 128;"),
        (None, "constexpr int kFwdBlocksPerSm = 2;", "constexpr int kFwdBlocksPerSm = 1;")]),
    "k1f32": ("shapenet_fwd", [
        (None, "constexpr int kK1BlocksPerSm = 2;", "constexpr int kK1BlocksPerSm = 1;")]),
    "k5tan": ("shapenet_jac_tc", [_TAN_ONE]),
    "k5tanf32": ("shapenet_jac", [_TAN_ONE]),
}
# K5's tangent bodies are timed at si = so = 3, the flagship widths
TANGENT_SHAPE = dict(FLAGSHIP_SHAPE, input_dim=3, output_dim=3)


def one_block(kernel: str, run) -> None:
    """A kernel as built and at one block per SM, timed in turns."""
    name, edits = ONE_BLOCK[kernel]
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    libs = {"as built": _build.load_library(name),
            "one block": build_variant(name, f"{kernel} one block", edits)}
    for label in ("as built", "one block", "one block", "as built"):
        _build._LIBS[name] = libs[label]
        if kernel == "k1":
            fs._fwd_tc_library()
            geo = fs._k1_tc_status(cfg, "siren", 32, 32768)[1]
            where = f"{geo['splits']} splits"
        elif kernel == "k1f32":
            fs._library()
            geo = fs.k1_geometry(cfg, "siren", 32, 32768, torch.float32)
            where = f"{geo['blocks']} blocks, {geo['blocks_per_sm']} an SM"
        else:
            fd._library("tc" if kernel == "k5tan" else "simt")
            dtype = torch.bfloat16 if kernel == "k5tan" else torch.float32
            geo = fd.derivative_geometry("tangent", ShapeNetConfig.from_dict(TANGENT_SHAPE),
                                         "siren", 32, 32768, dtype)
            where = (f"{geo['blocks']} blocks, {geo['blocks_per_sm']} an SM, weights from "
                     f"{geo['weights']} memory")
        print(f"{kernel.upper()} {label:10s} ({geo['tile']}-point tiles, {where}, "
              f"{geo['smem_bytes']} bytes of shared memory): {cuda_ms(run, reps=20):.4f} ms",
              flush=True)
    _build._LIBS[name] = libs["as built"]


def k2_case(G: int, P: int):
    """The mma.sync K2's launcher and (tile, splits) at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=204)
    tgt, w, _ = chip_smoke.side_data(torch, cfg, G, P, seed=204)
    geo = fs.k2_geometry(cfg, "siren", G, P, torch.bfloat16, kernel="tc")
    return lambda: fs._shapenet_mse_grads_on("tc", wb, x, tgt, cfg, "siren", w), geo


def k2wg_case(G: int, P: int):
    """The wgmma K2's launcher and geometry at the flagship chain, with
    point weights."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=204)
    tgt, w, _ = chip_smoke.side_data(torch, cfg, G, P, seed=204)
    geo = fs.k2_geometry(cfg, "siren", G, P, torch.bfloat16, kernel="wgmma")
    return lambda: fs._shapenet_mse_grads_on("wgmma", wb, x, tgt, cfg, "siren", w), geo


def k3wg_case(G: int, P: int):
    """The wgmma K3's launcher and geometry at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=208)
    g = chip_smoke.side_data(torch, cfg, G, P, seed=208)[2].to(torch.bfloat16)
    geo = fs.k3_geometry(cfg, "siren", G, P, torch.bfloat16, kernel="wgmma")
    return lambda: fs._shapenet_bwd_on("wgmma", wb, x, g, cfg, "siren"), geo


def k1wg_case(G: int, P: int):
    """The wgmma K1's launcher and geometry at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=206)
    geo = fs.k1_geometry(cfg, "siren", G, P, torch.bfloat16, kernel="wgmma")
    return lambda: fs._shapenet_fwd_on("wgmma", wb, x, cfg, "siren"), geo


def k5wg_case(G: int, P: int):
    """The wgmma K5 reverse body's launcher and geometry at the flagship
    chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=207)
    geo = fd._geometry("reverse", cfg, "siren", G, P, torch.bfloat16, kernel="wgmma")
    return lambda: fd._shapenet_fwd_jac_on("wgmma", wb, x, cfg, "siren"), geo


def k2f32_case(G: int, P: int):
    """The float32 K2's launcher and geometry at the flagship chain (the
    CUDA-core kernel, as the float32 policy's train step runs it)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=204)
    tgt, w, _ = chip_smoke.side_data(torch, cfg, G, P, seed=204)
    geo = fs.k2_geometry(cfg, "siren", G, P, torch.float32)
    return lambda: fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, "siren", w), geo


def k3f32_case(G: int, P: int):
    """The float32 K3's launcher and geometry at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=208)
    g = chip_smoke.side_data(torch, cfg, G, P, seed=208)[2]
    geo = fs.train_geometry(cfg, G, P, torch.float32)
    return lambda: fs.shapenet_bwd_cuda(wb, x, g, cfg, "siren"), geo


def k7f32_case(G: int, P: int):
    """The float32 K7's launcher and geometry at the flagship chain (the
    CUDA-core kernel, as the float32 policy's evaluate_sobolev runs it)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=209)
    geo = fh.hessian_geometry("eval", cfg, "siren", G, P, torch.float32)
    return lambda: fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren"), geo


def k8f32_case(G: int, P: int):
    """The float32 K8's launcher and geometry at the flagship chain, with
    Jacobian and Hessian targets (as the float32 policy's Hessian step runs
    it, unweighted)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=210)
    tgt, _, jt, ht = chip_smoke.hessian_data(torch, cfg, G, P, seed=210)
    geo = fh.hessian_geometry("train", cfg, "siren", G, P, torch.float32)
    return lambda: fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren", w_jac=0.1,
                                                  w_hess=0.01), geo


def k6f32_case(G: int, P: int):
    """The float32 K6's launcher and geometry at the flagship chain, with
    Jacobian targets (as the float32 policy's Sobolev step runs it,
    unweighted)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=212)
    tgt, _, jt = chip_smoke.sobolev_data(torch, cfg, G, P, seed=212)
    geo = fd.derivative_geometry("sobolev", cfg, "siren", G, P, torch.float32)
    return lambda: fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", w_jac=0.1), geo


def k4f32_case(G: int, P: int):
    """The float32 K4's launcher and geometry at the flagship NIF-linear
    trunk (as the float32 policy's NIF-linear step runs it, unweighted)."""
    cfg, so, ws, bs, a, bias, x, tgt, _ = chip_smoke.linear_data(
        torch, chip_smoke.LINEAR_CASES[0], G, P, torch.float32, seed=213)
    geo = fl.linear_geometry(cfg, so, G, P, torch.float32)
    return lambda: fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so), geo


def k1f32_case(G: int, P: int):
    """The float32 K1's launcher and geometry at the flagship chain (as the
    float32 policy's serving and evaluation run it)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=214)
    geo = fs.k1_geometry(cfg, "siren", G, P, torch.float32)
    return lambda: fs.shapenet_fwd_cuda(wb, x, cfg, "siren"), geo


def k5f32_case(G: int, P: int):
    """K5's float32 reverse body's launcher and geometry at the flagship
    chain (as the float32 policy's evaluate_sobolev runs it)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=215)
    geo = fd.derivative_geometry("reverse", cfg, "siren", G, P, torch.float32)
    return lambda: fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren"), geo


def k5tan_case(G: int, P: int, dtype=torch.bfloat16):
    """K5's tangent body's launcher and geometry at si = so = 3, the
    flagship widths: bf16 on the tensor cores (float32 for k5tanf32, on
    K6's forward half)."""
    cfg = ShapeNetConfig.from_dict(TANGENT_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, dtype, seed=216)
    geo = fd.derivative_geometry("tangent", cfg, "siren", G, P, dtype)
    return lambda: fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren"), geo


def device_split(run, reps: int) -> None:
    """Device time per kernel name over ``reps`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if ev.device_time_total > 0:
            print(f"  device: {ev.key[:60]:60s} {ev.device_time_total / reps:10.1f} us a call")


def k4_case(G: int, P: int):
    """K4's launcher and (tile, splits) at the flagship NIF-linear trunk."""
    cfg, so, ws, bs, a, bias, x, tgt, _ = chip_smoke.linear_data(
        torch, chip_smoke.LINEAR_CASES[0], G, P, torch.bfloat16, seed=200)
    geo = fl.linear_geometry(cfg, so, G, P, torch.bfloat16)
    return lambda: fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so), geo


def k6_case(G: int, P: int):
    """K6's launcher and (tile, splits) at the flagship chain."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=202)
    tgt, w, jt = chip_smoke.sobolev_data(torch, cfg, G, P, seed=202)
    geo = fd.derivative_geometry("sobolev", cfg, "siren", G, P, torch.bfloat16)
    return lambda: fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", weight=w), geo


def k7_case(G: int, P: int, body: str = "tc"):
    """K7's launcher and geometry at the flagship chain, on ``body`` (the
    ``mma.sync`` body; k7wg: the wgmma one)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=205)
    geo = fh.hessian_geometry("eval", cfg, "siren", G, P, torch.bfloat16, kernel=body)
    return lambda: fh._shapenet_fwd_hess_on(body, wb, x, cfg, "siren"), geo


def k8_case(G: int, P: int, body: str = "tc"):
    """K8's launcher and geometry at the flagship chain, with point weights,
    on ``body`` (the ``mma.sync`` body; k8wg: the wgmma one)."""
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=201)
    tgt, w, jt, ht = chip_smoke.hessian_data(torch, cfg, G, P, seed=201)
    geo = fh.hessian_geometry("train", cfg, "siren", G, P, torch.bfloat16, kernel=body)
    return lambda: fh._shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, cfg, "siren",
                                                 weight=w), geo


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k4")
    ap.add_argument("--ablate", action="store_true",
                    help="K2, K6, K8 and the wgmma K1/K2/K3/K5/K8 only: also time variants "
                         "without parts of their dW (K1/K5: of their epilogues or products)")
    ap.add_argument("--one-block", action="store_true",
                    help="K1 and K5's tangent body only (k1, k1f32, k5tan, k5tanf32): "
                         "also time it at one block per SM")
    args = ap.parse_args()
    if args.ablate and args.kernel not in ("k2", "k6", "k8", "k2wg", "k3wg", "k1wg", "k5wg",
                                           "k8wg"):
        ap.error("--ablate takes --kernel k2, k6, k8, k1wg, k2wg, k3wg, k5wg or k8wg")
    if args.one_block and args.kernel not in ONE_BLOCK:
        ap.error("--one-block takes --kernel k1, k1f32, k5tan or k5tanf32")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    name, define, entry, phases = KERNELS[args.kernel]
    G, P = 32, 32768
    cases = {"k1": k1_case, "k2": k2_case, "k2f32": k2f32_case, "k3f32": k3f32_case,
             "k2wg": k2wg_case, "k3wg": k3wg_case, "k1wg": k1wg_case, "k5wg": k5wg_case,
             "k4": k4_case, "k5": k5_case, "k6": k6_case, "k7": k7_case, "k8": k8_case,
             "k7wg": lambda G, P: k7_case(G, P, "wgmma"),
             "k8wg": lambda G, P: k8_case(G, P, "wgmma"),
             "k7f32": k7f32_case, "k8f32": k8f32_case, "k6f32": k6f32_case,
             "k4f32": k4f32_case, "k1f32": k1f32_case, "k5f32": k5f32_case,
             "k5tan": k5tan_case,
             "k5tanf32": lambda G, P: k5tan_case(G, P, torch.float32)}
    run, geo = cases[args.kernel](G, P)
    reps = 3 if args.kernel in ("k8", "k8wg", "k7f32", "k8f32", "k6f32") else 10
    plain_build_ms = cuda_ms(run, reps=reps, warmup=1)
    # registers the argument types of the library now in _build._LIBS
    argtypes = {"k1": fs._fwd_tc_library, "k2": fs._bwd_tc_library,
                "k2wg": fs._bwd_wg_library, "k3wg": fs._bwd_wg_library,
                "k1wg": fs._fwd_wg_library, "k5wg": fs._fwd_wg_library,
                "k2f32": fs._bwd_library, "k3f32": fs._bwd_library,
                "k4": lambda: fl._library("tc"), "k5": fs._fwd_tc_library,
                "k6": lambda: fd._library("tc"), "k7": lambda: fh._library("tc"),
                "k8": lambda: fh._library("tc"), "k7f32": lambda: fh._library("simt"),
                "k7wg": lambda: fh._library("wgmma"), "k8wg": lambda: fh._library("wgmma"),
                "k8f32": lambda: fh._library("simt"), "k6f32": lambda: fd._library("simt"),
                "k4f32": lambda: fl._library("simt"), "k1f32": fs._library,
                "k5f32": fs._library, "k5tan": lambda: fd._library("tc"),
                "k5tanf32": lambda: fd._library("simt")}[args.kernel]
    simt = name in ("shapenet_bwd", "shapenet_hess", "shapenet_jac", "shapenet_linear",
                    "shapenet_fwd")
    if simt:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"plain build ptxas: {line.strip()}")
        device_split(run, reps)
    if args.ablate:
        ablate(name, argtypes, run, {"shapenet_bwd_wgmma": WG_ABLATIONS,
                                     "shapenet_fwd_wgmma": FWG_ABLATIONS,
                                     "shapenet_hess_wgmma": HWG_ABLATIONS}.get(name, ABLATIONS))
    if args.one_block:
        one_block(args.kernel, run)
    probe = build_probe(name, define, entry)
    _build._LIBS[name] = probe  # the wrapper now launches the probe build
    argtypes()
    # each C entry copies its source's whole counter array (kPhases, up to
    # ten), which may hold more counters than the kernel's phases use
    buf = (ctypes.c_ulonglong * COUNTER_ROOM)()
    read = getattr(probe, entry)
    run()
    torch.cuda.synchronize()
    read(buf)  # drop the warm-up's counts
    probe_ms = cuda_ms(run, reps=reps, warmup=0)
    err = read(buf)
    if err:
        raise RuntimeError(f"reading the phase counters failed: CUDA error {err}")
    counters = list(buf)[:len(phases)]
    # the CUDA-core K4 is one wave of "blocks" over every group's tiles, the
    # other kernels "splits" blocks a group
    blocks = geo["blocks"] if "blocks" in geo else G * geo["splits"]
    tiles = G * -(-P // geo["tile"]) / blocks
    # who keeps the counters: thread 0 of a block, or of each of the wgmma
    # bodies' two consumer warpgroups (each a half of every tile of its block)
    keepers = blocks * (2 if name in ("shapenet_bwd_wgmma", "shapenet_fwd_wgmma",
                                      "shapenet_hess_wgmma") else 1)
    total = sum(counters)
    what = "f32, CUDA cores" if simt else "tc bf16"
    print(f"{args.kernel.upper()} {what} at G={G} P={P}: {plain_build_ms:.4f} ms (plain build), "
          f"{probe_ms:.4f} ms (phase-clock build); {blocks} blocks of {tiles:.0f} "
          f"{geo['tile']}-point tiles")
    print(f"critical path of one block{' (a consumer of it)' if keepers > blocks else ''}: "
          f"{total / keepers / reps:.0f} cycles a call, {total / keepers / reps / tiles:.0f} a tile")
    for label, c in zip(phases, counters):
        print(f"  {label:40s} {c / keepers / reps / tiles:9.0f} cycles a tile  {c / total:7.4f}  "
              f"~{c / total * probe_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
