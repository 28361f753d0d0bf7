#!/usr/bin/env python3
"""Where the tensor-core K4 (``nif_tpu_torch/csrc/shapenet_linear_tc.cu``)
spends its time, phase by phase, on a CUDA card.

    python3 scripts/port_k4_phase_probe.py

Builds the kernel's source once more with ``-DK4_PHASE_CLOCKS`` (into
``build/nif_tpu_torch/probe/``), in which thread 0 of every block adds the
``clock64()`` cycles between consecutive barriers into eight phase counters,
and runs it through the usual wrapper at the flagship NIF-linear shape (G=32,
P=32768, bf16, random trunk from a seed). Prints the kernel's time (CUDA
events, the instrumented build beside the plain one) and each phase's share
of the blocks' critical path. The counters cost a few instructions at each
barrier; the plain build's time says how much. Nothing is asserted.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nif_tpu_torch.ops import _build  # noqa: E402
from nif_tpu_torch.ops import fused_linear as fl  # noqa: E402
from nif_tpu_torch.utils.bench import cuda_ms  # noqa: E402

PHASES = [
    "x tile",
    "first layer + hidden forward",
    "bottleneck forward + contraction",
    "loss and dL/du (target, weight)",
    "d_bias, d_a sums, d_phi",
    "d_a, bottleneck dW/db, du",
    "hidden layers' backward",
    "first layer's backward (dW0, db0)",
]


def build_probe() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe" / "libshapenet_linear_tc_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK4_PHASE_CLOCKS", "-o", str(out),
                           str(_build.CSRC / "shapenet_linear_tc.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    for line in proc.stdout.splitlines():
        if "registers" in line or "spill" in line:
            print(f"probe build ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    lib.nif_linear_tc_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.nif_linear_tc_phase_cycles.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    G, P = 32, 32768
    cfg, so, ws, bs, a, bias, x, tgt, _ = chip_smoke.linear_data(
        torch, chip_smoke.LINEAR_CASES[0], G, P, torch.bfloat16, seed=200)
    run = lambda: fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so)  # noqa: E731
    plain_build_ms = cuda_ms(run, reps=10)
    probe = build_probe()
    _build._LIBS["shapenet_linear_tc"] = probe  # the wrapper now launches the probe build
    fl._library("tc")  # its argument types
    counters = (ctypes.c_ulonglong * len(PHASES))()
    run()
    torch.cuda.synchronize()
    probe.nif_linear_tc_phase_cycles(counters)  # drop the warm-up's counts
    reps = 5
    probe_ms = cuda_ms(run, reps=reps, warmup=0)
    err = probe.nif_linear_tc_phase_cycles(counters)
    if err:
        raise RuntimeError(f"reading the phase counters failed: CUDA error {err}")
    geo = fl.linear_geometry(cfg, so, G, P, torch.bfloat16)
    blocks = G * geo["splits"]
    tiles = -(-P // geo["tile"]) / geo["splits"]
    total = sum(counters)
    print(f"K4 tc at G={G} P={P} bf16: {plain_build_ms:.4f} ms (plain build), {probe_ms:.4f} ms "
          f"(phase-clock build); {blocks} blocks of {tiles:.0f} {geo['tile']}-point tiles")
    print(f"critical path of one block: {total / blocks / reps:.0f} cycles a call, "
          f"{total / blocks / reps / tiles:.0f} a tile")
    for name, c in zip(PHASES, counters):
        print(f"  {name:36s} {c / blocks / reps / tiles:9.0f} cycles a tile  {c / total:7.4f}  "
              f"~{c / total * probe_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
