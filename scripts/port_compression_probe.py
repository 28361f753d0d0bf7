#!/usr/bin/env python3
"""The compression and export phases of ``chip_smoke.py`` alone, on one
CUDA card:

    python3 scripts/port_compression_probe.py

Builds the kernels these phases launch (K1 in both variants for the
exported ``grouped`` artifact, K2 for the pruned train steps) side by side,
then runs phase 3j (the NIF-linear flagship's int8 ROM decode at G=256 x
P=32768 in both policies, its checks and times), 3k (``export_apply`` /
``load_exported`` on the card: the flagship's ``grouped`` artifact launches
K1 once a call) and 3l (``MagnitudePruning`` in ``GroupedTrainer.step`` and
``fit_resident``). The quick loop for a change to ``compression/``,
``serving/export.py`` or K1's registered op; ``chip_smoke.py`` runs the same
phases after all the others.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_compression_probe: CUDA is not available", file=sys.stderr)
        return 1
    wall0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} card: {smi}")
    cs.build_all(["shapenet_fwd", "shapenet_fwd_tc", "shapenet_fwd_wgmma", "shapenet_bwd",
                  "shapenet_bwd_tc"])
    for policy in ("mixed_bfloat16", "float32"):
        cs.rom_decode_phase(torch, cs.log, smi, policy)
    cs.export_phase(torch, cs.log, smi)
    resident_np = cs.traveling_wave(cs.RESIDENT_G, cs.RESIDENT_P, seed=21)
    cs.pruning_phase(torch, cs.log, smi, resident_np)
    cs.log(f"probe wall clock: {time.perf_counter() - wall0:.1f} s (builds included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
