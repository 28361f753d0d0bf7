#!/usr/bin/env python3
"""The tutorials' phase of ``chip_smoke.py`` (3p) and its two-rank phase
(3n) alone, on one CUDA card:

    python3 scripts/port_examples_probe.py

Builds the kernels these phases launch side by side (K1 and K2 on the
tensor cores; the CUDA-core K2, K6 and K8 with K7; and the CUDA-core K1's
library, whose geometry every K1 gate asks), then runs phase 3p
(tutorial 13 at ``--paper`` for 3 epochs under ``torch.profiler``,
``entry()`` through ``torch.export`` and ``torch.compile``, tutorials 8, 5,
1 and 10 at the CPU tests' budgets) and phase 3n (two gloo ranks sharing the
card: data parallelism, the row-parallel head, ZeRO-1 and the split-head
``GroupedLBFGS`` against one process). The quick loop for a change to
``nif_tpu_torch/examples``, ``entry.py`` or the L-BFGS split head;
``chip_smoke.py`` runs the same phases after all the others.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SOURCES = ["shapenet_fwd", "shapenet_fwd_tc", "shapenet_bwd", "shapenet_bwd_tc",
           "shapenet_jac", "shapenet_hess"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_examples_probe: CUDA is not available", file=sys.stderr)
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
    cs.build_all(SOURCES)
    cs.phase_examples(torch, cs.log, smi)
    cs.phase_two_ranks(torch, cs.log, smi)
    cs.log(f"probe wall clock: {time.perf_counter() - wall0:.1f} s (builds included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
