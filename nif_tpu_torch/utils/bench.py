"""The flagship serving model and a device timer, shared by the scripts that
drive the port on a card (``chip_smoke.py``, ``scripts/port_serving_profile.py``).

The flagship is the JAX package's ``bench.py`` model: NIFMultiScale with a
SIREN ShapeNet 3 -> 1 of width 128 and two hidden layers (omega_0 = 30) and
an ``mlp_hyper`` ParameterNet 4 -> 128 x 2 (swish, latent 128), so
po = 33665, under ``mixed_bfloat16``.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["FLAGSHIP_SHAPE", "FLAGSHIP_PNET", "FLAGSHIP_POLICY", "cuda_ms"]

FLAGSHIP_SHAPE = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
                  "activation": "sine", "use_resblock": False, "omega_0": 30.0,
                  "connectivity": "full", "weight_init_factor": 0.01}
FLAGSHIP_PNET = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
                 "activation": "swish", "use_resblock": False, "omega_0": 30.0}
FLAGSHIP_POLICY = "mixed_bfloat16"


def cuda_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls
    after ``warmup`` calls, from CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
