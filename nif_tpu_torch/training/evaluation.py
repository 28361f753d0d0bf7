"""Evaluation helpers (counterpart of ``nif_tpu/training/evaluation.py``).

Each rank accumulates LOCAL squared-error and target sums over its own
groups or rows (coordinate points are independent, so evaluation needs no
collective until then); :func:`global_sums` joins them with one float64
``all_reduce``, so every rank gets the same global metric. Without a process
group it is the identity. ``local_params`` (the model's parameters as a
numpy tree, a tensor-parallel head reassembled) comes from
``parallel/state.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.state import local_params

__all__ = ["global_sums", "local_params", "metrics_from_sums"]


def global_sums(*partials: float, mesh=None) -> Tuple[float, ...]:
    """Sum scalar partial sums across the ranks: over every process (JAX's
    ``process_allgather`` sum), or over the batch axes of ``mesh`` (the
    ranks of a model group hold the same groups, so each counts once).
    The identity without a process group. A collective: every rank calls
    it the same number of times."""
    if not (dist.is_available() and dist.is_initialized()):
        return tuple(float(p) for p in partials)
    from ..parallel.collectives import collective_device, sum_over
    from ..parallel.mesh import batch_axes

    stacked = torch.tensor([float(p) for p in partials], dtype=torch.float64,
                           device=collective_device())
    groups = [None] if mesh is None else [mesh.group(a) for a in batch_axes(mesh)]
    return tuple(float(v) for v in sum_over(stacked, groups).cpu())


def metrics_from_sums(sse: float, sst: float, n_el: float) -> dict:
    """MSE and rel-L2 from (globally reduced) squared-error/target sums."""
    return {
        "mse": sse / max(n_el, 1.0),
        "rel_l2": float(np.sqrt(sse / max(sst, 1e-300))),
    }
