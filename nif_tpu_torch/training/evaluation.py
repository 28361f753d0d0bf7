"""Evaluation helpers (counterpart of ``nif_tpu/training/evaluation.py``).

Each process accumulates LOCAL squared-error and target sums; the metrics
come from the reduced sums. This slice runs one process: :func:`global_sums`
is the identity there, and refuses to run under an initialized
``torch.distributed`` process group until multi-GPU evaluation is ported
(ROADMAP Slice G).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["global_sums", "metrics_from_sums"]


def global_sums(*partials: float) -> Tuple[float, ...]:
    """Sum scalar partial sums across every process: the identity in a
    single process. Raises under an initialized ``torch.distributed``."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise NotImplementedError(
            "global_sums across torch.distributed processes is not ported yet "
            "(ROADMAP Slice G: multi-GPU)"
        )
    return tuple(float(p) for p in partials)


def metrics_from_sums(sse: float, sst: float, n_el: float) -> dict:
    """MSE and rel-L2 from (globally reduced) squared-error/target sums."""
    return {
        "mse": sse / max(n_el, 1.0),
        "rel_l2": float(np.sqrt(sse / max(sst, 1e-300))),
    }
