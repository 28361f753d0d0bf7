"""Learning-rate schedules evaluated at an optimizer's own update count.

optax evaluates a schedule at the update count before it increments it, so
update k (counting from 0) runs at ``schedule(k)``. :func:`with_schedule`
gives a ``torch.optim.Optimizer`` the same rule: a step pre-hook writes
``schedule(count)`` into every param group's ``lr`` and increments the
group's ``"schedule_count"`` (a param-group entry, so ``state_dict`` saves
it and a resumed run continues the schedule).

Under CUDA-graph capture the hook does nothing: a captured whole step reads
its learning rate from a device tensor, and the resident loop calls
:func:`advance_schedule` and fills that tensor before every replay
(``training/resident.py``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["with_schedule", "advance_schedule", "factory", "cosine_decay_schedule"]


def advance_schedule(optimizer) -> None:
    """Set every param group's ``lr`` to the schedule at the group's count,
    and count one update."""
    schedule = optimizer.lr_schedule
    for group in optimizer.param_groups:
        count = group["schedule_count"]
        group["lr"] = float(schedule(count))
        group["schedule_count"] = count + 1


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _pre_step(optimizer, args, kwargs) -> None:
    if not _capturing():
        advance_schedule(optimizer)


def with_schedule(optimizer, schedule: Callable[[int], float]):
    """Run ``optimizer`` at ``schedule(k)`` on its k-th update (from 0), as
    an optax chain ending in ``scale_by_learning_rate(schedule)`` does.
    Returns the optimizer."""
    optimizer.lr_schedule = schedule
    for group in optimizer.param_groups:
        group.setdefault("schedule_count", 0)
        group["lr"] = float(schedule(group["schedule_count"]))
    optimizer.register_step_pre_hook(_pre_step)
    return optimizer


def factory(build: Callable, learning_rate):
    """The optimizer factory ``params -> build(params, lr)`` at
    ``learning_rate``: a float, or a ``step -> lr`` schedule run by
    :func:`with_schedule`."""
    def make(params):
        if callable(learning_rate):
            return with_schedule(build(params, 0.0), learning_rate)
        return build(params, learning_rate)

    return make


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` as a ``step -> lr`` function:
    ``init_value * ((1 - alpha) * (0.5 * (1 + cos(pi * min(step, decay_steps)
    / decay_steps))) ** exponent + alpha)``, in float32 as optax computes it.
    Under ``fit_resident``'s whole-step graph it advances per replay."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got "
                         f"decay_steps={decay_steps}")
    f32 = np.float32

    def schedule(step: int) -> float:
        count = f32(min(float(step), float(decay_steps)))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * count / f32(decay_steps)))
        decayed = f32(1.0 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(init_value) * decayed)

    return schedule
