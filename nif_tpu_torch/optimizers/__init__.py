"""Optimizers (counterpart of ``nif_tpu/optimizers``).

Each first-order optimizer is a factory ``params -> torch.optim.Optimizer``,
the form the trainers take (the counterpart of an optax transformation):

* ``adam``                  — ``torch.optim.Adam`` with optax's defaults.
* ``adabelief``             — optax's AdaBelief (with weight decay: optax's
  ``scale_by_belief``, decoupled decay, then the learning rate), with the
  reference's linear warmup + decay through ``total_steps``.
* ``adabelief_full``        — the JAX package's own AdaBelief: rectified,
  optionally AMSGrad.
* ``lion``                  — sign-momentum Lion.
* ``centralize_gradients``  — gradient centralization before another
  optimizer's step.
* ``warmup_linear_decay``   — a ``step -> lr`` schedule; an optimizer given
  one evaluates it at its own update count (:mod:`.schedule`).
* ``cosine_decay_schedule`` — optax's cosine decay, the same kind of
  schedule.

Full-batch fine-tuning: ``lbfgs_minimize`` (an L-BFGS loop with optax's zoom
line search, on one flat parameter vector), ``LBFGS`` (point-wise) and
``GroupedLBFGS`` (the grouped layout, whose objective evaluations are the
fused train kernels K2, K4, K6 or K8 on the card), and ``cast_parameters``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .adabelief import AdaBelief, adabelief_full
from .lbfgs import LBFGS, GroupedLBFGS, cast_parameters, lbfgs_minimize
from .lion import Lion
from .schedule import cosine_decay_schedule, factory

__all__ = [
    "adam",
    "adabelief",
    "adabelief_full",
    "lion",
    "centralize_gradients",
    "warmup_linear_decay",
    "cosine_decay_schedule",
    "get_optimizer",
    "AdaBelief",
    "Lion",
    "LBFGS",
    "GroupedLBFGS",
    "lbfgs_minimize",
    "cast_parameters",
]


def warmup_linear_decay(
    peak_lr: float,
    total_steps: int,
    warmup_proportion: float = 0.1,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """Linear warmup from 0 to ``peak_lr`` over ``max(1, int(total_steps *
    warmup_proportion))`` steps, then linear decay to ``min_lr`` over the
    rest: the reference AdaBelief's schedule, as optax's joined linear
    schedules compute it (in float32), as a plain ``step -> lr`` function."""
    warmup = max(1, int(total_steps * warmup_proportion))
    decay = max(1, total_steps - warmup)
    f32 = np.float32

    def linear(init, end, steps, count):
        frac = f32(1.0) - f32(min(max(count, 0), steps)) / f32(steps)
        return f32(init - end) * frac + f32(end)

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            return float(linear(0.0, peak_lr, warmup, step))
        return float(linear(peak_lr, min_lr, decay, step - warmup))

    return schedule


def adam(learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, **kw):
    """``torch.optim.Adam`` (optax's ``m_hat / (sqrt(v_hat) + eps)``) with
    optax's defaults; ``learning_rate`` a float or a ``step -> lr``
    schedule; ``kw`` goes to ``torch.optim.Adam`` (e.g. ``capturable=True``,
    which ``fit_resident`` captures with the whole step)."""
    return factory(lambda p, lr: torch.optim.Adam(p, lr=lr, betas=(b1, b2), eps=eps, **kw),
                   learning_rate)


def adabelief(
    learning_rate: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-14,
    weight_decay: float = 0.0,
    total_steps: int = 0,
    warmup_proportion: float = 0.1,
    min_lr: float = 0.0,
):
    """optax's AdaBelief (``eps_root=1e-16``); ``weight_decay`` adds
    decoupled decay after the belief scaling; ``total_steps > 0`` runs it on
    :func:`warmup_linear_decay`."""
    lr = learning_rate
    if total_steps and total_steps > 0:
        lr = warmup_linear_decay(learning_rate, total_steps, warmup_proportion, min_lr)

    return factory(lambda p, lr: AdaBelief(p, lr=lr, betas=(b1, b2), eps=eps,
                                           weight_decay=weight_decay, form="optax"), lr)


def lion(learning_rate=1e-4, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0):
    """optax's Lion; ``learning_rate`` a float or a ``step -> lr`` schedule."""
    return factory(lambda p, lr: Lion(p, lr=lr, betas=(b1, b2), weight_decay=weight_decay),
                   learning_rate)


def _centralize(optimizer, args, kwargs) -> None:
    """Centre each gradient of rank > 1 over every axis but the last (the
    port keeps the JAX package's ``[fan_in, fan_out]`` layout, so these are
    the axes the JAX transform averages over)."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                g = p.grad
                if g is not None and g.dim() > 1:
                    g.sub_(g.mean(dim=tuple(range(g.dim() - 1)), keepdim=True))


def centralize_gradients(optimizer: Callable):
    """Gradient Centralization (Yong et al., 2020) before ``optimizer``'s
    update: the port's ``optax.chain(centralize_gradients(), optimizer)``.
    ``optimizer`` is a factory; the result is one, whose optimizer centres
    the gradients in place in a step pre-hook (captured with the step when
    the step is captured)."""
    def make(params):
        opt = optimizer(params)
        opt.register_step_pre_hook(_centralize)
        return opt

    return make


def get_optimizer(name: str, learning_rate: float = 1e-3, **kw):
    name = name.lower()
    if name == "adam":
        return adam(learning_rate, **kw)
    if name == "adabelief":
        return adabelief(learning_rate, **kw)
    if name == "lion":
        return lion(learning_rate, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
