"""Pieces of the training loop shared by the trainers (counterpart of
``nif_tpu/training/trainer.py``): zero-weight batch padding and the train
state. The point-wise ``Trainer`` is not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TrainState", "pad_batch", "reg_row_weights"]


def pad_batch(arrays, weight, n_real: int, n_target: int):
    """Pad a batch's dim 0 to ``n_target`` with zero-weight filler rows.

    Real rows get their weight scaled by ``n_target / n_real`` so the
    mean-reduced weighted MSE over the padded batch equals the exact mean
    over the real rows — tail batches and mesh-divisibility padding change
    neither the loss value nor the gradient. Batch-mean regularization
    terms (act_l1/l2, jac_reg) need the same correction *without* the
    user's sample weights folded in; pass ``reg_row_weights`` as the
    model's ``reg_weight``.
    """
    scale = n_target / n_real
    w = (np.ones(n_real, np.float32) if weight is None
         else np.asarray(weight, np.float32)) * scale
    if n_target == n_real:
        return arrays, w
    pad = n_target - n_real
    padded = tuple(
        np.concatenate(
            [a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])], axis=0
        )
        for a in arrays
    )
    return padded, np.concatenate([w, np.zeros(pad, np.float32)])


def reg_row_weights(n_real: int, n_target: int) -> np.ndarray:
    """Per-row weights making a padded batch's batch-mean regularization
    terms exact: ``n_target/n_real`` for real rows, 0 for filler, so
    ``mean(per_row * w)`` over ``n_target`` rows equals the true mean over
    the ``n_real`` real rows."""
    w = np.zeros(n_target, np.float32)
    w[:n_real] = n_target / n_real
    return w


class TrainState:
    """The train state: ``params`` (every parameter of the model, an
    ``nn.ModuleDict`` keyed like the JAX params tree: ``"pnet"``, and
    ``"snet"`` for NIF-linear's trunk), ``opt_state`` (the
    ``torch.optim.Optimizer`` over them) and ``step``. PyTorch updates the
    parameters and the optimizer in place, so a new state shares both with
    the one it was made from and carries the next step count."""

    def __init__(self, params, opt_state, step=0):
        self.params = params
        self.opt_state = opt_state
        self.step = step
