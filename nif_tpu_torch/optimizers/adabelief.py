"""AdaBelief (counterpart of ``nif_tpu/optimizers/adabelief.py`` and of the
AdaBelief forms of ``nif_tpu/optimizers/__init__.py``).

``AdaBelief`` is a ``torch.optim.Optimizer`` with the two scalings the JAX
package chains from:

* ``form="optax"``: optax's ``scale_by_belief``: ``m = (1-b1) g + b1 m``,
  ``s = (1-b2) (g-m)^2 + b2 s + eps_root``, update ``m_hat / (sqrt(s_hat) +
  eps)``, bias corrections in the parameters' dtype;
* ``form="full"``: the JAX package's own ``scale_by_belief``: ``eps``
  inside ``s``, RAdam rectification (the ``sma_t`` gate, a momentum-SGD step
  below it unless ``degenerated_to_sgd=False``) and AMSGrad's running
  maximum ``s_max`` (kept only under ``amsgrad``), bias corrections and the
  rectification in float32 whatever the parameters' dtype.

Either form then adds decoupled weight decay ``weight_decay * p`` to the
update (optax's ``add_decayed_weights``, after the scaling) and steps by
``-lr`` times it.
"""
from __future__ import annotations

import numpy as np
import torch

from .schedule import factory

__all__ = ["AdaBelief", "adabelief_full"]


def _pow32(base: float, t: int) -> np.float32:
    """``float32(base) ** t`` rounded once to float32 (as the JAX package's
    float32 bias corrections compute it for the counts training reaches)."""
    return np.float32(np.float64(np.float32(base)) ** t)


def _bias_correction(decay: float, t: int, dtype: torch.dtype) -> float:
    """``1 - decay ** t`` in ``dtype`` (optax computes it in the default
    float dtype, float64 when the parameters are)."""
    if dtype == torch.float64:
        return 1.0 - decay ** t
    return float(np.float32(1.0) - _pow32(decay, t))


class AdaBelief(torch.optim.Optimizer):
    """AdaBelief on every parameter with a gradient. See the module
    docstring for ``form``; ``eps_root`` applies to ``form="optax"`` only,
    ``rectify``, ``amsgrad``, ``sma_threshold`` and ``degenerated_to_sgd`` to
    ``form="full"`` only."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-14,
                 eps_root: float = 1e-16, weight_decay: float = 0.0, form: str = "optax",
                 rectify: bool = True, amsgrad: bool = False, sma_threshold: float = 5.0,
                 degenerated_to_sgd: bool = True):
        if form not in ("optax", "full"):
            raise ValueError(f"unknown AdaBelief form {form!r}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, eps_root=eps_root,
                        weight_decay=weight_decay, form=form, rectify=rectify, amsgrad=amsgrad,
                        sma_threshold=sma_threshold, degenerated_to_sgd=degenerated_to_sgd)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group)
        return loss

    def _update(self, p, group) -> None:
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        full = group["form"] == "full"
        g = p.grad
        st = self.state[p]
        if not st:
            st["step"] = 0
            st["m"] = torch.zeros_like(p)
            st["s"] = torch.zeros_like(p)
            if full and group["amsgrad"]:
                st["s_max"] = torch.zeros_like(p)
        st["step"] += 1
        t = st["step"]
        if full:
            m = b1 * st["m"] + (1 - b1) * g
            s = b2 * st["s"] + (1 - b2) * torch.square(g - m) + eps
            s_used = s
            if group["amsgrad"]:
                st["s_max"] = s_used = torch.maximum(st["s_max"], s)
            update = self._full_update(m, s_used, t, group)
        else:
            m = (1 - b1) * g + b1 * st["m"]
            s = (1 - b2) * torch.square(g - m) + b2 * st["s"]
            s = s + group["eps_root"]
            m_hat = m / _bias_correction(b1, t, p.dtype)
            s_hat = s / _bias_correction(b2, t, p.dtype)
            update = m_hat / (torch.sqrt(s_hat) + eps)
        st["m"], st["s"] = m, s
        if wd:
            update = update + wd * p
        p.add_((-group["lr"]) * update)

    @staticmethod
    def _full_update(m, s, t: int, group) -> torch.Tensor:
        """The JAX package's ``scale_by_belief`` update; its scalars are
        float32 (``t`` is cast to float32 there)."""
        b1, b2 = group["betas"]
        eps = group["eps"]
        f32 = np.float32
        bc1 = float(f32(1.0) - _pow32(b1, t))
        bc2 = f32(1.0) - _pow32(b2, t)
        if not group["rectify"]:
            return (m / bc1) / (torch.sqrt(s / float(bc2)) + eps)
        sma_inf = 2.0 / (1 - b2) - 1.0
        sma_t = f32(sma_inf) - f32(2.0) * f32(t) * _pow32(b2, t) / bc2
        r = ((sma_t - f32(4.0)) / f32(max(sma_inf - 4.0, 1e-9)) * (sma_t - f32(2.0))
             / f32(max(sma_inf - 2.0, 1e-9)) * f32(sma_inf) / max(sma_t, f32(1e-9)))
        r_t = float(np.sqrt(max(r, f32(0.0))))
        if sma_t >= group["sma_threshold"]:
            return r_t * (m / bc1) / (torch.sqrt(s / float(bc2)) + eps)
        return (1.0 if group["degenerated_to_sgd"] else 0.0) * (m / bc1)


def adabelief_full(
    learning_rate=1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-14,
    weight_decay: float = 0.0,
    rectify: bool = True,
    amsgrad: bool = False,
    sma_threshold: float = 5.0,
    degenerated_to_sgd: bool = True,
    total_steps: int = 0,
    warmup_proportion: float = 0.1,
    min_lr: float = 0.0,
):
    """The JAX package's full AdaBelief (``form="full"``) as an optimizer
    factory ``params -> AdaBelief``; ``total_steps > 0`` runs it on
    :func:`~nif_tpu_torch.optimizers.warmup_linear_decay`, and a callable
    ``learning_rate`` is a schedule of the update count."""
    from . import warmup_linear_decay

    lr = learning_rate
    if total_steps and total_steps > 0:
        lr = warmup_linear_decay(learning_rate, total_steps, warmup_proportion, min_lr)

    return factory(lambda p, lr: AdaBelief(
        p, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay, form="full",
        rectify=rectify, amsgrad=amsgrad, sma_threshold=sma_threshold,
        degenerated_to_sgd=degenerated_to_sgd), lr)

