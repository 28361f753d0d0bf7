"""Magnitude pruning (counterpart of ``nif_tpu/compression/pruning.py``).

The reference integrates tfmot low-magnitude pruning: every custom layer
implements ``PrunableLayer.get_prunable_weights`` and tutorial 7 prunes the
ParameterNet (reference nif/layers/siren.py:298-304, README.md:228-230).
Here: a 0/1 mask tree computed from parameter magnitudes, either applied
once after training (:func:`prune_by_magnitude`, :func:`apply_mask`) or
enforced during training by :func:`MagnitudePruning`, an optimizer factory
whose optimizer ramps the sparsity up and projects the parameters onto the
mask after every update.

A params tree is a nested dict keyed like the JAX params tree, holding
tensors, or the model's own ``model.param_tree()``. By convention only
tensors of rank >= 2 ("kernels") are pruned; biases stay dense, matching
``get_prunable_weights`` returning ``[self.w]``. The port keeps the JAX
layout ``[fan_in, fan_out]``, so the same tensors are prunable.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["prune_by_magnitude", "apply_mask", "sparsity", "MagnitudePruning"]


def _prunable(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def _leaf(x) -> torch.Tensor:
    """A params tree's leaf as a tensor: detached, or from an array."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))


def _tree_map(fn: Callable, tree, *rest, is_leaf: Callable = lambda x: False):
    """``fn`` over the leaves of a nested dict (or ``nn.ModuleDict`` /
    ``ParameterDict`` tree, e.g. ``model.param_tree()``) and the matching
    leaves of ``rest``: a nested dict of the results. A leaf is a node
    without ``items()`` (passed as a tensor, :func:`_leaf`) or one that
    ``is_leaf`` names (passed as it is)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if not hasattr(tree, "items"):
        return fn(_leaf(tree), *(_leaf(r) for r in rest))
    return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()}


def _tree_leaves(tree) -> List[torch.Tensor]:
    if not hasattr(tree, "items"):
        return [_leaf(tree)]
    return [leaf for _, v in tree.items() for leaf in _tree_leaves(v)]


def prune_by_magnitude(params: Any, target_sparsity: float) -> Any:
    """A 0/1 mask tree (in each tensor's dtype) keeping the
    ``round(size * (1 - target_sparsity))`` largest-|w| entries of each
    prunable tensor, ties at the threshold kept; ones elsewhere."""

    def mask_of(p):
        if not _prunable(p):
            return torch.ones_like(p)
        k = int(round(p.numel() * (1.0 - target_sparsity)))
        if k <= 0:
            return torch.zeros_like(p)
        thresh = torch.sort(p.abs().reshape(-1)).values[-k]
        return (p.abs() >= thresh).to(p.dtype)

    return _tree_map(mask_of, params)


def apply_mask(params: Any, mask: Any) -> Any:
    """``params * mask`` leaf by leaf, as a new nested dict of tensors
    (``convert.from_jax_params`` loads it into a model)."""
    return _tree_map(lambda p, m: p * m, params, mask)


def sparsity(params: Any, prunable_only: bool = True) -> float:
    """Fraction of exactly-zero entries (over prunable tensors by default)."""
    leaves = _tree_leaves(params)
    if prunable_only:
        leaves = [p for p in leaves if _prunable(p)]
    total = sum(p.numel() for p in leaves)
    zeros = sum(int(torch.count_nonzero(p == 0)) for p in leaves)
    return zeros / max(total, 1)


def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to float32 (the product of two float32 is
    exact in float64; the sum rounds there first, which leaves a float32
    midpoint, and so a second rounding apart, about once in 2^29)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _kept_count(size: int, step: int, final_sparsity: float, begin_step: int,
                end_step: int) -> int:
    """How many entries of a ``size``-entry tensor the mask keeps at
    ``step``: ``max(int32(size * (1 - s)), 1)`` with the cubic ramp ``s =
    final * (1 - (1 - t)^3)``, ``t`` the clipped fraction of the
    ``[begin_step, end_step]`` window, in float32 as XLA:CPU compiles the
    JAX package's jitted update: the division by the window's length as a
    product with its float32 reciprocal, ``(1 - t)^3`` as ``u * u`` times
    ``u``, and each product followed by a subtraction contracted into one
    fused multiply-add."""
    f32 = np.float32
    t = f32(step - begin_step) * (f32(1.0) / f32(max(end_step - begin_step, 1)))
    u = f32(1.0) - np.clip(t, f32(0.0), f32(1.0))
    ramp = _fma32(-(u * u), u, f32(1.0))  # 1 - (1 - t)^3
    keep = _fma32(-ramp, f32(final_sparsity), f32(1.0))  # 1 - s
    return max(int(f32(size) * keep), 1)


def _fresh_mask(p: torch.Tensor, k: int) -> torch.Tensor:
    """Keep ``k`` of ``p``'s entries: ``|p| >= sort(|p|)[size - k]``, ties
    kept. The threshold stays on the device: no host sync."""
    absval = p.detach().abs()
    thresh = torch.sort(absval.reshape(-1)).values[absval.numel() - k]
    return absval >= thresh


class _PruningOptimizer(torch.optim.Optimizer):
    """``inner`` followed by the pruning projection: each :meth:`step` runs
    the inner step, counts it, recomputes the masks from the updated
    parameters where the schedule says so, and multiplies every prunable
    parameter by its mask. ``param_groups`` and ``state`` are the inner
    optimizer's. ``masks[i]`` is the bool mask of the i-th parameter (None
    for a parameter that is not pruned), ``prune_step`` the count of steps;
    both live in :meth:`state_dict` beside the inner optimizer's, as the
    JAX ``PruningState`` lives in ``opt_state``.

    Under ``GroupedTrainer.fit_resident`` this optimizer takes the
    ``"forward_backward"`` graph form: the graph replays the forward and
    backward, and this ``step()`` runs after each replay."""

    def __init__(self, inner: torch.optim.Optimizer, final_sparsity: float, begin_step: int,
                 end_step: int, update_every: int):
        super().__init__([p for g in inner.param_groups for p in g["params"]], inner.defaults)
        self.inner = inner
        self.param_groups = inner.param_groups
        self.state = inner.state
        self.final_sparsity, self.begin_step = final_sparsity, begin_step
        self.end_step, self.update_every = end_step, update_every
        self.prune_step = 0
        self.masks: List[Optional[torch.Tensor]] = [
            torch.ones_like(p, dtype=torch.bool) if _prunable(p) else None
            for p in self._params()]

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _recompute(self, step: int) -> bool:
        """The JAX package's cadence: every ``update_every`` steps inside the
        ramp, at its first step and at ``end_step``; frozen after it."""
        cadence = (self.update_every <= 1 or step % self.update_every == 1
                   or step == self.end_step or step == self.begin_step + 1)
        return cadence and self.begin_step < step <= self.end_step

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.inner.step(closure)
        self.prune_step += 1
        params = self._params()
        if self._recompute(self.prune_step):
            self.masks = [None if m is None else _fresh_mask(p, _kept_count(
                p.numel(), self.prune_step, self.final_sparsity, self.begin_step, self.end_step))
                for p, m in zip(params, self.masks)]
        for p, m in zip(params, self.masks):
            if m is not None:
                p.mul_(m)
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.inner.state_dict(),
                "pruning": {"step": self.prune_step, "masks": list(self.masks)}}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        pruning = state_dict["pruning"]
        self.prune_step = int(pruning["step"])
        self.masks = [None if m is None else m.to(device=p.device, dtype=torch.bool)
                      for p, m in zip(self._params(), pruning["masks"])]


def MagnitudePruning(
    inner: Callable,
    final_sparsity: float,
    begin_step: int = 0,
    end_step: int = 1000,
    update_every: int = 100,
) -> Callable:
    """Wrap an optimizer factory (``params -> torch.optim.Optimizer``, the
    form the trainers take) with a gradual magnitude-pruning schedule; the
    result is such a factory.

    Sparsity ramps cubically from 0 to ``final_sparsity`` between
    ``begin_step`` and ``end_step`` (tfmot ``PolynomialDecay`` semantics).
    The mask is recomputed (a full |w| sort per prunable tensor) only every
    ``update_every`` steps, at the ramp's first step and at ``end_step``,
    and HELD FIXED in between and after ``end_step``; every step still
    projects the updated parameters onto the current mask. The arithmetic
    is the JAX package's: the schedule and the kept count in float32, ties
    at the threshold kept. Under ``GroupedTrainer.fit_resident`` the
    optimizer takes the ``"forward_backward"`` graph form: ``opt.step()``,
    the projection with it, runs after each replay."""

    def make(params):
        return _PruningOptimizer(inner(params), final_sparsity, begin_step, end_step,
                                 update_every)

    return make
