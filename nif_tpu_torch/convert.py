"""Move parameters between the JAX package and the port.

``jax.random`` streams cannot be reproduced in torch, so the two packages
are compared by handing the same parameters to both. A ``nif_tpu`` params
pytree (``{"pnet": {"first": {"w", "b"}, "hidden_0": ..., ...}}``, plus the
trunk under ``"snet"`` for NIF-linear) crosses as nested dicts of numpy
arrays, e.g.
``jax.tree_util.tree_map(np.asarray, params)``. Both packages keep dense
weights as ``[fan_in, fan_out]`` (``y = x @ w``), so no transpose is needed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

__all__ = ["from_jax_params", "to_numpy_params"]


def _load(module: nn.Module, tree: Dict[str, Any], path: str) -> None:
    names = set(module.keys())
    if set(tree) != names:
        raise KeyError(f"params at {path or '<root>'} have keys {sorted(tree)}, "
                       f"the model has {sorted(names)}")
    for k, v in tree.items():
        target, where = module[k], f"{path}/{k}" if path else k
        if isinstance(target, nn.Parameter):
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if tuple(v.shape) != tuple(target.shape):
                raise ValueError(f"{where}: shape {v.shape} != {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.array(v)))
        else:
            _load(target, v, where)


def from_jax_params(model, params: Dict[str, Any]):
    """Load a ``nif_tpu`` params tree (nested dicts of arrays or tensors,
    with the model's own top-level keys) into ``model`` in place, casting to the
    model's param dtype and device. Returns the model. Raises on a missing or
    extra key or a shape mismatch."""
    _load(model.param_tree(), params, "")
    return model


def _dump(module: nn.Module) -> Dict[str, Any]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, nn.Parameter) else _dump(v))
            for k, v in module.items()}


def to_numpy_params(model) -> Dict[str, Any]:
    """The model's parameters as a ``nif_tpu``-shaped tree of numpy arrays."""
    return _dump(model.param_tree())
