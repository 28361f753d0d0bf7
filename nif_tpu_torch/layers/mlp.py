"""Functional MLP building blocks (counterpart of ``nif_tpu/layers/mlp.py``).

* dense         — ``x @ w + b`` with an optional activation
* mlp_shortcut  — ``x + dense_act(x)``
* mlp_resnet    — ``act(x + dense2(dense1_act(x)))``

Params are mappings of tensors (a dict, or an ``nn.ParameterDict``) in the
JAX package's layout: ``w`` is ``[fan_in, fan_out]``, so ``y = x @ w``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .initializers import truncated_normal_init

__all__ = [
    "get_activation",
    "dense_init",
    "dense_apply",
    "mlp_shortcut_init",
    "mlp_shortcut_apply",
    "mlp_resnet_init",
    "mlp_resnet_apply",
]

_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "swish": F.silu,
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "softplus": F.softplus,
    "sine": torch.sin,
}


def get_activation(name) -> Callable:
    if callable(name):
        return name
    if name is None:
        return _ACTIVATIONS["linear"]
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; expected one of {sorted(_ACTIVATIONS)}"
        ) from None


def dense_init(generator, fan_in: int, fan_out: int, stddev: float = 0.1,
               dtype=torch.float32, device=None):
    return {
        "w": truncated_normal_init(generator, (fan_in, fan_out), stddev, dtype, device),
        "b": truncated_normal_init(generator, (fan_out,), stddev, dtype, device),
    }


def dense_apply(params, x, activation=None):
    y = x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
    return get_activation(activation)(y) if activation is not None else y


def mlp_shortcut_init(generator, width: int, dtype=torch.float32, device=None):
    return {"dense": dense_init(generator, width, width, dtype=dtype, device=device)}


def mlp_shortcut_apply(params, x, activation):
    return x + dense_apply(params["dense"], x, activation)


def mlp_resnet_init(generator, width: int, dtype=torch.float32, device=None):
    return {
        "dense1": dense_init(generator, width, width, dtype=dtype, device=device),
        "dense2": dense_init(generator, width, width, dtype=dtype, device=device),
    }


def mlp_resnet_apply(params, x, activation):
    h = dense_apply(params["dense1"], x, activation)
    h = dense_apply(params["dense2"], h)
    return get_activation(activation)(x + h)
