"""Functional SIREN blocks (counterpart of ``nif_tpu/layers/siren.py``).

* siren         — sine-activated dense with position-dependent init. The
                  'bottleneck' position is LINEAR in the forward pass.
* siren_resnet  — ``0.5 * (x + sin(w0 * h @ W2 + b2))`` with
                  ``h = sin(w0 * x @ W + b)``.
* hyper_linear  — the hypernetwork head: a linear layer emitting the full
                  ShapeNet weight vector, with SIREN-aware scaled init.
"""
from __future__ import annotations

import torch

from ..config import ShapeNetConfig, shapenet_segment_sizes
from .initializers import hyper_linear_init, siren_first_init, siren_hidden_init

__all__ = [
    "omega_in",
    "siren_init",
    "siren_apply",
    "siren_resnet_init",
    "siren_resnet_apply",
    "hyper_linear_init_params",
    "hyper_linear_apply",
]


def siren_init(generator, fan_in, fan_out, layer_position, omega_0,
               dtype=torch.float32, device=None):
    if layer_position == "first":
        w, b = siren_first_init(generator, fan_in, fan_out, dtype, device)
    elif layer_position in ("hidden", "bottleneck"):
        w, b = siren_hidden_init(generator, fan_in, fan_out, omega_0, dtype, device)
    else:
        raise ValueError(f"unsupported SIREN layer_position {layer_position!r}")
    return {"w": w, "b": b}


def omega_in(dtype: torch.dtype, omega_0: float) -> float:
    """omega_0 rounded to ``dtype``, as a Python float. Multiplying a tensor
    of that dtype by it rounds like JAX's ``jnp.asarray(omega_0, dtype) * a``
    and needs no scalar on the device."""
    return torch.tensor(omega_0, dtype=dtype).item()


def siren_apply(params, x, omega_0, layer_position):
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)
    if layer_position == "bottleneck":
        return x @ w + b
    return torch.sin(omega_in(x.dtype, omega_0) * (x @ w) + b)


def siren_resnet_init(generator, width, omega_0, dtype=torch.float32, device=None):
    # The second matmul's init is tied to the first: every resblock starts
    # with w2 == w and b2 == b exactly (the reference builds both from the
    # same init tensors). They are separate parameters from then on.
    p1 = siren_init(generator, width, width, "hidden", omega_0, dtype, device)
    return {"w": p1["w"], "b": p1["b"], "w2": p1["w"].clone(), "b2": p1["b"].clone()}


def siren_resnet_apply(params, x, omega_0):
    om = omega_in(x.dtype, omega_0)
    h = torch.sin(om * (x @ params["w"].to(x.dtype)) + params["b"].to(x.dtype))
    y = torch.sin(om * (h @ params["w2"].to(x.dtype)) + params["b2"].to(x.dtype))
    return 0.5 * (x + y)


def hyper_linear_init_params(generator, fan_in: int, fan_out: int,
                             cfg_shape: ShapeNetConfig, dtype=torch.float32,
                             device=None):
    """Init the hypernetwork head for a given ShapeNet config.

    For connectivity='last_layer' the whole output is treated as the
    last-layer weight segment.
    """
    if cfg_shape.connectivity == "full":
        nw_first, nw_hidden, nw_last, _ = shapenet_segment_sizes(cfg_shape)
    elif cfg_shape.connectivity == "last_layer":
        nw_first, nw_hidden, nw_last = 0, 0, fan_out
    else:
        raise ValueError(f"bad connectivity {cfg_shape.connectivity!r}")
    w, b = hyper_linear_init(
        generator,
        fan_in,
        fan_out,
        weight_factor=cfg_shape.weight_init_factor,
        num_weight_first=nw_first,
        num_weight_hidden=nw_hidden,
        num_weight_last=nw_last,
        input_dim=cfg_shape.input_dim,
        width=cfg_shape.units,
        omega_0=cfg_shape.omega_0,
        dtype=dtype,
        device=device,
    )
    return {"w": w, "b": b}


def hyper_linear_apply(params, x):
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
