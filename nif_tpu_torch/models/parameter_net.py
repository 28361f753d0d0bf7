"""ParameterNet: the hypernetwork trunk mapping (t, mu) -> latent -> ShapeNet
weight vector (counterpart of ``nif_tpu/models/parameter_net.py``).

Three kinds:

* ``vanilla``   — Dense(act) -> l_st x SimpleShortCut -> Dense(latent, linear)
                  -> Dense(po_dim, linear), all TruncatedNormal(0.1) init.
* ``siren``     — SIREN(first) -> l_st x (SIREN_ResNet | SIREN hidden) ->
                  SIREN bottleneck (linear) -> HyperLinearForSIREN.
* ``mlp_hyper`` — Dense(act) -> l_st x (MLP_ResNet | SimpleShortCut) ->
                  Dense(latent, linear) -> HyperLinearForSIREN.

The functions take a params mapping with the JAX package's keys
(``first``, ``hidden_{i}``, ``bottleneck``, ``last``); :class:`ParameterNet`
holds the same tree as an ``nn.Module``, so a JAX params pytree loads
into it key for key (see :mod:`nif_tpu_torch.convert`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..config import ParameterNetConfig, ShapeNetConfig
from ..layers.mlp import (
    dense_apply,
    dense_init,
    mlp_resnet_apply,
    mlp_resnet_init,
    mlp_shortcut_apply,
    mlp_shortcut_init,
)
from ..layers.siren import (
    hyper_linear_apply,
    hyper_linear_init_params,
    siren_apply,
    siren_init,
    siren_resnet_apply,
    siren_resnet_init,
)

__all__ = [
    "ParameterNet",
    "parameter_net_kind",
    "parameter_net_init",
    "parameter_net_apply",
    "parameter_net_latent",
    "parameter_net_head",
    "parameter_sum",
]


def parameter_net_kind(cfg_p: ParameterNetConfig, vanilla: bool) -> str:
    if vanilla:
        return "vanilla"
    return "siren" if cfg_p.activation == "sine" else "mlp_hyper"


def parameter_net_init(
    generator: torch.Generator,
    cfg_p: ParameterNetConfig,
    cfg_s: ShapeNetConfig,
    po_dim: int,
    kind: str,
    dtype=torch.float32,
    device=None,
) -> Dict[str, Any]:
    """The params tree of one ParameterNet, drawn from ``generator``."""
    g, n = generator, cfg_p.units
    params: Dict[str, Any] = {}
    if kind == "vanilla":
        params["first"] = dense_init(g, cfg_p.input_dim, n, dtype=dtype, device=device)
        for i in range(cfg_p.nlayers):
            params[f"hidden_{i}"] = mlp_shortcut_init(g, n, dtype, device)
        params["bottleneck"] = dense_init(g, n, cfg_p.latent_dim, dtype=dtype, device=device)
        params["last"] = dense_init(g, cfg_p.latent_dim, po_dim, dtype=dtype, device=device)
        return params

    if kind == "siren":
        params["first"] = siren_init(g, cfg_p.input_dim, n, "first", cfg_p.omega_0,
                                     dtype, device)
        for i in range(cfg_p.nlayers):
            if cfg_p.use_resblock:
                params[f"hidden_{i}"] = siren_resnet_init(g, n, cfg_p.omega_0, dtype, device)
            else:
                params[f"hidden_{i}"] = siren_init(g, n, n, "hidden", cfg_p.omega_0,
                                                   dtype, device)
        params["bottleneck"] = siren_init(g, n, cfg_p.latent_dim, "bottleneck",
                                          cfg_p.omega_0, dtype, device)
        params["last"] = hyper_linear_init_params(g, cfg_p.latent_dim, po_dim, cfg_s,
                                                  dtype, device)
        return params

    if kind == "mlp_hyper":
        params["first"] = dense_init(g, cfg_p.input_dim, n, dtype=dtype, device=device)
        for i in range(cfg_p.nlayers):
            if cfg_p.use_resblock:
                params[f"hidden_{i}"] = mlp_resnet_init(g, n, dtype, device)
            else:
                params[f"hidden_{i}"] = mlp_shortcut_init(g, n, dtype, device)
        params["bottleneck"] = dense_init(g, n, cfg_p.latent_dim, dtype=dtype, device=device)
        params["last"] = hyper_linear_init_params(g, cfg_p.latent_dim, po_dim, cfg_s,
                                                  dtype, device)
        return params

    raise ValueError(f"unknown parameter net kind {kind!r}")


def parameter_net_latent(params, t: torch.Tensor, cfg_p: ParameterNetConfig, kind: str):
    """Trunk up to and including the bottleneck: (t, mu) -> latent."""
    h = t
    if kind == "vanilla":
        h = dense_apply(params["first"], h, cfg_p.activation)
        for i in range(cfg_p.nlayers):
            h = mlp_shortcut_apply(params[f"hidden_{i}"], h, cfg_p.activation)
        return dense_apply(params["bottleneck"], h)
    if kind == "siren":
        h = siren_apply(params["first"], h, cfg_p.omega_0, "first")
        for i in range(cfg_p.nlayers):
            if cfg_p.use_resblock:
                h = siren_resnet_apply(params[f"hidden_{i}"], h, cfg_p.omega_0)
            else:
                h = siren_apply(params[f"hidden_{i}"], h, cfg_p.omega_0, "hidden")
        return siren_apply(params["bottleneck"], h, cfg_p.omega_0, "bottleneck")
    if kind == "mlp_hyper":
        h = dense_apply(params["first"], h, cfg_p.activation)
        for i in range(cfg_p.nlayers):
            if cfg_p.use_resblock:
                h = mlp_resnet_apply(params[f"hidden_{i}"], h, cfg_p.activation)
            else:
                h = mlp_shortcut_apply(params[f"hidden_{i}"], h, cfg_p.activation)
        return dense_apply(params["bottleneck"], h)
    raise ValueError(f"unknown parameter net kind {kind!r}")


def parameter_net_head(params, latent: torch.Tensor, kind: str):
    """Final layer: latent -> flattened ShapeNet weight vector. A head split
    row-parallel over a model group (``parallel.put_params_model_parallel``)
    carries its ``row_parallel`` computation on the ``last`` module."""
    row_parallel = getattr(params["last"], "row_parallel", None)
    if row_parallel is not None:
        return row_parallel(latent, params["last"])
    if kind == "vanilla":
        return dense_apply(params["last"], latent)
    return hyper_linear_apply(params["last"], latent)


def parameter_net_apply(
    params, t: torch.Tensor, cfg_p: ParameterNetConfig, kind: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full ParameterNet: returns (weight_vector, latent)."""
    latent = parameter_net_latent(params, t, cfg_p, kind)
    return parameter_net_head(params, latent, kind), latent


def parameter_sum(params: nn.Module, fn) -> torch.Tensor:
    """``sum(fn(p))`` over the ParameterNet's parameters (an L1/L2 term),
    a row-parallel head's term summed over its model group."""
    row_parallel = getattr(params["last"], "row_parallel", None)
    head = params["last"]["w"] if row_parallel is not None else None
    total = sum(fn(p) for p in params.parameters() if p is not head)
    if head is not None:
        total = total + row_parallel.reduce(fn(head))
    return total


def _as_module(tree) -> nn.Module:
    """Nested dict of tensors -> ModuleDict tree with ParameterDict leaves."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


class ParameterNet(nn.Module):
    """The ParameterNet as a module: ``forward(t) -> (wb, latent)``.

    ``params`` holds the tree of :func:`parameter_net_init` (with the JAX
    package's keys), so ``self.params["hidden_0"]["dense"]["w"]`` is the
    counterpart of ``params["pnet"]["hidden_0"]["dense"]["w"]``.
    """

    def __init__(self, cfg_p: ParameterNetConfig, cfg_s: ShapeNetConfig,
                 po_dim: int, kind: str, generator: torch.Generator,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg_p, self.kind = cfg_p, kind
        self.params = _as_module(
            parameter_net_init(generator, cfg_p, cfg_s, po_dim, kind, dtype, device)
        )

    def latent(self, t):
        return parameter_net_latent(self.params, t, self.cfg_p, self.kind)

    def head(self, latent):
        return parameter_net_head(self.params, latent, self.kind)

    def forward(self, t):
        return parameter_net_apply(self.params, t, self.cfg_p, self.kind)
