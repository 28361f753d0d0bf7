"""Typed configuration for NIF models.

Mirrors the reference's plain-dict "flag system" key-for-key
(reference: nif/model.py:73-128, cfg key usage at nif/model.py:84-99,
:569-587, :1028-1029) so that ``save_config``/``load_config`` JSON files are
interchangeable with the reference's ``NIF.save_config`` output
(nif/model.py:466-480).

The closed-form ShapeNet parameter-count formulas (``po_dim``) replicate
reference nif/model.py:169-173 (full, no resblock), :572-576 (full,
resblock) and :583-585 (last_layer) exactly — the hypernetwork output
vector is sliced by these counts, so they are load-bearing.

This module is a copy of ``nif_tpu/config.py``, which uses no JAX itself:
importing it from ``nif_tpu`` would run ``nif_tpu/__init__.py`` and load
JAX. A test holds the two copies equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "ShapeNetConfig",
    "ParameterNetConfig",
    "NIFConfig",
    "shapenet_param_count",
    "shapenet_segment_sizes",
]


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class ShapeNetConfig:
    """Configuration of the ShapeNet (the spatial, per-point network).

    Field names match the reference ``cfg_shape_net`` dict keys exactly.
    """

    input_dim: int
    output_dim: int
    units: int
    nlayers: int
    activation: str = "swish"
    # Multi-scale (SIREN) options — reference nif/model.py:569-587
    use_resblock: bool = False
    omega_0: float = 30.0
    connectivity: str = "full"  # 'full' | 'last_layer'
    weight_init_factor: float = 0.01
    # Optional regularization — reference nif/model.py:1028-1029
    l1_reg: Optional[float] = None
    l2_reg: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # Keep JSON clean: drop unset optionals, like the reference's dicts.
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShapeNetConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass(frozen=True)
class ParameterNetConfig:
    """Configuration of the ParameterNet (the hypernetwork over (t, mu)).

    Field names match the reference ``cfg_parameter_net`` dict keys exactly
    (reference nif/model.py:88-99).
    """

    input_dim: int
    latent_dim: int
    units: int
    nlayers: int
    activation: str = "swish"
    use_resblock: bool = False
    omega_0: float = 30.0
    # Optional regularization
    jac_reg: Optional[float] = None
    l1_reg: Optional[float] = None
    l2_reg: Optional[float] = None
    act_l1_reg: Optional[float] = None
    act_l2_reg: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParameterNetConfig":
        return cls(**_filter_kwargs(cls, d))


def shapenet_param_count(cfg: ShapeNetConfig, latent_dim: int) -> int:
    """Total number of ShapeNet weights+biases emitted by the ParameterNet.

    Replicates reference nif/model.py:169-173, :572-585.
    """
    si, so, n, l = cfg.input_dim, cfg.output_dim, cfg.units, cfg.nlayers
    if cfg.connectivity == "last_layer":
        return latent_dim
    if cfg.connectivity != "full":
        raise ValueError(
            f"connectivity must be 'full' or 'last_layer', got {cfg.connectivity!r}"
        )
    if cfg.use_resblock:
        return (2 * l) * n**2 + (si + so + 1 + 2 * l) * n + so
    return l * n**2 + (si + so + 1 + l) * n + so


def shapenet_segment_sizes(cfg: ShapeNetConfig) -> Tuple[int, int, int, int]:
    """(num_weight_first, num_weight_hidden, num_weight_last, num_bias).

    Segment sizes of the flattened ShapeNet weight vector, in the reference's
    slicing order [W_first | W_hidden... | W_last | b_first | b_hidden... |
    b_last] (reference nif/model.py:253-300, :769-846; helper at
    nif/layers/siren.py:66-97).
    """
    si, so, n, l = cfg.input_dim, cfg.output_dim, cfg.units, cfg.nlayers
    if cfg.connectivity == "last_layer":
        return 0, 0, 0, 0
    n_hidden_mats = 2 * l if cfg.use_resblock else l
    num_weight_first = si * n
    num_weight_hidden = n_hidden_mats * n**2
    num_weight_last = so * n
    num_bias = (n_hidden_mats + 1) * n + so
    return num_weight_first, num_weight_hidden, num_weight_last, num_bias


@dataclasses.dataclass(frozen=True)
class NIFConfig:
    """Full model configuration: the two sub-network configs plus precision.

    ``mixed_policy`` accepts the reference's strings ('float32',
    'mixed_float16') plus the TPU-native 'mixed_bfloat16'.
    JSON schema matches reference ``NIF.save_config`` (nif/model.py:466-480):
    ``{"cfg_shape_net": {...}, "cfg_parameter_net": {...}, "mixed_policy": s}``.
    """

    shape_net: ShapeNetConfig
    parameter_net: ParameterNetConfig
    mixed_policy: str = "float32"

    @property
    def po_dim(self) -> int:
        return shapenet_param_count(self.shape_net, self.parameter_net.latent_dim)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "cfg_shape_net": self.shape_net.to_dict(),
            "cfg_parameter_net": self.parameter_net.to_dict(),
            "mixed_policy": self.mixed_policy,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NIFConfig":
        return cls(
            shape_net=ShapeNetConfig.from_dict(d["cfg_shape_net"]),
            parameter_net=ParameterNetConfig.from_dict(d["cfg_parameter_net"]),
            mixed_policy=d.get("mixed_policy", "float32"),
        )

    def save(self, filename: str = "config.json") -> None:
        parent = os.path.dirname(os.path.abspath(filename))
        os.makedirs(parent, exist_ok=True)
        with open(filename, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def load(cls, filename: str) -> "NIFConfig":
        with open(filename, "r") as f:
            return cls.from_dict(json.load(f))
