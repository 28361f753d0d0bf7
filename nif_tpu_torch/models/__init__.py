from .linear import NIFMultiScaleLastLayerParameterized
from .nif import NIF, NIFMultiScale
from .parameter_net import (
    ParameterNet,
    parameter_net_apply,
    parameter_net_init,
    parameter_net_latent,
)

__all__ = [
    "NIF",
    "NIFMultiScale",
    "NIFMultiScaleLastLayerParameterized",
    "ParameterNet",
    "parameter_net_init",
    "parameter_net_apply",
    "parameter_net_latent",
]
