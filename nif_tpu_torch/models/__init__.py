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
    "ParameterNet",
    "parameter_net_init",
    "parameter_net_apply",
    "parameter_net_latent",
]
