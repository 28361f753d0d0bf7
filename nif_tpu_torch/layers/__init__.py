from .initializers import (
    hyper_bias_scales,
    hyper_linear_init,
    siren_first_init,
    siren_hidden_init,
    truncated_normal_init,
)
from .mlp import (
    dense_apply,
    dense_init,
    get_activation,
    mlp_resnet_apply,
    mlp_resnet_init,
    mlp_shortcut_apply,
    mlp_shortcut_init,
)
from .siren import (
    hyper_linear_apply,
    hyper_linear_init_params,
    siren_apply,
    siren_init,
    siren_resnet_apply,
    siren_resnet_init,
)

__all__ = [
    "truncated_normal_init",
    "siren_first_init",
    "siren_hidden_init",
    "hyper_linear_init",
    "hyper_bias_scales",
    "get_activation",
    "dense_init",
    "dense_apply",
    "mlp_shortcut_init",
    "mlp_shortcut_apply",
    "mlp_resnet_init",
    "mlp_resnet_apply",
    "siren_init",
    "siren_apply",
    "siren_resnet_init",
    "siren_resnet_apply",
    "hyper_linear_init_params",
    "hyper_linear_apply",
]
