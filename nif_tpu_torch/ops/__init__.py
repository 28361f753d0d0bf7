from ._build import LAUNCHES, reset_launches
from .derivatives import (
    jacobian_regularization,
    output_and_jacobian,
    output_and_jacobian_grouped,
    output_jacobian_hessian,
    output_jacobian_hessian_grouped,
    sobolev_loss,
    sobolev_loss_grouped,
)
from .fused_hessian import (
    fwd_hess_supported,
    hessian_fused_supported,
    shapenet_fwd_hess,
    shapenet_hessian_grads,
)
from .fused_linear import (
    linear_fused_supported,
    linear_fused_unsupported_reason,
    niflinear_mse_grads,
    niflinear_mse_grads_reference,
)
from .fused_shapenet import (
    fused_supported,
    fused_unsupported_reason,
    shapenet_grouped_fused,
    shapenet_grouped_fused_reference,
)
from .shapenet import shapenet_grouped, shapenet_pointwise, unpack_shapenet_weights

__all__ = [
    "shapenet_pointwise",
    "shapenet_grouped",
    "unpack_shapenet_weights",
    "output_and_jacobian",
    "output_and_jacobian_grouped",
    "output_jacobian_hessian",
    "output_jacobian_hessian_grouped",
    "jacobian_regularization",
    "sobolev_loss",
    "sobolev_loss_grouped",
    "shapenet_grouped_fused",
    "shapenet_grouped_fused_reference",
    "fused_supported",
    "fused_unsupported_reason",
    "shapenet_fwd_hess",
    "shapenet_hessian_grads",
    "fwd_hess_supported",
    "hessian_fused_supported",
    "niflinear_mse_grads",
    "niflinear_mse_grads_reference",
    "linear_fused_supported",
    "linear_fused_unsupported_reason",
    "LAUNCHES",
    "reset_launches",
]
