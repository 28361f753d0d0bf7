from ._build import LAUNCHES, reset_launches
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
    "shapenet_grouped_fused",
    "shapenet_grouped_fused_reference",
    "fused_supported",
    "fused_unsupported_reason",
    "LAUNCHES",
    "reset_launches",
]
