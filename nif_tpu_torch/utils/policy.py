"""Mixed-precision policy (counterpart of ``nif_tpu/utils/policy.py``).

Parameters stay float32 (or float64); compute runs in the policy's compute
dtype. 'mixed_float16' is accepted for reference-config compatibility and
maps to bf16 compute, exactly as the JAX package maps it, so one config
file computes the same function in both packages.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Policy", "get_policy"]


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    # Move first, then cast: a host array reaches the device as it is and
    # the cast runs there.
    def cast_to_compute(self, x, device=None) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.compute_dtype)

    def cast_to_param(self, x, device=None) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.param_dtype)


_POLICIES = {
    "float32": (torch.float32, torch.float32),
    "float64": (torch.float64, torch.float64),
    "mixed_bfloat16": (torch.float32, torch.bfloat16),
    "mixed_float16": (torch.float32, torch.bfloat16),
}


def get_policy(name) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        param, compute = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown mixed_policy {name!r}; expected one of {sorted(_POLICIES)}"
        ) from None
    return Policy(name=name, param_dtype=param, compute_dtype=compute)
