"""Evaluation metrics (counterpart of ``nif_tpu/utils/metrics.py``).

``rel_l2`` is the accuracy metric of NIF workflows: the relative L2 norm of
the reconstruction error over the whole field.
"""
from __future__ import annotations

import torch

__all__ = ["rel_l2", "mse", "rmse"]


def rel_l2(pred, target, dim=None) -> torch.Tensor:
    """||pred - target||_2 / ||target||_2 (over everything by default).

    Computed in (at least) float32 regardless of input dtypes: the accuracy
    bar (rel-L2 < 1e-3) sits below bf16 resolution, so downcasting the
    target to a bf16 pred's dtype would measure quantization, not error.
    """
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target, device=pred.device)
    dt = torch.promote_types(
        torch.promote_types(pred.dtype, target.dtype), torch.float32
    )
    pred, target = pred.to(dt), target.to(dt)
    num = torch.sqrt(torch.sum(torch.square(pred - target), dim=dim))
    den = torch.sqrt(torch.sum(torch.square(target), dim=dim))
    return num / torch.clamp(den, min=torch.finfo(dt).tiny)


def mse(pred, target) -> torch.Tensor:
    pred = torch.as_tensor(pred)
    return torch.mean(torch.square(pred - torch.as_tensor(target, device=pred.device)))


def rmse(pred, target) -> torch.Tensor:
    return torch.sqrt(mse(pred, target))
