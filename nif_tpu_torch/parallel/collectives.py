"""The collectives the port's parallelism runs on: ``all_reduce`` and
``broadcast`` only.

They are the two collectives gloo runs on CUDA tensors as well as on the
CPU, so the same code runs on NCCL (CUDA ranks), on gloo (the CPU tests) and
on gloo over CUDA tensors (two ranks sharing one card, which NCCL refuses).
A barrier is an ``all_reduce`` of one element.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "average_over", "barrier", "collective_device", "copy_to_group",
           "is_primary", "reduce_from_group", "sum_over"]

#: ``all_reduce`` calls of :func:`sum_over`, and of those the ones issued
#: while a CUDA graph was being captured (they then run at each replay).
COUNTS = {"all_reduce": 0, "captured": 0}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def collective_device(device: Optional[torch.device] = None) -> torch.device:
    """Where a host value crosses a collective: the rank's card under NCCL
    (which takes only CUDA tensors), the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device()) if device is None else device
    return torch.device("cpu")


def is_primary() -> bool:
    """True on the rank that writes shared files: rank 0, or the only
    process when no process group is initialized."""
    return not _initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits here for the others (one ``all_reduce`` of one
    element); a no-op without a process group."""
    if _initialized():
        dist.all_reduce(torch.zeros(1, device=collective_device()))


def sum_over(tensor: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``tensor`` summed in place over each process group of ``groups`` in
    turn (the groups of the mesh axes, whose ranks differ in that axis
    alone, so the turns sum over their product)."""
    for g in groups:
        dist.all_reduce(tensor, group=g)
        COUNTS["all_reduce"] += 1
        if tensor.is_cuda and torch.cuda.is_current_stream_capturing():
            COUNTS["captured"] += 1
    return tensor


def average_over(tensors: Iterable[torch.Tensor], groups: Sequence, n: int) -> List[torch.Tensor]:
    """The element-wise mean of ``tensors`` over the ranks of ``groups``
    (``n`` of them), as JAX's ``pmean``: the tensors of each dtype go into
    one flat bucket, one ``all_reduce`` a bucket and axis, then a division
    by ``n``. Returns new tensors shaped as the inputs (views of the
    buckets); no host sync, so a CUDA graph can capture it under NCCL."""
    tensors = list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        bucket = torch.cat([tensors[i].reshape(-1) for i in idx])
        sum_over(bucket, groups)
        bucket.div_(n)
        offset = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = bucket[offset: offset + k].view(tensors[i].shape)
            offset += k
    return out


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over a group in the forward, identity in the backward: the output
    of a row-parallel product, whose cotangent every rank of the group
    already holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """Identity in the forward, sum over a group in the backward: the input
    of a row-parallel product, each rank of the group holding the cotangent
    of its own rows only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)
