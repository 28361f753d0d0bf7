"""ZeRO-1: each parameter's optimizer state on one rank of the data group
(the counterpart of the JAX ``Trainer(shard_opt_state=True)``).

The port's optimizers are factories (``params -> Optimizer``), which
``ZeroRedundancyOptimizer`` (it wants a class) cannot take. So the
parameters are partitioned over the ranks of the mesh's ``data`` axis
(greedily by size, the same split on every rank), each rank builds the
factory's optimizer over its share alone, and after each update every
parameter is broadcast from the rank that owns it. The moments of a rank's
share live on that rank only; the gradients reaching the update are the
data-averaged ones every rank holds, so the parameters stay replicated and
equal an unsharded run's. The JAX package shards each large moment's rows
over the data axis instead; both keep one copy of every moment per data
group.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["ZeroOneOptimizer"]


def _owners(sizes: List[int], n: int) -> List[int]:
    """Greedy balanced partition: the largest parameter first, each to the
    least-loaded rank (ties to the lower rank). Deterministic."""
    load = [0] * n
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n), key=lambda j: (load[j], j))
        owner[i] = r
        load[r] += sizes[i]
    return owner


class ZeroOneOptimizer:
    """An optimizer over ``params`` whose state is split over ``group`` (a
    process group of ``n`` ranks, this one ``index`` among them, whose
    global ranks are ``ranks``): :meth:`step` updates this rank's share with
    ``make_optimizer``'s optimizer, then broadcasts every parameter from
    its owner. ``param_groups`` are the inner optimizer's (an empty list on
    a rank that owns nothing); ``state_dict``/``load_state_dict`` hold this
    rank's share only (``parallel.state`` assembles the whole)."""

    def __init__(self, params: List[torch.nn.Parameter], make_optimizer: Callable, group,
                 index: int, n: int, ranks: List[int]):
        self.params = list(params)
        self.group, self.index, self.n, self.ranks = group, index, n, list(ranks)
        self.owner = _owners([p.numel() for p in self.params], n)
        self.owned = [i for i, o in enumerate(self.owner) if o == index]
        mine = [self.params[i] for i in self.owned]
        self.inner: Optional[torch.optim.Optimizer] = make_optimizer(mine) if mine else None

    @property
    def param_groups(self) -> List[Dict[str, Any]]:
        return [] if self.inner is None else self.inner.param_groups

    def step(self, closure=None):
        if self.inner is not None:
            self.inner.step()
        with torch.no_grad():
            for p, o in zip(self.params, self.owner):
                dist.broadcast(p.data, src=self.ranks[o], group=self.group)

    def state_dict(self) -> Dict[str, Any]:
        if self.inner is None:
            return {"state": {}, "param_groups": []}
        return self.inner.state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        if self.inner is not None:
            self.inner.load_state_dict(state_dict)
