"""A train state split over ranks, assembled whole and split again: what a
checkpoint holds under a mesh.

A checkpoint stores the unsplit layout (the parameters' state dict and the
state dict of an optimizer over all of them), so it restores under any mesh
or none. Under tensor parallelism the head kernel and its moments are
reassembled row by row from the model group (one ``all_reduce`` of the rows
placed in zeros); under ZeRO-1 each rank's share of the optimizer state
crosses the data group by ``broadcast``. Without either, these are the
plain state dicts and run no collective.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from .zero import ZeroOneOptimizer

__all__ = ["full_param_state", "full_optimizer_state", "load_param_state",
           "load_optimizer_state", "local_params"]

_HEAD_KEY = "pnet.last.w"


def _row_parallel(model):
    try:
        return getattr(model.pnet.params["last"], "row_parallel", None)
    except (AttributeError, KeyError):
        return None


def _head_index(model) -> Optional[int]:
    for i, (path, _) in enumerate(model.param_items()):
        if path == ("pnet", "last", "w"):
            return i
    return None


def _gather_rows(shard: torch.Tensor, rp) -> torch.Tensor:
    full = torch.zeros((rp.full_rows,) + tuple(shard.shape[1:]), dtype=shard.dtype,
                       device=shard.device)
    full[rp.rows] = shard.detach()
    dist.all_reduce(full, group=rp.group)
    return full


def full_param_state(model) -> Dict[str, torch.Tensor]:
    """The parameters' state dict with a row-parallel head reassembled (a
    collective over the model group then: every rank calls it)."""
    sd = {k: v.detach() for k, v in model.param_tree().state_dict().items()}
    rp = _row_parallel(model)
    if rp is not None:
        sd[_HEAD_KEY] = _gather_rows(sd[_HEAD_KEY], rp)
    return sd


def local_params(model) -> Dict[str, Any]:
    """The model's parameters as a JAX-shaped tree of numpy arrays, a
    row-parallel head reassembled row by row (counterpart of
    ``nif_tpu.training.evaluation.local_params``; collective under tensor
    parallelism)."""
    from ..convert import to_numpy_params

    tree = to_numpy_params(model)
    rp = _row_parallel(model)
    if rp is not None:
        tree["pnet"]["last"]["w"] = _gather_rows(model.pnet.params["last"]["w"],
                                                 rp).cpu().numpy()
    return tree


def load_param_state(model, state: Dict[str, torch.Tensor]) -> None:
    """Load an unsplit parameters' state dict; a row-parallel head takes its
    rows."""
    rp = _row_parallel(model)
    if rp is not None and tuple(state[_HEAD_KEY].shape) != tuple(model.pnet.params["last"]["w"].shape):
        state = dict(state)
        state[_HEAD_KEY] = state[_HEAD_KEY][rp.rows]
    model.param_tree().load_state_dict(state)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def full_optimizer_state(model, optimizer) -> Dict[str, Any]:
    """The state dict of an optimizer over all of ``model.param_items()`` in
    that order: a ZeRO-1 optimizer's shares gathered (every rank of the data
    group broadcasts its own), a row-parallel head's moments reassembled.
    Collective under a mesh: every rank calls it."""
    if isinstance(optimizer, ZeroOneOptimizer):
        state: Dict[int, Any] = {}
        groups: List[Dict[str, Any]] = []
        for j in range(optimizer.n):
            obj = [(optimizer.owned, _to_cpu(optimizer.state_dict()))
                   if j == optimizer.index else None]
            dist.broadcast_object_list(obj, src=optimizer.ranks[j], group=optimizer.group)
            owned, sd = obj[0]
            for local, st in sd["state"].items():
                state[owned[int(local)]] = st
            if not groups and sd["param_groups"]:
                groups = [dict(g) for g in sd["param_groups"]]
        for g in groups[:1]:
            g["params"] = list(range(len(optimizer.params)))
        full = {"state": state, "param_groups": groups[:1]}
    else:
        full = optimizer.state_dict()
    rp = _row_parallel(model)
    h = _head_index(model)
    if rp is not None and h in full["state"]:
        shard = tuple(model.pnet.params["last"]["w"].shape)
        st = dict(full["state"][h])
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and tuple(v.shape) == shard:
                st[k] = _gather_rows(v.to(model.pnet.params["last"]["w"].device), rp)
        full = dict(full, state={**full["state"], h: st})
    return full


def load_optimizer_state(model, optimizer, full: Dict[str, Any]) -> None:
    """Load an unsplit optimizer state dict (:func:`full_optimizer_state`'s
    layout) into ``optimizer``: a row-parallel head's moments take their
    rows, a ZeRO-1 optimizer its share."""
    rp = _row_parallel(model)
    h = _head_index(model)
    if rp is not None and h in full["state"]:
        st = dict(full["state"][h])
        for k, v in st.items():
            if (isinstance(v, torch.Tensor) and v.dim() == 2
                    and v.shape[0] == rp.full_rows):
                st[k] = v[rp.rows]
        full = dict(full, state={**full["state"], h: st})
    if not isinstance(optimizer, ZeroOneOptimizer):
        optimizer.load_state_dict(full)
        return
    if optimizer.inner is None:
        return
    state = {local: full["state"][i] for local, i in enumerate(optimizer.owned)
             if i in full["state"]}
    groups = copy.deepcopy(optimizer.inner.state_dict()["param_groups"])
    for g in groups:
        g.update({k: v for k, v in full["param_groups"][0].items() if k != "params"})
    optimizer.load_state_dict({"state": state, "param_groups": groups})
