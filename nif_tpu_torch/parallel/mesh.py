"""Device-mesh data and tensor parallelism on ``torch.distributed``
(counterpart of ``nif_tpu/parallel/mesh.py``).

**The model of execution differs from the JAX package's.** JAX runs one
controller over many devices: in a single process ``put_batch`` takes the
*global* batch and shards it over the mesh, across processes it takes each
process's *local* shard. The port runs one process (a *rank*) per device.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
with the JAX package's axis names (``("data",)``, ``("data", "model")``, a
leading ``"replica"`` axis across nodes), and every rank runs the same
program on its own block of the batch. Which block a rank's arrays are is
said when the mesh is made, never guessed from the world size:

1. ``local_batches=False`` (the default): every rank holds the same global
   batch (same file, same seed) and keeps its contiguous block of dim 0,
   the block ``P('data')`` gives a device in JAX. The CLI and the
   trainers use this, so an N-rank run sees the global batches of a
   one-process run.
2. ``local_batches=True``: each rank brings its own block (its stripe of
   a dataset, ``GroupedDataset.open(path, host_id, num_hosts)``) and keeps
   it as it is. The multi-host worker uses this.

A tensor :func:`put_batch` made is marked as placed on its mesh, and
placing it again returns it as it is (JAX's ``device_put`` of an array
already on its sharding): ``prefetch_to_device(mesh=...)`` stages a
rank's block ahead, and the trainer's step takes it without a second cut.

Parameters are replicated: every rank holds all of them, and a same-seed
init is checked equal across ranks by :func:`put_replicated` (one
``all_reduce`` of a checksum: torch cannot trust "same seed, same values"
across backends). With a ``model`` axis the hypernetwork head
``pnet.last.w`` ``[latent, po_dim]`` splits its contracting rows over the
model group instead (:func:`put_params_model_parallel`,
:class:`RowParallelHead`); its optimizer moments follow it because the
parameter is the shard. The trainers average the gradients over
:func:`batch_axes` as one flat bucket, which equals JAX's ``pmean``.
Only ``all_reduce`` and ``broadcast`` run (``parallel/collectives.py``), so
two ranks can share one card over gloo.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import collective_device, copy_to_group, reduce_from_group

__all__ = [
    "Mesh",
    "Sharding",
    "RowParallelHead",
    "make_mesh",
    "make_hybrid_mesh",
    "batch_sharding",
    "batch_axis_size",
    "batch_axes",
    "batch_block",
    "eval_block",
    "host_block",
    "mark_placed",
    "replicated_sharding",
    "model_axis_specs",
    "put_params_model_parallel",
    "shard_batch",
    "pad_to_multiple",
    "init_distributed",
    "rank_device",
    "put_batch",
    "put_batch_tuple",
    "put_global",
    "put_replicated",
]

_RANK_DEVICE: Optional[torch.device] = None


def _device_of_rank(device, local_device_ids) -> torch.device:
    """The rank's device: ``device`` as given, a bare ``"cuda"`` made
    ``cuda:<local id>`` (``local_device_ids[0]``, else torchrun's
    ``LOCAL_RANK``, else 0)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", int(local))
    return dev


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
    device=None,
    timeout: float = 300.0,
) -> int:
    """Join this process to the ranks' process group; returns its rank.

    ``coordinator_address`` (``host:port``), ``num_processes`` (the world
    size, one rank a device) and ``process_id`` (the rank) default to
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``; without them the world is one process (an in-memory store,
    no port). ``device`` is the rank's device, CUDA unless the caller
    names another (a bare ``"cuda"`` takes ``local_device_ids[0]`` or
    ``LOCAL_RANK``). The backend is explicit: NCCL for a CUDA rank, gloo
    for a CPU rank, and gloo on CUDA tensors only when ``backend="gloo"``
    is asked for (two ranks on one card). ``timeout`` (seconds) bounds the
    rendezvous and every collective, so a rank that dies fails the others
    instead of hanging them. Idempotent: a second call returns the rank."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None else int(num_processes)
    rank = int(env.get("RANK", 0)) if process_id is None else int(process_id)
    dev = _device_of_rank(device, local_device_ids)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {str(dev)!r}")
    kw = {"backend": backend, "rank": rank, "world_size": world,
          "timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        kw["device_id"] = dev
    if coordinator_address is None:
        if world != 1:
            raise ValueError(f"a world of {world} processes needs a coordinator_address")
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        dist.init_process_group(init_method=f"tcp://{coordinator_address}", **kw)
    _RANK_DEVICE = dev
    return dist.get_rank()


def rank_device() -> torch.device:
    """This rank's device, as :func:`init_distributed` set it."""
    if _RANK_DEVICE is None:
        raise RuntimeError("no process group: call nif_tpu_torch.parallel.init_distributed first")
    return _RANK_DEVICE


class Mesh:
    """A ``DeviceMesh`` over the ranks with the batch convention of the
    module docstring. ``axis_names``, ``shape`` (``{axis: size}``) and
    ``size`` read as the JAX ``Mesh``'s; ``device`` is this rank's device,
    ``backend`` the process group's, ``group(axis)`` the process group of
    the ranks that differ from this one in ``axis`` alone and
    ``coordinate(axis)`` this rank's index along it."""

    def __init__(self, device_mesh, local_batches: bool = False):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes))
        self.local_batches = bool(local_batches)
        self.device = rank_device()
        self.backend = dist.get_backend()

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self) -> str:
        batches = "local" if self.local_batches else "global"
        return (f"Mesh({self.shape}, {self.backend} on {self.device}, "
                f"{batches} batches)")


def _device_mesh(shape: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} must hold the world's {world} ranks "
                         "(the port runs one rank a device)")
    return init_device_mesh(rank_device().type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    mesh_shape: Optional[Sequence[int]] = None,
    local_batches: bool = False,
) -> Mesh:
    """A mesh over every rank of the process group (one rank a device).

    Default: 1-D, named ``'data'``. Pass ``axis_names=('data', 'model')``
    and a ``mesh_shape`` for tensor parallelism of large hypernetwork
    heads. ``n_devices``, when given, must be the world size.
    ``local_batches`` picks the batch convention (module docstring)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call nif_tpu_torch.parallel.init_distributed first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: a mesh spans every rank ({n})")
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    return Mesh(_device_mesh(mesh_shape, axis_names), local_batches)


def make_hybrid_mesh(
    ici_axes: Sequence[str] = ("data",),
    ici_shape: Optional[Sequence[int]] = None,
    dcn_axis: str = "replica",
    num_slices: Optional[int] = None,
    local_batches: bool = False,
) -> Mesh:
    """A mesh with a leading ``dcn_axis`` across nodes and ``ici_axes``
    within each: shardings on the inner axes keep their collectives inside
    a node. ``num_slices`` defaults to the node count (torchrun's
    ``WORLD_SIZE // LOCAL_WORLD_SIZE``; one node without it), and one node
    gives a degenerate ``replica`` axis of size 1, so specs stay portable.
    Ranks are node-major, as torchrun numbers them."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call nif_tpu_torch.parallel.init_distributed first")
    world = dist.get_world_size()
    if num_slices is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_slices = max(1, world // max(per_node, 1))
    per_slice = world // num_slices
    if ici_shape is None:
        ici_shape = (per_slice,) + (1,) * (len(ici_axes) - 1)
    shape = (num_slices,) + tuple(ici_shape)
    return Mesh(_device_mesh(shape, (dcn_axis,) + tuple(ici_axes)), local_batches)


def batch_axes(mesh: Mesh) -> tuple:
    """The mesh axes a [B, ...] batch splits over: every axis named
    'replica' or 'data' that is present, else the first axis.

    The ONE source of truth: the batch blocks, the divisibility checks and
    the trainers' gradient averages all use this axis set, or a batch could
    split over an axis its gradients are never averaged over."""
    axes = tuple(a for a in mesh.axis_names if a in ("replica", "data"))
    return axes if axes else tuple(mesh.axis_names[:1])


class Sharding(NamedTuple):
    """A placement on a mesh: ``spec`` holds one entry a leading dim, an
    axis name, a tuple of axis names (the dim splits over their product,
    row-major) or None (not split), as a JAX ``PartitionSpec``; ``()`` is
    replicated."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, axis=None) -> Sharding:
    """Sharding for a [B, ...] batch: dim 0 split over :func:`batch_axes`."""
    return Sharding(mesh, (batch_axes(mesh) if axis is None else axis,))


def batch_axis_size(mesh: Mesh) -> int:
    """Ranks along the batch axes: the divisibility requirement for dim 0
    of anything placed with :func:`batch_sharding`."""
    size = 1
    for a in batch_axes(mesh):
        size *= mesh.shape[a]
    return size


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _block(mesh: Mesh, axes) -> Tuple[int, int]:
    """(this rank's index, the count) over ``axes``, row-major."""
    index, count = 0, 1
    for a in _axes(axes):
        index = index * mesh.shape[a] + mesh.coordinate(a)
        count *= mesh.shape[a]
    return index, count


def batch_block(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a batch on ``mesh``."""
    return _block(mesh, batch_axes(mesh))


def eval_block(mesh: Optional[Mesh], n: int) -> slice:
    """The rows of an ``n``-row evaluation set this rank evaluates: all of
    them without a mesh or with local batches, else its contiguous block
    (blocks differ by at most one row; no divisibility needed, since the
    sums are joined by ``global_sums``)."""
    if mesh is None or mesh.local_batches:
        return slice(0, n)
    index, count = batch_block(mesh)
    return slice(n * index // count, n * (index + 1) // count)


def mark_placed(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mark ``t`` as a batch placed on ``mesh``: :func:`put_batch` then
    returns it as it is."""
    t._nif_placed_on = id(mesh)
    return t


def _placed(a, mesh: Mesh) -> bool:
    return isinstance(a, torch.Tensor) and getattr(a, "_nif_placed_on", None) == id(mesh)


def host_block(arr: np.ndarray, mesh: Mesh, axis=None) -> np.ndarray:
    """This rank's block of dim 0 of a host batch (all of it with local
    batches), before any copy: what :func:`put_batch` keeps."""
    if mesh.local_batches:
        return arr
    index, count = _block(mesh, batch_axes(mesh) if axis is None else axis)
    if arr.shape[0] % count:
        raise ValueError(f"dim 0 of size {arr.shape[0]} does not split over {count} ranks")
    k = arr.shape[0] // count
    return arr[index * k: (index + 1) * k]


def put_global(leaf, sharding: Sharding) -> torch.Tensor:
    """This rank's block of ONE array that every rank holds whole (same
    seed, same file) under ``sharding``, on the rank's device. Each split
    dim must divide by its ranks."""
    mesh = sharding.mesh
    a = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    for dim, entry in enumerate(sharding.spec):
        index, count = _block(mesh, entry)
        if count == 1:
            continue
        if a.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {a.shape[dim]} does not split over "
                             f"{_axes(entry)} ({count} ranks)")
        k = a.shape[dim] // count
        a = a.narrow(dim, index * k, k)
    return a.to(mesh.device)


def put_batch(arr, mesh: Mesh, axis=None) -> torch.Tensor:
    """Place one batch array on ``mesh``: this rank's block of a global
    batch, or the rank's own batch as it is (``mesh.local_batches``), on
    the rank's device. A tensor this function placed on ``mesh`` comes back
    as it is."""
    if _placed(arr, mesh):
        return arr
    if mesh.local_batches:
        a = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
        return mark_placed(a.to(mesh.device), mesh)
    return mark_placed(put_global(arr, batch_sharding(mesh, axis)), mesh)


def put_batch_tuple(arrays, mesh: Optional[Mesh], device=None):
    """None-preserving batch placement for a tuple of arrays: each one's
    dim 0 on ``mesh`` (:func:`put_batch`), or the arrays as tensors on
    ``device`` without a mesh. The helper behind both trainers' staging."""
    if mesh is None:
        return tuple(None if a is None else torch.as_tensor(a, device=device) for a in arrays)
    return tuple(None if a is None else put_batch(a, mesh) for a in arrays)


def _checksum(p: torch.Tensor) -> torch.Tensor:
    """An exact int64 checksum of a tensor's bits, weighted by position."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[p.element_size()]
    v = p.detach().contiguous().reshape(-1).view(bits).to(torch.int64)
    return torch.sum(v * torch.arange(1, v.numel() + 1, dtype=torch.int64, device=v.device))


def put_replicated(tree, mesh: Mesh):
    """Check that every rank holds the same values of ``tree`` (a module,
    or nested dicts of tensors) and return it: its parameters already live
    on each rank's device. One ``all_reduce`` (MAX) of the leaves' exact
    checksums and their negations; raises when a rank differs."""
    if isinstance(tree, torch.nn.Module):
        leaves = [p for _, p in sorted(tree.state_dict(keep_vars=True).items())]
    else:
        leaves = []

        def visit(node):
            if isinstance(node, dict):
                for k in sorted(node):
                    visit(node[k])
            elif node is not None:
                leaves.append(torch.as_tensor(node))

        visit(tree)
    if not leaves:
        return tree
    sums = torch.stack([_checksum(p).cpu() for p in leaves])
    both = torch.cat([sums, -sums]).to(collective_device(mesh.device))
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, neg_lo = both[: len(leaves)].cpu(), both[len(leaves):].cpu()
    if not torch.equal(hi, -neg_lo):
        bad = int(torch.nonzero(hi != -neg_lo)[0, 0])
        raise RuntimeError(f"replicated values differ across ranks (leaf {bad} of "
                           f"{len(leaves)}): initialize every rank from the same seed")
    return tree


def _head_path() -> Tuple[str, ...]:
    return ("pnet", "last", "w")


def model_axis_specs(model, mesh: Mesh, axis: str = "model"):
    """``{path: spec}`` over ``model.param_items()``: the tensor-parallel
    placement. The hypernetwork head kernel (``pnet.last.w``, ``[latent_dim,
    po_dim]``), the one parameter that grows with the ShapeNet's units^2,
    splits row-parallel: its *contracting* latent rows split over ``axis``
    (``(axis, None)``); everything else is replicated (``()``), and so is a
    head whose rows do not divide the axis."""
    n_model = mesh.shape.get(axis, 1)
    specs = {}
    for path, p in model.param_items():
        if (n_model > 1 and "last" in path and path[-1] == "w" and p.dim() == 2
                and p.shape[0] % n_model == 0):
            specs[path] = (axis, None)
        else:
            specs[path] = ()
    return specs


class RowParallelHead:
    """The head ``latent @ w + b`` with ``w``'s rows split over a model
    group: this rank holds ``w[rows]`` and computes ``latent[:, rows] @
    w[rows]``, the partial products are summed over the group, and the
    bias is added once. The operands are rounded to the compute dtype as the
    unsplit head rounds them, and the product runs in float32 at least (a
    bf16 policy rounds the sum once, as the unsplit product does).

    A plain autograd-aware ``all_reduce`` (``torch.distributed.nn``) would
    sum the group's cotangents in its backward; every rank already holds
    the whole cotangent of the sum, so that would count it ``n_model``
    times. The pair used here sums in the forward only, and sums the
    latent's cotangent (each rank's covers its own rows) in the backward
    only, so the head shard's gradient is its rows of the unsplit gradient
    and the replicated layers below get their whole gradient on every
    rank."""

    def __init__(self, group, rows: slice, full_rows: int):
        self.group, self.rows, self.full_rows = group, rows, full_rows

    def __call__(self, latent: torch.Tensor, last) -> torch.Tensor:
        acc = torch.promote_types(latent.dtype, torch.float32)
        x = copy_to_group(latent, self.group)[..., self.rows]
        w = last["w"].to(latent.dtype)  # the unsplit head's operand rounding
        y = reduce_from_group(x.to(acc) @ w.to(acc), self.group)
        return y.to(latent.dtype) + last["b"].to(latent.dtype)

    def reduce(self, value: torch.Tensor) -> torch.Tensor:
        """A sum over the shard (a regularization term) summed over the group."""
        return reduce_from_group(value, self.group)


def put_params_model_parallel(model, mesh: Mesh, axis: str = "model"):
    """Split the head kernel's rows over ``axis`` in place (see
    :func:`model_axis_specs`): the parameter becomes this rank's rows and
    the ParameterNet computes its head through :class:`RowParallelHead`.
    Everything else stays replicated. Call it before building the optimizer
    (its moments then follow the shard). Returns ``model.param_tree()``."""
    specs = model_axis_specs(model, mesh, axis)
    for path, spec in specs.items():
        if not spec:
            continue
        parent = model.param_tree()
        for key in path[:-1]:
            parent = parent[key]
        w = parent[path[-1]]
        n = mesh.shape[axis]
        k = w.shape[0] // n
        rows = slice(mesh.coordinate(axis) * k, (mesh.coordinate(axis) + 1) * k)
        parent[path[-1]] = torch.nn.Parameter(w.detach()[rows].clone())
        parent.row_parallel = RowParallelHead(mesh.group(axis), rows, w.shape[0])
    return model.param_tree()


def pad_to_multiple(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad dim 0 up to a multiple (returns padded array and original length).

    Point batches must divide evenly across the mesh; padding with copies of
    the first row is safe for inference, and training uses sample weights to
    zero out pad rows.
    """
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.broadcast_to(arr[:1], (rem,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0), n


def shard_batch(batch, mesh: Mesh, axis=None):
    """Place a tree (dicts, lists, tuples) of [B, ...] arrays on ``mesh``,
    dim 0 over the batch axes (:func:`put_batch`)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return put_batch(batch, mesh, axis)
