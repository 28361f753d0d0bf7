"""Multi-GPU data and tensor parallelism on ``torch.distributed``
(counterpart of ``nif_tpu/parallel``): one rank a device, a
``DeviceMesh`` with the JAX package's axis names, the batch split over its
batch axes and the hypernetwork head row-parallel over its model axis
(``mesh.py``), ZeRO-1 (``zero.py``), checkpoints of a split state
(``state.py``), local rank launches (``launch.py``) and the multi-host
worker (``python -m nif_tpu_torch.parallel.multihost``)."""
from .mesh import (
    Mesh,
    RowParallelHead,
    Sharding,
    batch_axes,
    batch_axis_size,
    batch_block,
    batch_sharding,
    eval_block,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    model_axis_specs,
    pad_to_multiple,
    put_batch,
    put_batch_tuple,
    put_global,
    put_params_model_parallel,
    put_replicated,
    rank_device,
    replicated_sharding,
    shard_batch,
)
from .zero import ZeroOneOptimizer

__all__ = [
    "Mesh",
    "Sharding",
    "RowParallelHead",
    "ZeroOneOptimizer",
    "make_mesh",
    "make_hybrid_mesh",
    "batch_sharding",
    "batch_axis_size",
    "batch_axes",
    "batch_block",
    "eval_block",
    "replicated_sharding",
    "shard_batch",
    "pad_to_multiple",
    "init_distributed",
    "rank_device",
    "put_batch",
    "put_batch_tuple",
    "put_global",
    "put_replicated",
    "model_axis_specs",
    "put_params_model_parallel",
]
