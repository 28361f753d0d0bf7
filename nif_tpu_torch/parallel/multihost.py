"""Multi-host (multi-process) data-parallel training harness (counterpart
of ``nif_tpu/parallel/multihost.py``).

The recipe, one rank a device:

1. every rank calls :func:`nif_tpu_torch.parallel.init_distributed`;
2. build a mesh over the ranks with ``local_batches=True``;
3. each host streams ITS stripe of the dataset
   (``GroupedDataset.open(path, host_id, num_hosts)``), cuts each local
   group batch into one block a data coordinate of its ranks, and feeds the
   rank's block to ``GroupedTrainer.step``; the step averages the loss and
   gradients over the mesh's batch axes.

A host is ``devices_per_process`` ranks (the JAX package's process with
that many devices): rank ``process_id * devices_per_process + local_rank``
of ``num_processes * devices_per_process``. Every rank is truncated to the
global minimum steps per epoch so uneven stripes keep the collectives in
lockstep; a resumable checkpoint is written by rank 0 and read by all; the
global rel-L2 comes from ``global_sums``. ``model_axis > 1`` adds the
row-parallel head over a ``('data', 'model')`` mesh (the model axis inside a
host) and ZeRO-1 on the point-wise ``Trainer``. Run one rank as::

    python -m nif_tpu_torch.parallel.multihost --coordinator 127.0.0.1:1234 \\
        --num-processes 2 --process-id 0 --local-rank 0 --data-dir /path/to/snapshots

(``--local-rank`` defaults to torchrun's ``LOCAL_RANK``; ``--device``
defaults to ``cuda``). :func:`launch_local_cluster` runs a CPU cluster.
"""
from __future__ import annotations

import argparse
import json
import os


def worker_model(device="cuda"):
    """The fixed tiny model the harness trains: exposed so tests can rebuild
    it to cross-check reported global metrics."""
    import nif_tpu_torch

    return nif_tpu_torch.NIFMultiScale(
        {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.1},
        {"input_dim": 2, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0},
        device=device,
    )


def _block(a, index: int, count: int):
    """Block ``index`` of ``count`` of dim 0 (blocks differ by at most one)."""
    n = a.shape[0]
    return a[n * index // count: n * (index + 1) // count]


def run_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    data_dir: str,
    out_path: str = None,
    devices_per_process: int = 2,
    epochs: int = 2,
    group_batch_per_host: int = None,
    point_batch: int = 64,
    ckpt_dir: str = None,
    model_axis: int = 1,
    local_rank: int = None,
    device: str = "cuda",
    backend: str = None,
    timeout: float = 300.0,
) -> float:
    """One rank of a multi-host data-parallel training run.

    Returns the final step loss (identical on every rank: it is averaged
    over the mesh). ``group_batch_per_host`` defaults to
    ``devices_per_process`` and must be a multiple of it.

    ``model_axis > 1`` adds TENSOR parallelism across a ('data', 'model')
    mesh: the hypernetwork head kernel and its Adam moments split
    row-parallel over the model axis (inside a host:
    ``devices_per_process`` must be a multiple of it), and ZeRO-1 runs on
    the point-wise ``Trainer``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..data import GroupedDataset
    from ..optimizers import adam
    from ..training import GroupedTrainer
    from ..training.callbacks import save_state
    from ..training.checkpoint import Checkpointer
    from ..training.evaluation import global_sums, metrics_from_sums
    from .collectives import collective_device
    from .mesh import init_distributed, make_mesh
    from .state import full_optimizer_state, full_param_state, local_params

    if group_batch_per_host is None:
        group_batch_per_host = devices_per_process
    if group_batch_per_host % devices_per_process != 0:
        raise ValueError(
            f"group_batch_per_host={group_batch_per_host} must be a "
            f"multiple of devices_per_process={devices_per_process}: the "
            "host's group batch splits across its ranks"
        )
    if devices_per_process % model_axis:
        raise ValueError(f"model_axis={model_axis} must divide devices_per_process="
                         f"{devices_per_process}: the model axis lies inside a host")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    world = num_processes * devices_per_process
    rank = process_id * devices_per_process + local_rank
    dev = device if device != "cuda" else f"cuda:{local_rank}"
    init_distributed(coordinator, world, rank, backend=backend, device=dev, timeout=timeout)
    if model_axis > 1:
        mesh = make_mesh(axis_names=("data", "model"),
                         mesh_shape=(world // model_axis, model_axis), local_batches=True)
    else:
        mesh = make_mesh(local_batches=True)
    # the host's group batch splits into one block a data coordinate
    blocks = devices_per_process // model_axis
    index = local_rank // model_axis

    model = worker_model(mesh.device)
    trainer = GroupedTrainer(model, adam(1e-3), mesh=mesh, shard_model_axis=model_axis > 1)
    # Same seed everywhere -> identical replicated params (checked). With a
    # shared ckpt_dir the run is resumable: rank 0 writes, every rank reads.
    if ckpt_dir:
        state = trainer.init_or_restore(0, ckpt_dir)
    else:
        state = trainer.init(0)
    resumed_step = int(state.step)

    ds = GroupedDataset()
    ds.open(data_dir, host_id=process_id, num_hosts=num_processes)

    # Hosts may hold different numbers of groups (striping remainder).
    # Every rank must take the SAME number of steps per epoch or the
    # gradient all_reduce deadlocks: truncate to the global minimum.
    local_steps = ds.steps_per_epoch(group_batch_per_host, drop_remainder=True)
    steps = torch.tensor([local_steps], dtype=torch.int64, device=collective_device())
    dist.all_reduce(steps, op=dist.ReduceOp.MIN)
    min_steps = int(steps.item())
    if min_steps == 0:
        raise ValueError(
            f"a host's stripe yields 0 full batches of "
            f"{group_batch_per_host} groups — lower group_batch_per_host "
            "or use fewer hosts"
        )

    loss = first_loss = float("nan")
    cur_epoch, taken = -1, 0
    for epoch, bt, bx, bu, _ in ds.iter_batches(
        group_batch=group_batch_per_host, point_batch=point_batch,
        epochs=epochs, seed=process_id, drop_remainder=True,
    ):
        if epoch != cur_epoch:
            cur_epoch, taken = epoch, 0
        if taken >= min_steps:
            continue  # surplus local batch: skip to stay in lockstep
        taken += 1
        state, loss_t = trainer.step(state, _block(bt, index, blocks),
                                     _block(bx, index, blocks), _block(bu, index, blocks))
        loss = float(loss_t)
        if np.isnan(first_loss):
            first_loss = loss

    if ckpt_dir:
        save_state(Checkpointer(ckpt_dir), int(state.step), {
            "params": full_param_state(model),
            "opt_state": full_optimizer_state(model, state.opt_state),
            "step": int(state.step),
        }, mesh)

    # ---- global evaluation: each rank accumulates LOCAL error/target sums
    # over its block of its host's stripe (its own kernels, no collective
    # but the row-parallel head's), then ONE float64 all_reduce over the
    # batch axes joins them.
    se = st = n_el = 0.0
    with torch.inference_mode():
        for _, bt, bx, bu, _w in ds.iter_batches(
            group_batch=group_batch_per_host, point_batch=None, epochs=1,
            seed=0, drop_remainder=False,
        ):
            bt, bx, bu = (_block(a, index, blocks) for a in (bt, bx, bu))
            if bt.shape[0] == 0:
                continue
            pred = model.apply_grouped(torch.as_tensor(bt, device=mesh.device),
                                       torch.as_tensor(bx, device=mesh.device))
            d = pred.double().cpu().numpy() - bu.astype(np.float64)
            se += float(np.sum(d * d))
            st += float(np.sum(bu.astype(np.float64) ** 2))
            n_el += bu.size
    se, st, n_el = global_sums(se, st, n_el, mesh=mesh)
    metrics = metrics_from_sums(se, st, n_el)
    params = local_params(model)

    result = {
        "process_id": process_id,
        "rank": rank,
        "num_processes": num_processes,
        "world_size": world,
        "global_devices": world,
        "final_loss": loss,
        "first_loss": first_loss,
        "resumed_step": resumed_step,
        "steps": int(state.step),
        "global_mse": metrics["mse"],
        "global_rel_l2": metrics["rel_l2"],
    }
    if model_axis > 1:
        # prove the TP placement really split the head kernel over the model
        # axis (rather than replicating it)
        head = model.pnet.params["last"]
        result["head_is_sharded"] = (getattr(head, "row_parallel", None) is not None
                                     and head["w"].shape[0] < head.row_parallel.full_rows)

        # ZeRO-1 on the point-wise Trainer: one epoch on synthetic data with
        # split optimizer state + TP head, and this rank's optimizer must
        # hold only a share of the parameters
        from ..parallel.zero import ZeroOneOptimizer
        from ..training import Trainer

        tr = Trainer(worker_model(mesh.device), adam(1e-3), mesh=mesh,
                     shard_opt_state=True, shard_model_axis=True)
        st2 = tr.init(0)
        rng2 = np.random.default_rng(0)  # identical on every rank
        bi = rng2.standard_normal((64, 4)).astype(np.float32)
        bt2 = rng2.standard_normal((64, 1)).astype(np.float32)
        st2 = tr.fit(st2, bi, bt2, epochs=1)
        opt = st2.opt_state
        result["zero1_loss"] = float(tr.history["loss"][-1])
        result["zero1_moment_sharded"] = (isinstance(opt, ZeroOneOptimizer)
                                          and len(opt.owned) < len(opt.params))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f)
        # final params for cross-checking the global metric against a
        # single-process full-dataset computation: "pnet/last/w"-keyed
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = v

        walk(params, "")
        np.savez(out_path + ".params.npz", **flat)
    print(f"multihost worker {rank}: {result}", flush=True)
    dist.destroy_process_group()
    return loss


def launch_local_cluster(
    data_dir: str,
    n_processes: int = 2,
    devices_per_process: int = 2,
    out_dir: str = None,
    epochs: int = 2,
    group_batch_per_host: int = None,
    point_batch: int = 64,
    timeout: float = 540.0,
    ckpt_dir: str = None,
    model_axis: int = 1,
):
    """Spawn ``n_processes`` hosts of ``devices_per_process`` CPU gloo
    ranks each (one local process a rank) over ``data_dir``'s GroupedDataset
    shards, on a free port, and return their result dicts in rank order.
    Each process gets ``timeout`` seconds, and so does every collective; a
    rank that fails fails the call."""
    import sys
    import tempfile

    from .launch import free_port, rank_env, spawn_all

    port = free_port()
    own_tmp = None
    if out_dir is None:
        own_tmp = tempfile.TemporaryDirectory()
        out_dir = own_tmp.name
    else:
        os.makedirs(out_dir, exist_ok=True)
    try:
        cmds, outs = [], []
        for pid in range(n_processes):
            for local in range(devices_per_process):
                out = os.path.join(out_dir, f"worker_{pid * devices_per_process + local}.json")
                outs.append(out)
                cmd = [
                    sys.executable, "-m", "nif_tpu_torch.parallel.multihost",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(n_processes),
                    "--process-id", str(pid), "--local-rank", str(local),
                    "--data-dir", data_dir, "--out", out,
                    "--devices-per-process", str(devices_per_process),
                    "--epochs", str(epochs),
                    "--point-batch", str(point_batch),
                    "--device", "cpu", "--timeout", str(timeout),
                ]
                if group_batch_per_host is not None:
                    cmd += ["--group-batch-per-host", str(group_batch_per_host)]
                if ckpt_dir is not None:
                    cmd += ["--ckpt-dir", ckpt_dir]
                if model_axis != 1:
                    cmd += ["--model-axis", str(model_axis)]
                cmds.append(cmd)
        spawn_all(cmds, rank_env(), timeout, "multihost cluster")
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
        return results
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--devices-per-process", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--group-batch-per-host", type=int, default=None)
    ap.add_argument("--point-batch", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--local-rank", type=int, default=None,
                    help="this rank within its host (default: LOCAL_RANK, else 0)")
    ap.add_argument("--device", default="cuda", help="cuda (one card a local rank) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the rendezvous and every collective")
    args = ap.parse_args(argv)
    run_worker(
        args.coordinator, args.num_processes, args.process_id,
        args.data_dir, args.out, args.devices_per_process, args.epochs,
        args.group_batch_per_host, args.point_batch, args.ckpt_dir,
        args.model_axis, args.local_rank, args.device, args.backend, args.timeout,
    )


if __name__ == "__main__":
    main()
