"""Entry points of the port: a compile check and the multi-rank dryruns
(counterpart of the JAX package's ``__graft_entry__.py``).

* :func:`entry` — the grouped forward of the small flagship (NIFMultiScale,
  SIREN hypernetwork, ``mixed_bfloat16``) as an ``nn.Module`` and its
  example inputs, for ``torch.export.export`` and ``torch.compile``. On the
  card its ShapeNet is one call of the registered op
  ``torch.ops.nif_tpu_torch.shapenet_fwd`` (the fused forward kernel).
* :func:`dryrun_multichip` — ``n`` gloo ranks on the CPU (one process
  each, ``parallel.launch.run_ranks``): a ``('data', 'model')`` mesh with
  the hypernetwork head split row-parallel, one epoch of
  ``GroupedTrainer.fit``; then a data-only mesh with ``fit``, a Sobolev
  step and a Hessian step.
* :func:`dryrun_multihost` — a local cluster of ``n_processes`` hosts of
  ``devices_per_process`` gloo ranks training data-parallel over a striped
  ``GroupedDataset`` (``parallel/multihost.py``); the final losses must
  agree on every rank.

``python -m nif_tpu_torch.entry [--device cpu]`` runs :func:`entry`'s
function through ``torch.compile`` and prints ``entry OK: <shape> <dtype>``.
"""
from __future__ import annotations

import argparse

import numpy as np

__all__ = ["entry", "dryrun_multichip", "dryrun_multihost"]

CFG_S = {
    "input_dim": 2,
    "output_dim": 1,
    "units": 32,
    "nlayers": 2,
    "activation": "sine",
    "use_resblock": False,
    "omega_0": 30.0,
    "connectivity": "full",
    "weight_init_factor": 0.01,
}
CFG_P = {
    "input_dim": 2,
    "latent_dim": 8,
    "units": 32,
    "nlayers": 2,
    "activation": "swish",
    "use_resblock": False,
    "omega_0": 30.0,
}


def _flagship(device="cuda", seed: int = 0):
    import nif_tpu_torch

    return nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, mixed_policy="mixed_bfloat16",
                                       device=device, seed=seed)


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: ``fn`` an ``nn.Module`` whose
    ``forward(t [4, 2], x [4, 64, 2])`` is the model's ``apply_grouped``
    (the parameters live in the module, where the JAX function takes them as
    its first argument), the inputs drawn from ``numpy`` seed 0 on
    ``device``."""
    import torch

    class GroupedForward(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, t, x):
            return self.model.apply_grouped(t, x)

    model = _flagship(device)
    rng = np.random.default_rng(0)
    t = rng.standard_normal((4, 2)).astype(np.float32)
    x = rng.standard_normal((4, 64, 2)).astype(np.float32)
    args = tuple(torch.from_numpy(a).to(model.device) for a in (t, x))
    return GroupedForward(model), args


def _check_finite(loss: float, what: str) -> None:
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {what} {loss}")


def _trainer(mesh, seed: int, **kw):
    from nif_tpu_torch.optimizers import adam
    from nif_tpu_torch.training import GroupedTrainer

    trainer = GroupedTrainer(_flagship(mesh.device), adam(1e-3), mesh=mesh, **kw)
    return trainer, trainer.init(seed)


def multichip_rank(n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip` (its process group joined):
    returns the four losses, equal on every rank."""
    from nif_tpu_torch.parallel import make_mesh

    # 2-D mesh: data parallelism over groups, tensor parallelism over the
    # hypernetwork head (the one weight that can get huge — it scales with
    # units^2 of the ShapeNet): GroupedTrainer(shard_model_axis=True) splits
    # pnet.last.w, and its Adam moments with it, row-parallel over 'model'
    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    mesh = make_mesh(axis_names=("data", "model"), mesh_shape=(n_data, n_model))
    trainer_tp, state = _trainer(mesh, 0, shard_model_axis=n_model > 1)
    head = trainer_tp.model.pnet.params["last"]
    rp = getattr(head, "row_parallel", None)
    if n_model > 1 and (rp is None or head["w"].shape[0] * n_model != rp.full_rows):
        raise AssertionError(f"the head is not split over the model axis: {head['w'].shape}")
    rng = np.random.default_rng(0)  # the same global batch on every rank
    G, Pts = n_data * 2, 16
    state = trainer_tp.fit(
        state,
        rng.standard_normal((G, 2)).astype(np.float32),
        rng.standard_normal((G, Pts, 2)).astype(np.float32),
        rng.standard_normal((G, Pts, 1)).astype(np.float32),
        epochs=1, group_batch=G, point_batch=Pts,
    )
    loss = trainer_tp.history["loss"][-1]
    _check_finite(loss, "loss")

    # the production data-parallel loop over a data-only mesh: each rank
    # runs the fused train step on its block, gradients averaged
    dp_mesh = make_mesh()
    trainer, state = _trainer(dp_mesh, 1)
    rng2 = np.random.default_rng(1)
    Gd = n_devices * 2
    state = trainer.fit(
        state,
        rng2.standard_normal((Gd, 2)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, 2)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, 1)).astype(np.float32),
        epochs=1, group_batch=Gd, point_batch=Pts,
    )
    loss2 = trainer.history["loss"][-1]
    _check_finite(loss2, "data-parallel loss")

    # Sobolev mode over the same data mesh: target_jac splits with the batch
    si, so = 2, 1
    tr_sob, st_s = _trainer(dp_mesh, 2, w_jac=0.1)
    st_s, loss3 = tr_sob.step(
        st_s,
        rng2.standard_normal((Gd, 2)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, si)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, so)).astype(np.float32),
        target_jac=rng2.standard_normal((Gd, Pts, so, si)).astype(np.float32),
    )
    loss3 = float(loss3)
    _check_finite(loss3, "sobolev loss")

    # second-order (Hessian-target) mode over the same data mesh
    tr_hess, st_h = _trainer(dp_mesh, 3, w_jac=0.1, w_hess=0.01)
    st_h, loss4 = tr_hess.step(
        st_h,
        rng2.standard_normal((Gd, 2)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, si)).astype(np.float32),
        rng2.standard_normal((Gd, Pts, so)).astype(np.float32),
        target_jac=rng2.standard_normal((Gd, Pts, so, si)).astype(np.float32),
        target_hess=rng2.standard_normal((Gd, Pts, so, si, si)).astype(np.float32),
    )
    loss4 = float(loss4)
    _check_finite(loss4, "hessian loss")
    return {"mesh": [n_data, n_model], "device": str(mesh.device), "backend": mesh.backend,
            "losses": [loss, loss2, loss3, loss4]}


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """Run :func:`multichip_rank` on ``n_devices`` gloo ranks of the CPU,
    one process each, and print the OK line naming the platform. Returns
    rank 0's result; raises when a rank fails or the ranks disagree."""
    from nif_tpu_torch.parallel.launch import run_ranks

    results = run_ranks("nif_tpu_torch.entry:multichip_rank", n_devices,
                        {"n_devices": n_devices}, backend="gloo", device="cpu",
                        timeout=timeout)
    r = results[0]
    if any(o["losses"] != r["losses"] for o in results):
        raise AssertionError(f"the ranks' losses differ: {[o['losses'] for o in results]}")
    n_data, n_model = r["mesh"]
    loss, loss2, loss3, loss4 = r["losses"]
    print(
        f"dryrun_multichip OK: mesh ({n_data} data x {n_model} model) on "
        f"{n_devices} {r['device']} ranks ({r['backend']}, one process each), "
        f"one row-parallel train step loss={loss:.4f}; data-parallel GroupedTrainer "
        f"step loss={loss2:.4f}; sobolev step loss={loss3:.4f}; "
        f"hessian step loss={loss4:.4f}"
    )
    return r


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 2) -> list:
    """Multi-host data-parallel dryrun: ``n_processes`` local hosts of
    ``devices_per_process`` CPU gloo ranks each stripe a GroupedDataset and
    train data-parallel over the global mesh (``parallel/multihost.py``).
    Validates the cluster path without a cluster. Returns the workers'
    results."""
    import os
    import tempfile

    from nif_tpu_torch.data import GroupedDataset
    from nif_tpu_torch.parallel.multihost import launch_local_cluster

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "snaps")
        rng = np.random.default_rng(0)
        GroupedDataset.create_from_arrays(
            rng.standard_normal((8, 2)).astype(np.float32),
            rng.standard_normal((8, 128, 2)).astype(np.float32),
            rng.standard_normal((8, 128, 1)).astype(np.float32),
            data_dir, groups_per_file=2,
        )
        results = launch_local_cluster(
            data_dir, n_processes, devices_per_process, out_dir=tmp
        )
    losses = [r["final_loss"] for r in results]
    if not (all(np.isfinite(v) for v in losses) and max(losses) - min(losses) < 1e-6):
        raise AssertionError(f"the ranks' final losses disagree: {losses}")
    print(
        f"dryrun_multihost OK: {n_processes} processes x "
        f"{devices_per_process} ranks (cpu, gloo), averaged loss identical everywhere "
        f"({losses[0]:.6f})"
    )
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch

    fn, example = entry(args.device)
    out = torch.compile(fn)(*example)
    print("entry OK:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
