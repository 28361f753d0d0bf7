"""Tutorial 12 — multi-host data parallelism.

The reference tops out at single-node ``MirroredStrategy`` (reference
README.md:42-52). On a cluster each rank (one process a card) runs this
same recipe:

    from nif_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()                  # torchrun's environment
    mesh = make_mesh(local_batches=True)  # spans every host's ranks
    trainer = GroupedTrainer(model, adam(1e-3), mesh=mesh)
    state = trainer.init(0)             # same seed on every rank
    ds = GroupedDataset().open(path, host_id=host, num_hosts=hosts)
    for epoch, t, x, u, w in ds.iter_batches(group_batch, point_batch, epochs):
        state, loss = trainer.step(state, t, x, u, w)   # the rank's block in;
        # loss and gradients averaged over the mesh's batch axes

Run locally (no cluster needed) this example drives the same worker
(``nif_tpu_torch/parallel/multihost.py``) on a CPU cluster of
``n_processes`` hosts of ``devices_per_process`` gloo ranks each, against
a striped ``GroupedDataset`` (``nif_tpu_torch.entry.dryrun_multihost``).
"""
import argparse


def main(n_processes=2, devices_per_process=2):
    from nif_tpu_torch.entry import dryrun_multihost

    dryrun_multihost(n_processes, devices_per_process)
    return 0.0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=2)
    args = ap.parse_args()
    main(args.n_processes, args.devices_per_process)
