"""Tutorial 9 — data-parallel training over a device mesh.

The reference's distribution story is user-side
``tf.distribute.MirroredStrategy`` (reference README.md:39-49). The port
runs one process a rank (``torch.distributed``): :func:`main` starts
``world`` ranks (``parallel.launch.run_ranks``), each builds the mesh
(``parallel.make_mesh``), keeps its block of every batch and averages the
gradients over the ``data`` axis (one ``all_reduce`` of one flat bucket)
before the update; the parameters stay replicated. The ranks are gloo on
the CPU, NCCL with one card a rank, and gloo when they share one card.

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.parallel import make_mesh
from nif_tpu_torch.training import Trainer


def rank_main(epochs=500, batch_size=512, seed=0):
    """What each rank runs (its process group already joined): the
    data-parallel fit; returns the global MSE, the same on every rank."""
    mesh = make_mesh()
    print(f"mesh: {dict(mesh.shape)} over {mesh.size} ranks on {mesh.device}")

    tw = TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIF(
        {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"},
        {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"},
        device=mesh.device,
    )
    # any batch_size works: the trainer rounds up to the data-axis size
    # and zero-weight-pads, so nothing is dropped
    trainer = Trainer(model, adam(2e-3), mesh=mesh)
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs,
                        batch_size=batch_size)
    mse = trainer.evaluate(state, inputs, targets)
    print(f"data-parallel MSE: {mse:.3e}")
    return mse


def main(epochs=500, batch_size=512, seed=0, device="cuda", world=2):
    """Run :func:`rank_main` on ``world`` local ranks; returns rank 0's MSE."""
    import torch

    from nif_tpu_torch.parallel.launch import run_ranks

    if device == "cpu":
        backend, rank_device = "gloo", "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        # one card a rank over NCCL, or every rank on the one card over gloo
        many = torch.cuda.device_count() >= world
        backend, rank_device = ("nccl", "cuda") if many else ("gloo", "cuda:0")
    results = run_ranks("nif_tpu_torch.examples.09_data_parallel:rank_main", world,
                        {"epochs": epochs, "batch_size": batch_size, "seed": seed},
                        backend=backend, device=rank_device, timeout=600.0)
    return results[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args()
    main(args.epochs, args.batch_size, device=args.device, world=args.world)
