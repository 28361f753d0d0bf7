"""Tutorial 5 — Scaling to 100s of GB with sharded streaming.

Covers (reference tutorial/5_large_scale_training_on_tensorflow_record_data
.ipynb, README.md:219-221): creating shards from a big npz and training by
streaming them — with a global epoch counter (the reference resets its
epoch count per file) and a multithreaded native loader instead of the
columnar-tfrecord workaround.

Part 2 (:func:`grouped_streaming_demo`) streams snapshot-structured shards
into ``GroupedTrainer.step``: on the card each step is one launch of the
fused train kernel (this vanilla swish chain takes its CUDA-core form).

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse
import os
import tempfile

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.data.sharded_dataset import ShardedDataset
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.training import TrainState, make_train_step

CFG_S = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"}
CFG_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"}


def stream_data(n_points, seed=0):
    """The "big" dataset: u(t, x) = sin(2 pi (x - t)) at ``n_points``
    uniform draws, ``[n_points, 3]`` float32 rows ``[t, x, u]``."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, n_points).astype(np.float32)
    x = rng.uniform(0, 1, n_points).astype(np.float32)
    u = np.sin(2 * np.pi * (x - t)).astype(np.float32)
    return np.stack([t, x, u], axis=-1)


def grouped_data(G=64, P=4096, seed=0):
    """The snapshot-structured dataset of part 2: ``t [G, 1]``, ``x [G, P,
    1]``, ``u [G, P, 1]`` float32."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, (G, 1)).astype(np.float32)
    x = rng.uniform(0, 1, (G, P, 1)).astype(np.float32)
    u = np.sin(2 * np.pi * (x - t[:, None, :])).astype(np.float32)
    return t, x, u


def main(epochs=3, batch_size=2048, n_points=200_000, seed=0, workdir=None,
         device="cuda"):
    workdir = workdir or tempfile.mkdtemp(prefix="nif_shards_")

    # --- synthesize a "big" dataset npz: u(t, x) on a fine grid ---
    npz_path = os.path.join(workdir, "big.npz")
    np.savez(npz_path, data=stream_data(n_points, seed))

    # --- shard it (reference: TFRDataset.create_from_npz) ---
    ds = ShardedDataset(n_feature=2, n_target=1)
    ds.create_from_npz(
        num_pts_per_file=50_000, npz_path=npz_path, npz_key="data",
        out_path=os.path.join(workdir, "shards"), verbose=True,
    )

    # --- stream-train ---
    model = nif_tpu_torch.NIF(CFG_S, CFG_P, device=device)
    model.init(seed)
    opt = adam(1e-3)([p for _, p in model.param_items()])
    step = make_train_step(model)
    state = TrainState(model.param_tree(), opt)

    stream = ShardedDataset.from_dir(os.path.join(workdir, "shards"))
    last_epoch, losses = -1, []
    for epoch, feats, targets, _ in stream.iter_batches(
        batch_size=batch_size, epochs=epochs, seed=seed
    ):
        if epoch != last_epoch and losses:
            print(f"epoch {last_epoch}: mean loss {np.mean(losses):.3e}")
            losses = []
        last_epoch = epoch
        state, loss = step(state, feats, targets)
        losses.append(float(loss))
    print(f"epoch {last_epoch}: mean loss {np.mean(losses):.3e}")
    return float(np.mean(losses))


def grouped_streaming_demo(workdir=None, epochs=2, device="cuda"):
    """Part 2 — the grouped fast path at scale: snapshot-structured shards
    feeding the fused train kernel (GroupedDataset + mse_value_and_grad)."""
    from nif_tpu_torch.data import GroupedDataset
    from nif_tpu_torch.training import GroupedTrainer

    workdir = workdir or tempfile.mkdtemp(prefix="nif_grouped_")
    t, x, u = grouped_data()
    GroupedDataset.create_from_arrays(t, x, u, os.path.join(workdir, "snaps"),
                                      groups_per_file=16)

    model = nif_tpu_torch.NIF(CFG_S, CFG_P, device=device)
    trainer = GroupedTrainer(model, adam(1e-3))
    state = trainer.init(0)
    ds = GroupedDataset(os.path.join(workdir, "snaps"))
    losses = []
    for epoch, bt, bx, bu, _ in ds.iter_batches(group_batch=16,
                                                point_batch=1024,
                                                epochs=epochs):
        state, loss = trainer.step(state, bt, bx, bu)
        losses.append(float(loss))
    print(f"grouped streaming: {len(losses)} steps, "
          f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    return losses[-1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--n-points", type=int, default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, args.batch_size, args.n_points, device=args.device)
