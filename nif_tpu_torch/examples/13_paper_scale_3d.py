"""Tutorial 13 — paper-scale 3-D field compression.

The NIF paper's flagship application (JMLR 24(41), reference
README.md:263-273) is compressing 3-D parametric turbulence — a workload
the reference repo itself never reproduces (its tutorials stop at 2,000
points). This example runs the full production path at paper scale on one
card:

  1. synthesize a 3-D unsteady analytic field (sum of advecting modes) on
     scattered points — G snapshots x P points per snapshot;
  2. write it as a snapshot-structured ``GroupedDataset`` (streaming
     layout; scales past device and host memory);
  3. train the flagship width-128 SIREN hypernetwork under the
     ``mixed_bfloat16`` policy: device-resident (``fit_resident``, each step
     a CUDA-graph replay holding one launch of the fused train kernel on the
     tensor cores), or streamed group batches when the data passes 2 GiB;
  4. report points/s, end-to-end wall-clock, and rel-L2 on held-out
     snapshots (``apply_grouped``: one launch of the fused forward kernel);
  5. extract the ROM (p -> latent -> weights) and reconstruct on a finer
     query set (mesh-agnostic decode).

Defaults are sized for a quick run; ``--paper`` is the 16.7M-point
configuration (64 x 262,144 points, width 128, latent 128). Runs on the card
by default; ``--device cpu`` runs it without one.
"""
import argparse
import os
import tempfile
import time

import numpy as np


def synth_field(G, P, seed=0):
    """3-D unsteady field: three advecting Fourier-Gaussian modes.

    Returns t [G, 1], x [G, P, 3], u [G, P, 1] (float32, inputs in [-1, 1]).
    """
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, G, endpoint=False).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, size=(G, P, 3)).astype(np.float32)
    t3 = ts[:, None, None]

    def mode(k, c, w, amp):
        phase = (
            k[0] * x[..., 0] + k[1] * x[..., 1] + k[2] * x[..., 2]
            - c * t3[..., 0]
        )
        envelope = np.exp(-w * (x[..., 1] ** 2 + x[..., 2] ** 2))
        return amp * np.sin(np.pi * phase) * envelope

    u = (
        mode((2.0, 0.5, 0.0), 2.0, 1.0, 1.0)
        + mode((4.0, 0.0, 1.0), 4.0, 2.0, 0.5)
        + mode((1.0, 2.0, 2.0), 1.0, 0.5, 0.25)
    )
    return ts[:, None], x, u[..., None].astype(np.float32)


def make_model(units, latent, device="cuda", seed=0):
    """The SIREN hypernetwork of this example (3 -> 1, two hidden layers of
    ``units``; ParameterNet 1 -> ``latent``) under ``mixed_bfloat16``."""
    import nif_tpu_torch

    return nif_tpu_torch.NIFMultiScale(
        {"input_dim": 3, "output_dim": 1, "units": units, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.01},
        {"input_dim": 1, "latent_dim": latent, "units": units, "nlayers": 2,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0},
        mixed_policy="mixed_bfloat16", device=device, seed=seed,
    )


def reconstruct(model, t, x, u, n_train, seed=1):
    """Held-out reconstruction and the finer ROM decode on the trained
    ``model``: snapshots ``n_train:`` of ``(t, x, u)``. Returns a dict with
    the held-out ``pred`` and its rel-L2 ``err``, the latents ``lr``, the
    generated weights ``wb`` and the decode ``u_fine`` at twice the points."""
    import torch

    from nif_tpu_torch.utils import rel_l2

    G, P = x.shape[0], x.shape[1]
    with torch.inference_mode():
        pred = model.apply_grouped(t[n_train:], x[n_train:]).float().cpu().numpy()
    err = float(rel_l2(pred.ravel(), u[n_train:].ravel()))
    print(f"held-out rel-L2 ({G - n_train} unseen snapshots): {err:.3f}")

    # ROM: p -> latent -> generated weights -> decode on a finer query set
    x_fine = np.random.default_rng(seed).uniform(
        -1, 1, (G - n_train, 2 * P, 3)
    ).astype(np.float32)
    with torch.inference_mode():
        lr = model.p_to_lr(t[n_train:])
        wb = model.lr_to_w(lr)
        u_fine = model.x_to_u_given_w_grouped(x_fine, wb)
    print(f"ROM decode on {x_fine.shape[1]} finer points/snapshot: "
          f"{tuple(u_fine.shape)}, latent dim {lr.shape[-1]}")
    return {"pred": pred, "err": err, "lr": lr, "wb": wb, "u_fine": u_fine}


def run(G=None, P=None, epochs=None, group_batch=None, point_batch=None,
        units=None, latent=None, seed=0, workdir=None, paper=False, device="cuda"):
    """:func:`main`'s run: returns a dict with the trained ``model``, the
    ``trainer`` and its ``state``, the ``points`` trained, the training
    seconds ``train_s``, the dataset and :func:`reconstruct`'s results."""
    from nif_tpu_torch.data import GroupedDataset
    from nif_tpu_torch.models.nif import resolve_device
    from nif_tpu_torch.optimizers import adam, cosine_decay_schedule
    from nif_tpu_torch.training import GroupedTrainer

    device = resolve_device(device)
    # --paper sets defaults only; explicit arguments always win
    base = dict(G=8, P=4096, epochs=3, group_batch=4, point_batch=2048,
                units=32, latent=16)
    if paper:  # 64 x 262144 = 16.7M points, flagship width
        base.update(G=64, P=262_144, epochs=2000, group_batch=8,
                    point_batch=32_768, units=128, latent=128)
    G = base["G"] if G is None else G
    P = base["P"] if P is None else P
    epochs = base["epochs"] if epochs is None else epochs
    group_batch = base["group_batch"] if group_batch is None else group_batch
    point_batch = base["point_batch"] if point_batch is None else point_batch
    units = base["units"] if units is None else units
    latent = base["latent"] if latent is None else latent

    workdir = workdir or tempfile.mkdtemp(prefix="nif3d_")
    t, x, u = synth_field(G, P, seed)
    n_train = max(G - max(G // 8, 1), 1)

    snap_dir = os.path.join(workdir, "snaps")
    t0 = time.perf_counter()
    GroupedDataset.create_from_arrays(
        t[:n_train], x[:n_train], u[:n_train], snap_dir,
        groups_per_file=max(group_batch, 1),
    )
    t_create = time.perf_counter() - t0
    gb = (x[:n_train].nbytes + u[:n_train].nbytes + t[:n_train].nbytes) / 1e9
    print(f"dataset: {n_train}x{P} train points ({gb:.2f} GB) "
          f"sharded in {t_create:.1f}s")

    model = make_model(units, latent, device, seed)
    steps = max(epochs * -(-n_train // group_batch), 1)
    # on the card a capturable Adam puts the whole step, update included, in
    # the replayed graph; the schedule advances per replay
    extra = {"capturable": True} if device.type == "cuda" else {}
    trainer = GroupedTrainer(model, adam(cosine_decay_schedule(2e-4, steps), **extra))
    state = trainer.init(seed)

    # Device-resident when the training set fits comfortably on the card
    # (~235 MB at paper scale): data is staged ONCE and point batches are
    # subsampled on the device — per-step host->device transfer would
    # otherwise dominate the ~ms step. Larger datasets stream group batches
    # from the GroupedDataset shards instead.
    resident = (x[:n_train].nbytes + u[:n_train].nbytes) < 2 << 30
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if resident:
        state = trainer.fit_resident(
            state, t[:n_train], x[:n_train], u[:n_train], epochs=epochs,
            group_batch=group_batch, point_batch=point_batch, seed=seed,
        )
        n_pts = int(state.step) * group_batch * point_batch
        loss = trainer.history["loss"][-1]
    else:
        from nif_tpu_torch.data import prefetch_to_device

        ds = GroupedDataset(snap_dir)
        n_pts = 0
        # double-buffer: the next batch copies while the current step runs
        for epoch, bt, bx, bu, _ in prefetch_to_device(ds.iter_batches(
            group_batch=group_batch, point_batch=point_batch, epochs=epochs,
            seed=seed,
        ), device=device):
            state, loss = trainer.step(state, bt, bx, bu)
            n_pts += bt.shape[0] * point_batch
        loss = float(loss)
    dt = time.perf_counter() - t0
    mode = "device-resident" if resident else "incl. streaming"
    print(f"trained {n_pts / 1e6:.1f}M point-visits in {dt:.1f}s "
          f"({n_pts / dt / 1e6:.0f}M pts/s {mode}), "
          f"final step loss {loss:.3e}")

    out = reconstruct(model, t, x, u, n_train)
    out.update(model=model, trainer=trainer, state=state, points=n_pts, train_s=dt,
               data=(t, x, u), n_train=n_train)
    return out


def main(G=None, P=None, epochs=None, group_batch=None, point_batch=None,
         units=None, latent=None, seed=0, workdir=None, paper=False, device="cuda"):
    return run(G, P, epochs, group_batch, point_batch, units, latent, seed, workdir,
               paper, device)["err"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", action="store_true",
                    help="16.7M-point flagship configuration")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kw = {"paper": args.paper, "device": args.device}
    if args.epochs is not None:
        kw["epochs"] = args.epochs
    main(**kw)
