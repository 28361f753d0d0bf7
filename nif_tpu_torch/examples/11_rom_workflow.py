"""Tutorial 11 (workflow capstone) — the NIF reduced-order-model pipeline.

The point of NIF (JMLR 2023): compress a spatio-temporal field into a
low-dimensional latent trajectory, then work entirely in latent space.
This example runs the full loop the reference enables via its subnetwork
extractors (reference README.md:99-117):

  1. train a NIF on snapshot data;
  2. encode: t -> latent trajectory  (p_to_lr);
  3. decode: latent -> ShapeNet weights -> field on ANY mesh
     (lr_to_w + x_to_u_given_w) — including a finer mesh than trained on;
  4. latent-space surrogate: fit dt-dynamics on the latent trajectory and
     roll it forward, decoding predicted latents back to fields.

:func:`rom_stages` is steps 2-4, a function of the trained model and the
data. Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.training import Trainer
from nif_tpu_torch.utils import rel_l2


def _np(a):
    return a.detach().cpu().numpy()


def rom_stages(model, tw):
    """Steps 2-4 on the trained ``model`` over the wave ``tw``: a dict with
    the ``latents [T, k]``, the finer decode ``u_fine [400, 1]`` of
    snapshot 5, the rolled-out latents ``z_roll`` and the rollout's
    per-snapshot rel-L2 ``errs``."""
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    # ---- 2. encode the parameter axis into the latent trajectory --------
    t_grid = np.unique(inputs[:, :1], axis=0)  # [T, 1]
    latents = _np(model.p_to_lr(t_grid))  # [T, k]
    print(f"latent trajectory: {latents.shape} (k={latents.shape[1]})")

    # ---- 3. decode on a FINER mesh than trained on (mesh-agnostic!) -----
    x_fine = np.linspace(0, 1, 400, endpoint=False)[:, None].astype(np.float32)
    x_fine_n = ((x_fine - tw.mean[1]) / tw.std[1]).astype(np.float32)
    wb = _np(model.lr_to_w(latents[5:6]))  # snapshot 5
    u_fine = _np(model.x_to_u_given_w(
        np.broadcast_to(x_fine_n, (400, 1)).copy(),
        np.broadcast_to(wb, (400, wb.shape[1])).copy()
    ))
    print(f"decoded snapshot on 4x finer mesh: {u_fine.shape}")

    # ---- 4. latent dynamics surrogate: linear one-step model ------------
    z = latents
    A, *_ = np.linalg.lstsq(z[:-1], z[1:], rcond=None)  # z_{t+1} ~ z_t @ A
    z_roll = [z[0]]
    for _ in range(len(z) - 1):
        z_roll.append(z_roll[-1] @ A)
    z_roll = np.stack(z_roll)
    # decode the rolled-out latents at the training mesh and compare
    x_train = np.unique(inputs[:, 1:2], axis=0)
    errs = []
    for i in range(len(t_grid)):
        wb_i = _np(model.lr_to_w(z_roll[i: i + 1]))
        u_i = _np(model.x_to_u_given_w(
            x_train, np.broadcast_to(wb_i, (len(x_train), wb_i.shape[1])).copy()
        ))
        mask = np.isclose(inputs[:, 0], t_grid[i, 0])
        u_true = targets[mask]
        errs.append(float(rel_l2(u_i, u_true)))
    print(f"latent-surrogate rollout rel-L2: mean {np.mean(errs):.3f}, "
          f"max {np.max(errs):.3f}")
    return {"latents": latents, "u_fine": u_fine, "z_roll": z_roll, "errs": errs}


def main(epochs=3000, seed=0, device="cuda"):
    tw = TravelingWave(n_t=20, n_x=100)
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIF(
        {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"},
        {"input_dim": 1, "latent_dim": 2, "units": 30, "nlayers": 2,
         "activation": "swish"},
        device=device,
    )
    trainer = Trainer(model, adam(2e-3))
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)
    print(f"trained: MSE {trainer.evaluate(state, inputs, targets):.3e}")
    return float(np.mean(rom_stages(model, tw)["errs"]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, device=args.device)
