"""Tutorial 4 — Input-output Jacobians and Hessians.

Covers (reference tutorial/4_get_gradients_by_wrapping_model_with_layer.ipynb,
README.md:216-217): the ``JacobianLayer``/``HessianLayer`` equivalents —
here plain function calls composed with the model (``torch.func``).

The model is a tanh chain, so every derivative here runs eager: the fused
Jacobian and Hessian kernels take sine chains only. :func:`derivatives` is
the stage after training, a function of the model and the data.

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np
import torch

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.ops import (output_and_jacobian, output_jacobian_hessian,
                               output_jacobian_hessian_grouped)
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.training import Trainer

cfg = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
       "activation": "tanh"}
cfg_p = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
         "activation": "tanh"}


def derivatives(model, tw):
    """The Jacobian and Hessian block on the trained ``model`` over the
    wave ``tw``: a dict of tensors (``y``, ``jac``, ``dudx`` of the first
    100 rows, ``y2``, ``jac2``, ``hess`` of the first 10, and the grouped
    ``yg``, ``jg``, ``hg`` over every snapshot)."""
    inputs = torch.as_tensor(np.asarray(tw.data[:, :2], np.float32), device=model.device)
    out = {}
    # (y, dy/dx): jacobian of the field w.r.t. [t, x]
    fn = model.apply
    out["y"], out["jac"] = output_and_jacobian(fn, inputs[:100])
    print(f"y {tuple(out['y'].shape)}, du/d[t,x] {tuple(out['jac'].shape)}")
    # du/dx only:
    _, out["dudx"] = output_and_jacobian(fn, inputs[:100], x_index=[1])
    print(f"du/dx {tuple(out['dudx'].shape)}, mean |du/dx| = "
          f"{float(torch.mean(torch.abs(out['dudx']))):.3f}")

    # second derivatives
    out["y2"], out["jac2"], out["hess"] = output_jacobian_hessian(fn, inputs[:10])
    print(f"hessian {tuple(out['hess'].shape)} (d2u/dx2[0] = "
          f"{float(out['hess'][0, 0, 1, 1]):.4f})")

    # at scale, use the GROUPED second-order evaluator: the hypernet runs
    # once per snapshot (for sine chains on the card, (y, jac, hess) come
    # out of one fused forward-over-forward kernel) — e.g. the field's
    # Laplacian over a full snapshot:
    inp = np.asarray(tw.data[:, :2], np.float32)
    t_g = np.unique(inp[:, :1], axis=0)  # [G, 1] snapshot times
    x_g = np.broadcast_to(np.unique(inp[:, 1:], axis=0),
                          (len(t_g), tw.n_x_grid, 1))  # [G, P, 1]
    out["yg"], out["jg"], out["hg"] = output_jacobian_hessian_grouped(
        model, torch.as_tensor(t_g), torch.as_tensor(np.ascontiguousarray(x_g)))
    lap = out["hg"][..., 0, 0, 0]  # d2u/dx2 per point, [G, P]
    print(f"grouped hessian {tuple(out['hg'].shape)}, mean |d2u/dx2| = "
          f"{float(torch.mean(torch.abs(lap))):.3f}")
    return out


def main(epochs=500, seed=0, device="cuda"):
    tw = TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIF(cfg, cfg_p, device=device)
    trainer = Trainer(model, adam(2e-3))
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)

    with torch.no_grad():  # forward-mode derivatives: no graph for the parameters
        out = derivatives(model, tw)
    return float(torch.mean(torch.abs(out["dudx"])))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, device=args.device)
