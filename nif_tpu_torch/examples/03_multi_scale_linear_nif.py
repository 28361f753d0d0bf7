"""Tutorial 3 — NIF-linear: learned modal decomposition on cylinder flow.

Covers (reference tutorial/3_multi_scale_linear_NIF.ipynb, README.md:212-214):
  * ``NIFMultiScaleLastLayerParameterized`` (u = phi(x)^T a(t) + b)
  * area-weighted training on AMR-style data (the point-wise ``Trainer``)
  * extracting the spatial modes phi(x) for linear-subspace ROM

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import CylinderFlow
from nif_tpu_torch.optimizers import adam, cosine_decay_schedule
from nif_tpu_torch.training import LossPrintingCallback, Trainer

cfg_shape_net = {
    "connectivity": "last_layer",
    "input_dim": 2,
    "output_dim": 2,
    "units": 30,
    "nlayers": 2,
    "weight_init_factor": 0.01,
    "omega_0": 30.0,
    "activation": "sine",
    "use_resblock": False,
}
cfg_parameter_net = {
    "input_dim": 1,
    "latent_dim": 10,
    "units": 30,
    "nlayers": 2,
    "activation": "swish",
    "use_resblock": False,
    "omega_0": 30.0,
}


def main(epochs=2000, batch_size=1024, seed=0, device="cuda"):
    cf = CylinderFlow()
    inputs = np.asarray(cf.data[:, :3], np.float32)  # [t, x, y]
    targets = np.asarray(cf.data[:, 3:5], np.float32)  # [u, v]
    weights = np.asarray(cf.sample_weight, np.float32)

    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
        cfg_shape_net, cfg_parameter_net, device=device
    )
    steps = max(epochs * -(-len(inputs) // batch_size), 1)  # ceil: tail batches train too
    trainer = Trainer(model, adam(cosine_decay_schedule(1e-3, steps)))
    state = trainer.init(seed)
    state = trainer.fit(
        state, inputs, targets, sample_weight=weights,
        epochs=epochs, batch_size=batch_size,
        callbacks=[LossPrintingCallback(every=max(epochs // 10, 1))],
    )
    mse = trainer.evaluate(state, inputs, targets, sample_weight=weights)
    print(f"NIF-linear weighted MSE: {mse:.3e}")

    # modal decomposition: spatial modes + temporal coefficients
    xy = inputs[:600, 1:3]
    phi = model.x_to_phi(xy)  # [N, 2, latent]
    a_t = model.p_to_lr(np.unique(inputs[:, :1], axis=0))
    print(f"phi(x): {tuple(phi.shape)}  a(t): {tuple(a_t.shape)}  "
          f"(u = phi @ a + b is a rank-{a_t.shape[1]} linear ROM)")
    return mse


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, args.batch_size, device=args.device)
