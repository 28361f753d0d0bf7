"""Tutorial 2 — Multi-scale NIF (SIREN) on high-frequency data.

Covers (reference tutorial/2_multi_scale_NIF.ipynb, README.md:207-210):
  * ``nif_tpu_torch.NIFMultiScale`` with a SIREN ShapeNet
  * why plain MLPs fail on high-frequency signals and SIREN doesn't
  * a cosine-decayed learning rate (``optimizers.cosine_decay_schedule``)

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWaveHighFreq
from nif_tpu_torch.optimizers import adam, cosine_decay_schedule
from nif_tpu_torch.training import LossPrintingCallback, Trainer

cfg_shape_net = {
    "connectivity": "full",
    "input_dim": 1,
    "output_dim": 1,
    "units": 30,
    "nlayers": 2,
    "weight_init_factor": 0.01,
    "omega_0": 30.0,
    "activation": "sine",
    "use_resblock": False,
}
cfg_parameter_net = {
    "input_dim": 1,
    "latent_dim": 1,
    "units": 30,
    "nlayers": 2,
    "activation": "swish",
    "use_resblock": False,
    "omega_0": 30.0,
}


def main(epochs=5000, batch_size=512, seed=0, device="cuda"):
    tw = TravelingWaveHighFreq()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIFMultiScale(cfg_shape_net, cfg_parameter_net, device=device)
    # a cosine-decayed lr matters for SIREN hypernetworks: 1e-3 decayed to 0
    # over the run, evaluated at the optimizer's own update count
    steps = max(epochs * -(-len(inputs) // batch_size), 1)  # ceil: tail batches train too
    trainer = Trainer(model, adam(cosine_decay_schedule(1e-3, steps)))
    state = trainer.init(seed)
    state = trainer.fit(
        state, inputs, targets, epochs=epochs, batch_size=batch_size,
        callbacks=[LossPrintingCallback(every=max(epochs // 10, 1))],
    )
    mse = trainer.evaluate(state, inputs, targets)
    print(f"NIFMultiScale MSE on high-freq wave: {mse:.3e}")
    return mse


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, args.batch_size, device=args.device)
