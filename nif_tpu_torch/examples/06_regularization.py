"""Tutorial 6 — Multi-scale NIF with L1/L2 regularization.

Covers (reference tutorial/6_revisit_multi_scale_NIF_with_L1_L2_
regularization.ipynb, README.md:223-229): kernel/bias L1 or L2 penalties on
the ParameterNet, configured exactly like the reference (``l1_reg`` /
``l2_reg`` keys in ``cfg_parameter_net``) and folded into the loss by the
trainer automatically.

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWaveHighFreq
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.training import Trainer


def run_one(reg_kind, reg_val, epochs, seed=0, device="cuda"):
    cfg_s = {
        "connectivity": "full", "input_dim": 1, "output_dim": 1, "units": 30,
        "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
        "activation": "sine", "use_resblock": False,
    }
    cfg_p = {
        "input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
        "activation": "swish", "use_resblock": False, "omega_0": 30.0,
    }
    if reg_kind:
        cfg_p[reg_kind] = reg_val
    tw = TravelingWaveHighFreq()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, device=device)
    trainer = Trainer(model, adam(1e-4))
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)
    mse = trainer.evaluate(state, inputs, targets)
    print(f"{reg_kind or 'no reg':8s} ({reg_val}): data MSE {mse:.3e}")
    return mse


def main(epochs=1000, device="cuda"):
    results = {
        "none": run_one(None, 0, epochs, device=device),
        "l2": run_one("l2_reg", 1e-5, epochs, device=device),
        "l1": run_one("l1_reg", 1e-5, epochs, device=device),
    }
    # The reference's lesson (README.md:223-229): regularization does not fix
    # the high-frequency interpolation failure — check the numbers yourself.
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, device=args.device)
