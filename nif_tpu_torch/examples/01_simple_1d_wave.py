"""Tutorial 1 — Hello world: vanilla NIF on a 1-D traveling wave.

Covers (reference tutorial/1_simple_1d_wave.ipynb, README.md:201-205):
  * building ``nif_tpu_torch.NIF`` from reference-style cfg dicts
  * training with the point-wise ``Trainer`` (eager PyTorch: no fused kernel
    serves the point-wise layout)
  * checkpoint save / restore (``Checkpointer``, ``torch.save`` files)
  * L-BFGS fine-tuning on the model's own parameters (``optimizers.LBFGS``:
    the two-loop recursion on the device, optax's zoom line search)

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np
import torch

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.optimizers import LBFGS, adam
from nif_tpu_torch.training import Checkpointer, LossPrintingCallback, Trainer

cfg_shape_net = {
    "input_dim": 1,
    "output_dim": 1,
    "units": 30,
    "nlayers": 2,
    "activation": "swish",
}
cfg_parameter_net = {
    "input_dim": 1,
    "latent_dim": 1,
    "units": 30,
    "nlayers": 2,
    "activation": "swish",
}


def main(epochs=5000, batch_size=512, lbfgs_iters=1000, ckpt_dir=None,
         mixed_policy="float32", seed=0, device="cuda"):
    tw = TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)  # [t, x]
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIF(cfg_shape_net, cfg_parameter_net, mixed_policy, device=device)
    trainer = Trainer(model, adam(2e-3))
    state = trainer.init(seed)
    state = trainer.fit(
        state, inputs, targets, epochs=epochs, batch_size=batch_size,
        callbacks=[LossPrintingCallback(every=max(epochs // 10, 1))],
    )
    mse = trainer.evaluate(state, inputs, targets)
    print(f"Adam training MSE: {mse:.3e}")

    # checkpoint + config persistence (README.md:179-195 equivalent)
    if ckpt_dir:
        model.save_config(f"{ckpt_dir}/config.json")
        ckpt = Checkpointer(ckpt_dir)
        ckpt.save(epochs, model.param_tree().state_dict())
        ckpt.wait()
        trained = {k: v.clone() for k, v in model.param_tree().state_dict().items()}
        with torch.no_grad():  # overwrite in place, then restore
            for _, p in model.param_items():
                p.add_(1.0)
        model.param_tree().load_state_dict(ckpt.restore(map_location=model.device))
        same = all(torch.equal(trained[k], v) for k, v in model.param_tree().state_dict().items())
        if not (same and trainer.evaluate(state, inputs, targets) == mse):
            raise AssertionError("the restored checkpoint differs from the trained parameters")
        print(f"checkpoint round-trip OK at {ckpt_dir}")

    # L-BFGS fine-tune (README.md:51-69 equivalent), in place on the model
    if lbfgs_iters:
        tuner = LBFGS(model, inputs=inputs, targets=targets)
        tuner.minimize(rounds=1, max_iter=lbfgs_iters)
        mse = trainer.evaluate(state, inputs, targets)
        print(f"after L-BFGS fine-tune MSE: {mse:.3e}")
    return mse


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--lbfgs-iters", type=int, default=1000)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mixed-policy", default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, args.batch_size, args.lbfgs_iters, args.ckpt_dir,
         args.mixed_policy, device=args.device)
