"""Tutorial 10 — serving: batched predict + ahead-of-time export.

Train briefly, then:
  * run padded-batch inference over an arbitrary number of points;
  * export the forward pass to a ``torch.export`` artifact and reload it
    without the model-building code (``serving.load_exported``). The
    artifact runs on the device of the model it came from.

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse
import os
import tempfile

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.serving import export_apply, load_exported, predict
from nif_tpu_torch.training import Trainer
from nif_tpu_torch.utils import rel_l2


def main(epochs=300, seed=0, out_dir=None, device="cuda"):
    out_dir = out_dir or tempfile.mkdtemp(prefix="nif_export_")
    tw = TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)

    model = nif_tpu_torch.NIF(
        {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"},
        {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
         "activation": "swish"},
        device=device,
    )
    trainer = Trainer(model, adam(2e-3))
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)

    # --- batched inference over "any" number of points ---
    pred = predict(model, inputs, batch_size=512)
    print(f"predict: {pred.shape}, rel-L2 {float(rel_l2(pred, targets)):.4f}")

    # --- ahead-of-time export: a torch.export artifact, reloaded as a callable ---
    path = os.path.join(out_dir, "model.pt2")
    export_apply(model, batch_size=512, path=path)
    loaded = load_exported(path)
    out = loaded(inputs[:512]).cpu().numpy()
    agree = np.allclose(out, pred[:512], rtol=1e-5, atol=1e-6)
    print(f"exported {os.path.getsize(path)} bytes -> reloaded, agrees: {agree}")
    if not agree:
        raise AssertionError("the reloaded artifact departs from predict")
    return float(rel_l2(pred, targets))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, out_dir=args.out_dir, device=args.device)
