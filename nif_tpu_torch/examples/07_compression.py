"""Tutorial 7 — NIF compression: pruning and quantization.

Covers (reference tutorial/7_model_pruning_and_quantization.ipynb,
README.md:231-232): low-magnitude pruning of the ParameterNet during
training (``MagnitudePruning`` wraps the optimizer) and int8 post-training
quantization, with accuracy/size reporting.

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np

import nif_tpu_torch
from nif_tpu_torch.compression import (
    MagnitudePruning,
    dequantize_params,
    quantize_params,
    quantized_size_bytes,
    sparsity,
)
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.optimizers import adam
from nif_tpu_torch.training import Trainer


def main(epochs=2000, final_sparsity=0.5, seed=0, device="cuda"):
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

    # --- train with a gradual magnitude-pruning schedule ---
    steps_per_epoch = -(-len(inputs) // 512)  # ceil: tail batches train
    tx = MagnitudePruning(
        adam(2e-3), final_sparsity=final_sparsity,
        begin_step=steps_per_epoch * epochs // 4,
        end_step=steps_per_epoch * epochs * 3 // 4,
    )
    trainer = Trainer(model, tx)
    state = trainer.init(seed)
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)
    mse = trainer.evaluate(state, inputs, targets)
    print(f"pruned model: sparsity {sparsity(state.params):.2%}, MSE {mse:.3e}")

    # --- post-training int8 quantization ---
    qp = quantize_params(state.params)
    qbytes, fbytes = quantized_size_bytes(qp)
    dq = dequantize_params(qp)
    trained = {k: v.clone() for k, v in model.param_tree().state_dict().items()}
    from_jax_params(model, dq)  # evaluate the dequantized weights in place
    mse_q = trainer.evaluate(state, inputs, targets)
    model.param_tree().load_state_dict(trained)
    print(f"quantized: {fbytes} B -> {qbytes} B "
          f"({fbytes / qbytes:.1f}x), MSE {mse_q:.3e}")
    return mse, mse_q


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--final-sparsity", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.epochs, args.final_sparsity, device=args.device)
