"""The port's convergence anchor: tutorial 1's recipe reaches the JAX
package's accuracy bar on the CPU.

The recipe of ``tests/test_convergence.py``: tutorial 1's model on the port's
``TravelingWave``, the port's ``Trainer`` with ``optimizers.adam(2e-3)`` for
1500 epochs of batch 512, then ``LBFGS(reg=False).minimize(rounds=2,
max_iter=1000, dtype="float64")``; after the cast back to float32 the MSE
must be below 5e-4. It starts from the JAX package's init at
``jax.random.key(0)`` (carried across by ``from_jax_params``), the start
point the JAX anchor calibrated, and the trainer draws its batches from the
same numpy seed as the JAX ``Trainer``.

The full recipe takes minutes on one CPU worker, so it is marked ``slow``;
the quick suite keeps its trend: 600 Adam epochs take the MSE below 0.05,
and 50 float64 L-BFGS iterations lower it further.
"""
import jax
import numpy as np
import pytest
import torch

import nif_tpu
import nif_tpu_torch
from nif_tpu_torch import optimizers
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.demo import TravelingWave
from nif_tpu_torch.training import Trainer

torch.set_num_threads(1)

CFG_S = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2, "activation": "swish"}
CFG_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2, "activation": "swish"}


def _mse(model, inputs, targets):
    with torch.no_grad():
        pred = model.apply(inputs).numpy()
    return float(np.mean(np.square(pred - targets)))


def _adam_leg(epochs):
    """Tutorial 1's model from the JAX init at key 0, after ``epochs`` of the
    port's ``Trainer`` with Adam(2e-3) at batch 512: ``(model, inputs,
    targets, mse)``."""
    tw = TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    model = nif_tpu_torch.NIF(CFG_S, CFG_P, device="cpu")
    trainer = Trainer(model, optimizers.adam(2e-3))
    state = trainer.init(0)
    jax_params = nif_tpu.NIF(CFG_S, CFG_P).init(jax.random.key(0))
    from_jax_params(model, jax.tree_util.tree_map(np.asarray, jax_params))
    state = trainer.fit(state, inputs, targets, epochs=epochs, batch_size=512)
    return model, inputs, targets, trainer.evaluate(state, inputs, targets)


@pytest.mark.slow
def test_tutorial1_anchor_adam_then_lbfgs():
    model, inputs, targets, mse_adam = _adam_leg(1500)
    assert mse_adam < 0.05, f"Adam leg MSE {mse_adam} after 1500 epochs"

    opt = optimizers.LBFGS(model, inputs=inputs, targets=targets, reg=False)
    opt.minimize(rounds=2, max_iter=1000, dtype="float64")
    optimizers.cast_parameters(model, "float32")
    mse = _mse(model, inputs, targets)
    assert mse < 5e-4, f"tutorial-1 anchor MSE {mse:.2e} (Adam leg {mse_adam:.2e})"


def test_tutorial1_trend_adam_then_lbfgs():
    model, inputs, targets, mse_adam = _adam_leg(600)
    assert mse_adam < 0.05, f"Adam leg MSE {mse_adam} after 600 epochs"
    opt = optimizers.LBFGS(model, inputs=inputs, targets=targets, reg=False)
    opt.minimize(max_iter=50, dtype="float64")
    optimizers.cast_parameters(model, "float32")
    mse = _mse(model, inputs, targets)
    assert mse < mse_adam, f"L-BFGS left the MSE at {mse:.2e} (Adam leg {mse_adam:.2e})"
