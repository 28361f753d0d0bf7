"""The flagship model, its MSE, Sobolev and Hessian train steps, the NIF-linear
train step and a device timer, shared by the scripts that drive the port on a
card (``chip_smoke.py``, ``scripts/port_serving_profile.py``,
``scripts/port_train_profile.py``).

The flagship is the JAX package's ``bench.py`` model: NIFMultiScale with a
SIREN ShapeNet 3 -> 1 of width 128 and two hidden layers (omega_0 = 30) and
an ``mlp_hyper`` ParameterNet 4 -> 128 x 2 (swish, latent 128), so
po = 33665, under ``mixed_bfloat16``. The NIF-linear model is the JAX bench's
too (``bench.py:289-317``): a SIREN trunk 3 -> 128 x 2 -> bottleneck 128
(so = 1, K = 128; omega_0 = 30, weight_init_factor 1.0) contracted with the
same ParameterNet's latent output, under ``mixed_bfloat16``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["FLAGSHIP_SHAPE", "FLAGSHIP_PNET", "FLAGSHIP_POLICY", "FLAGSHIP_TRAIN_LR",
           "LINEAR_SHAPE", "cuda_ms", "flagship_hessian_step", "flagship_linear_step",
           "flagship_sobolev_step", "flagship_train_step"]

FLAGSHIP_SHAPE = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
                  "activation": "sine", "use_resblock": False, "omega_0": 30.0,
                  "connectivity": "full", "weight_init_factor": 0.01}
FLAGSHIP_PNET = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
                 "activation": "swish", "use_resblock": False, "omega_0": 30.0}
FLAGSHIP_POLICY = "mixed_bfloat16"
FLAGSHIP_TRAIN_LR = 1e-4
LINEAR_SHAPE = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
                "activation": "sine", "use_resblock": False, "omega_0": 30.0,
                "connectivity": "last_layer", "weight_init_factor": 1.0}


def flagship_train_step(G: int = 32, P: int = 32768, device="cuda", seed: int = 0):
    """The JAX bench's train step (``bench.py:131-150``): the flagship model
    with random weights from ``seed`` under a ``GroupedTrainer`` with Adam
    (lr 1e-4), and the bench's random batch, ``t [G, 4]``, ``x [G, P, 3]``,
    ``u [G, P, 1]`` from ``np.random.default_rng(0)``, as float32 tensors on
    ``device``. Returns ``(trainer, state, (t, x, u))``; one step is
    ``trainer.step(state, t, x, u)``."""
    return _flagship(G, P, device, seed, sobolev=False)


def flagship_sobolev_step(G: int = 32, P: int = 32768, device="cuda", seed: int = 0):
    """The JAX bench's Sobolev step (``bench.py:480-491``): as
    :func:`flagship_train_step`, with a random ``target_jac [G, P, 1, 3]``
    drawn after the batch. Returns ``(trainer, state, (t, x, u,
    target_jac))``; one step is ``trainer.step(state, t, x, u,
    target_jac=target_jac)``."""
    return _flagship(G, P, device, seed, sobolev=True)


def flagship_hessian_step(G: int = 32, P: int = 32768, device="cuda", seed: int = 0):
    """The JAX bench's Hessian step (``bench.py:493-512``): as
    :func:`flagship_sobolev_step`, then a random ``ht0 [G, P, 1, 3, 3]``
    symmetrized as ``0.5 (ht0 + ht0^T)``, under a trainer with ``w_jac=0.1``
    and ``w_hess=0.01``. Returns ``(trainer, state, (t, x, u, target_jac,
    target_hess))``; one step is ``trainer.step(state, t, x, u,
    target_jac=target_jac, target_hess=target_hess)``."""
    return _flagship(G, P, device, seed, sobolev=True, hessian=True)


def flagship_linear_step(G: int = 32, P: int = 32768, device="cuda", seed: int = 1):
    """The JAX bench's NIF-linear train step (``bench.py:289-317``): the
    NIF-linear model (``LINEAR_SHAPE``, ``FLAGSHIP_PNET``) with random
    weights from ``seed`` under a ``GroupedTrainer`` with Adam (lr 1e-4), on
    the batch of :func:`flagship_train_step`. Returns ``(trainer, state, (t,
    x, u))``; one step is ``trainer.step(state, t, x, u)`` (K4 on the card)."""
    return _flagship(G, P, device, seed, sobolev=False, linear=True)


def _flagship(G, P, device, seed, sobolev, hessian=False, linear=False):
    from ..models import NIFMultiScale, NIFMultiScaleLastLayerParameterized
    from ..training import GroupedTrainer

    cls, shape = ((NIFMultiScaleLastLayerParameterized, LINEAR_SHAPE) if linear else
                  (NIFMultiScale, FLAGSHIP_SHAPE))
    model = cls(shape, FLAGSHIP_PNET, FLAGSHIP_POLICY, device=device, seed=seed)
    weights = dict(w_jac=0.1, w_hess=0.01) if hessian else {}
    trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=FLAGSHIP_TRAIN_LR),
                             **weights)
    state = trainer.init(seed)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((G, 4)), rng.standard_normal((G, P, 3)),
             rng.standard_normal((G, P, 1)))
    if sobolev:
        batch += (rng.standard_normal((G, P, 1, 3)),)
    if hessian:
        ht0 = rng.standard_normal((G, P, 1, 3, 3)).astype(np.float32)
        batch += (0.5 * (ht0 + ht0.transpose(0, 1, 2, 4, 3)),)
    return trainer, state, tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                                 for a in batch)


def cuda_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls
    after ``warmup`` calls, from CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
