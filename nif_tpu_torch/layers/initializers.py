"""Weight initializers matching the reference's distributions
(counterpart of ``nif_tpu/layers/initializers.py``).

Each function draws from a ``torch.Generator`` on the generator's device and
returns the result on ``device``. The numbers differ from ``jax.random``'s
for the same seed; the distributions are the same:

* ``truncated_normal_init`` — N(0, stddev) truncated at +/- 2 stddev.
* ``siren_first_init`` / ``siren_hidden_init`` — SIREN position-dependent
  uniform ranges.
* ``hyper_linear_init`` — the hypernetwork head init whose *bias* is scaled
  per segment so the generated ShapeNet weights start in the SIREN regime.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "truncated_normal_init",
    "siren_first_init",
    "siren_hidden_init",
    "hyper_linear_init",
    "hyper_bias_scales",
]


def _uniform(generator, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return (u * (hi - lo) + lo).to(device)


def truncated_normal_init(generator, shape, stddev: float = 0.1,
                          dtype=torch.float32, device=None):
    """TF-style TruncatedNormal: N(0, stddev) truncated at +/- 2 stddev."""
    w = torch.empty(shape, dtype=dtype, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * stddev).to(device)


def siren_first_init(generator, fan_in: int, fan_out: int,
                     dtype=torch.float32, device=None):
    """SIREN first-layer init: W ~ U(+/- 1/fan_in), b ~ U(+/- 1/sqrt(fan_in))."""
    w = _uniform(generator, (fan_in, fan_out), -1.0 / fan_in, 1.0 / fan_in,
                 dtype, device)
    lim_b = 1.0 / np.sqrt(fan_in)
    b = _uniform(generator, (fan_out,), -lim_b, lim_b, dtype, device)
    return w, b


def siren_hidden_init(generator, fan_in: int, fan_out: int, omega_0: float,
                      dtype=torch.float32, device=None):
    """SIREN hidden/bottleneck init: W ~ U(+/- sqrt(6/fan_in)/omega_0),
    b ~ U(+/- 1/sqrt(fan_in))."""
    lim_w = np.sqrt(6.0 / fan_in) / omega_0
    w = _uniform(generator, (fan_in, fan_out), -lim_w, lim_w, dtype, device)
    lim_b = 1.0 / np.sqrt(fan_in)
    b = _uniform(generator, (fan_out,), -lim_b, lim_b, dtype, device)
    return w, b


def hyper_bias_scales(
    num_outputs: int,
    num_weight_first: int,
    num_weight_hidden: int,
    num_weight_last: int,
    input_dim: int,
    width: int,
    omega_0: float,
) -> np.ndarray:
    """Per-output bias init half-range for the hypernetwork head.

    Segment layout (matching the ShapeNet weight-vector slicing order):
    [first-layer W | hidden Ws | last W | all biases].
    """
    scale = np.ones((num_outputs,), dtype=np.float64)
    i0 = num_weight_first
    i1 = i0 + num_weight_hidden
    i2 = i1 + num_weight_last
    scale[:i0] /= input_dim
    scale[i0:i1] *= np.sqrt(6.0 / width) / omega_0
    scale[i1:i2] *= np.sqrt(6.0 / (width + width))
    scale[i2:] /= width
    return scale


def hyper_linear_init(
    generator,
    fan_in: int,
    fan_out: int,
    weight_factor: float,
    num_weight_first: int,
    num_weight_hidden: int,
    num_weight_last: int,
    input_dim: int,
    width: int,
    omega_0: float,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hypernetwork head init.

    W ~ U(+/- sqrt(6/fan_in) * weight_factor); b ~ U(-s_j, s_j) where s_j is
    the per-segment scale from :func:`hyper_bias_scales`.
    """
    lim_w = np.sqrt(6.0 / fan_in) * weight_factor
    w = _uniform(generator, (fan_in, fan_out), -lim_w, lim_w, dtype, device)
    scale = torch.as_tensor(
        hyper_bias_scales(fan_out, num_weight_first, num_weight_hidden,
                          num_weight_last, input_dim, width, omega_0),
        dtype=dtype, device=device,
    )
    b = _uniform(generator, (fan_out,), -1.0, 1.0, dtype, device) * scale
    return w, b
