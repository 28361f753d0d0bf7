"""nif_tpu_torch — the PyTorch/CUDA port of ``nif_tpu`` for NVIDIA Hopper.

A second package beside ``nif_tpu``, which stays as the reference it is held
against. It mirrors ``nif_tpu``'s module tree and public names; inside it is
PyTorch: ``nn.Module`` models, plain tensor functions for the ShapeNet ops,
``torch.Generator`` init, and hand-written CUDA kernels under ``csrc/`` in
place of the Pallas TPU kernels, built by ``nvcc`` on first use.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Serving: ``NIF``/``NIFMultiScale``/``NIFMultiScaleLastLayerParameterized``
(NIF-linear) construction, init, point-wise and grouped forward, subnetwork
extraction, config IO, ``serving.predict``/``predict_grouped`` through the
fused forward kernel, NIF-linear's ``predict_shared_mesh`` (float32 or int8),
and ``serving.export_apply``/``load_exported`` on ``torch.export`` (the fused
forward kernel a registered op, ``torch.ops.nif_tpu_torch.shapenet_fwd``).
Compression: magnitude pruning (``compression.MagnitudePruning`` over any
optimizer), int8 post-training quantization and NIF-linear's int8 ROM decode.
Training: ``NIF.mse_value_and_grad`` through the fused train kernel (NIF-linear
through its own fused train kernel),
``NIF.sobolev_value_and_grad`` (value and Jacobian targets) through the fused
Sobolev train kernel, ``regularization_loss``, and
``training.GroupedTrainer`` (``step``, ``fit`` with uniform or residual
point sampling, the device-resident ``fit_resident``, replayed as CUDA graphs
on the card, ``evaluate``, ``evaluate_sobolev``, ``init_or_restore``) and the
point-wise ``training.Trainer``, with callbacks and checkpoints;
``optimizers`` (Adam, the AdaBelief forms, Lion, gradient centralization,
the warmup + decay schedule, and L-BFGS fine-tuning, point-wise and grouped,
whose grouped objective runs the fused train kernels); ``data``
(``PointWiseData``, the sharded and grouped streaming datasets with the
native reader, and ``prefetch_to_device``) and ``demo`` (the analytic demo
datasets). Derivatives:
``ops.output_and_jacobian_grouped`` through the fused Jacobian kernel, and
the eager ``torch.func`` derivatives and Sobolev losses of ``ops``.
Parallelism: ``parallel`` (one rank a device on ``torch.distributed``: data
parallelism over a ``DeviceMesh``'s batch axes, the row-parallel
hypernetwork head over its ``model`` axis, ZeRO-1, and the multi-host
worker). The command line: ``python -m nif_tpu_torch train|eval|export``
(``cli.py``); tracing, step timing and NaN checks in ``utils.profiling``.
"""
from .__about__ import __version__
from . import compression
from . import convert
from . import data
from . import demo
from . import layers
from . import models
from . import ops
from . import optimizers
from . import parallel
from . import serving
from . import training
from . import utils
from .config import NIFConfig, ParameterNetConfig, ShapeNetConfig
from .models import NIF, NIFMultiScale, NIFMultiScaleLastLayerParameterized
from .utils.policy import Policy, get_policy

__all__ = [
    "__version__",
    "NIF",
    "NIFMultiScale",
    "NIFMultiScaleLastLayerParameterized",
    "NIFConfig",
    "ShapeNetConfig",
    "ParameterNetConfig",
    "Policy",
    "get_policy",
    "compression",
    "convert",
    "data",
    "demo",
    "layers",
    "models",
    "ops",
    "optimizers",
    "parallel",
    "serving",
    "training",
    "utils",
]
