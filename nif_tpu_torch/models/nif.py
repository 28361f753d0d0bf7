"""NIF and NIFMultiScale as ``nn.Module``s (counterpart of
``nif_tpu/models/nif.py``).

Each model holds its configuration and its ParameterNet's parameters:

* ``apply(inputs)``          — point-wise forward on ``[B, pi_dim + si_dim]``.
* ``apply_grouped(t, x)``    — grouped forward: the P points of a snapshot
  share one generated weight vector, so the ShapeNet runs as batched
  matmuls, through the fused CUDA kernel on the card (the serving path).
* ``p_to_w / p_to_lr / lr_to_w / x_to_u_given_w(_grouped)`` — subnetwork
  extraction for ROM workflows.
* ``save_config`` / ``from_config`` — the JAX package's JSON schema.

A model lives on one device, CUDA unless the caller passes ``device="cpu"``
(asking for CUDA where there is none raises). Inputs may be numpy arrays or
tensors; they are cast to the policy's compute dtype on the model's device.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import (
    NIFConfig,
    ParameterNetConfig,
    ShapeNetConfig,
    shapenet_param_count,
)
from ..ops.fused_shapenet import (
    fused_unsupported_reason,
    kernel_geometry,
    shapenet_grouped_fused,
)
from ..ops.shapenet import shapenet_grouped, shapenet_pointwise
from ..utils.policy import get_policy
from .parameter_net import ParameterNet, parameter_net_kind

__all__ = ["NIF", "NIFMultiScale", "resolve_device"]

logger = logging.getLogger("nif_tpu_torch")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _as_shape_cfg(cfg) -> ShapeNetConfig:
    return cfg if isinstance(cfg, ShapeNetConfig) else ShapeNetConfig.from_dict(cfg)


def _as_param_cfg(cfg) -> ParameterNetConfig:
    return cfg if isinstance(cfg, ParameterNetConfig) else ParameterNetConfig.from_dict(cfg)


class NIF(nn.Module):
    """Vanilla Neural Implicit Flow.

    ParameterNet: Dense -> shortcut blocks -> bottleneck -> Dense(po_dim).
    ShapeNet: per-point MLP with additive shortcuts, weights generated by the
    ParameterNet.
    """

    #: which shapenet chain to run — overridden by NIFMultiScale.
    shapenet_variant = "vanilla"
    #: parameter net kind — overridden by NIFMultiScale.
    _vanilla_pnet = True

    def __init__(self, cfg_shape_net, cfg_parameter_net, mixed_policy="float32",
                 device=None, seed: int = 0):
        super().__init__()
        self.cfg_shape_net = _as_shape_cfg(cfg_shape_net)
        self.cfg_parameter_net = _as_param_cfg(cfg_parameter_net)
        if self.shapenet_variant == "vanilla" and self.cfg_shape_net.use_resblock:
            # The vanilla chain never reads use_resblock; normalize it away
            # so a config reused from a multiscale run doesn't inflate po_dim
            # with dead weights.
            self.cfg_shape_net = dataclasses.replace(
                self.cfg_shape_net, use_resblock=False
            )
        self.policy = get_policy(mixed_policy)
        self.mixed_policy = self.policy.name
        self.device = resolve_device(device)

        self.si_dim = self.cfg_shape_net.input_dim
        self.so_dim = self.cfg_shape_net.output_dim
        self.n_sx = self.cfg_shape_net.units
        self.l_sx = self.cfg_shape_net.nlayers
        self.pi_dim = self.cfg_parameter_net.input_dim
        self.pi_hidden = self.cfg_parameter_net.latent_dim
        self.n_st = self.cfg_parameter_net.units
        self.l_st = self.cfg_parameter_net.nlayers
        self.po_dim = shapenet_param_count(self.cfg_shape_net, self.pi_hidden)
        self.pnet_kind = parameter_net_kind(self.cfg_parameter_net, self._vanilla_pnet)
        self._announced_paths = set()
        self.init(seed)

    # ---------------------------------------------------------------- init
    def init(self, seed: int = 0) -> "NIF":
        """(Re)draw every parameter from ``seed``. The draw runs on a CPU
        generator, so one seed gives the same weights on every device."""
        generator = torch.Generator(device="cpu").manual_seed(seed)
        self.pnet = ParameterNet(
            self.cfg_parameter_net, self.cfg_shape_net, self.po_dim,
            self.pnet_kind, generator, dtype=self.policy.param_dtype,
            device=self.device,
        )
        return self

    def _compute(self, a) -> torch.Tensor:
        return self.policy.cast_to_compute(a, device=self.device)

    # --------------------------------------------------------------- apply
    def apply(self, inputs, return_latent: bool = False):
        """Point-wise forward pass.

        Args:
          inputs: ``[B, pi_dim + si_dim]`` rows of ``[t/mu..., x...]``.
          return_latent: also return the bottleneck activation.

        Returns:
          ``[B, so_dim]`` in the param dtype (and optionally the
          ``[B, pi_hidden]`` latent).

        This shadows ``nn.Module.apply(fn)``; call that as
        ``nn.Module.apply(model, fn)``.
        """
        inputs = self._compute(inputs)
        t = inputs[..., : self.pi_dim]
        x = inputs[..., self.pi_dim: self.pi_dim + self.si_dim]
        wb, latent = self.pnet(t)
        u = shapenet_pointwise(wb, x, self.cfg_shape_net, self.shapenet_variant)
        u = u.to(self.policy.param_dtype)
        return (u, latent) if return_latent else u

    def forward(self, inputs):
        return self.apply(inputs)

    def apply_grouped(self, t, x, fused: Optional[bool] = None):
        """Grouped forward pass — the serving fast path.

        Args:
          t: ``[G, pi_dim]`` parameters, one row per snapshot/group.
          x: ``[G, P, si_dim]`` coordinates, P points per group.
          fused: run the ShapeNet through K1 (the CUDA kernel on the card,
            its plain version on the CPU). Default (None): fused when the
            tensors are on CUDA, the compute dtype is f32 or bf16 and the
            config is supported; eager otherwise. ``False`` runs eager.

        Returns:
          ``[G, P, so_dim]`` in the param dtype.

        Raises:
          RuntimeError: on the fused CUDA path when gradients are needed. K1
            has no backward until K3 (the fused backward) is ported: call
            under ``torch.inference_mode()``, or pass ``fused=False`` for
            eager autograd.
        """
        t = self._compute(t)
        x = self._compute(x)
        wb, _ = self.pnet(t)
        if fused is None:
            self._announce_path(x.shape[1])
            fused = self.fast_path_info(x.shape[1])["path"] == "fused"
            if fused and (wb.requires_grad or x.requires_grad):
                raise RuntimeError(
                    "apply_grouped: the fused CUDA forward (K1) has no backward "
                    "until K3, the fused backward, is ported; call it under "
                    "torch.inference_mode(), or pass fused=False for eager autograd"
                )
        if fused:
            u = shapenet_grouped_fused(wb, x, self.cfg_shape_net, self.shapenet_variant)
        else:
            u = shapenet_grouped(wb, x, self.cfg_shape_net, self.shapenet_variant)
        return u.to(self.policy.param_dtype)

    # ------------------------------------------------ fast-path observability
    def fast_path_info(self, P: int) -> Dict[str, Any]:
        """Which path a ``[G, P, ...]`` batch takes under auto selection:
        ``{"path": "fused"|"eager", "tile": int|None, "reason": str|None}``.
        ``tile`` is the kernel's points per block; ``reason`` explains an
        eager fallback — a config the kernel can't take, an awkward P, an f64
        compute dtype, or simply not running on CUDA."""
        reason = fused_unsupported_reason(self.cfg_shape_net, self.shapenet_variant, P,
                                          self.device)
        if reason is None and self.policy.compute_dtype not in (torch.float32,
                                                                torch.bfloat16):
            reason = (f"compute dtype {self.policy.compute_dtype} (the kernel "
                      f"takes float32 or bfloat16)")
        if reason is None and self.device.type != "cuda":
            return {"path": "eager", "tile": None,
                    "reason": f"not on CUDA (device {str(self.device)!r})"}
        tile = kernel_geometry(self.cfg_shape_net)[0] if reason is None else None
        return {"path": "fused" if reason is None else "eager",
                "tile": tile, "reason": reason}

    def _announce_path(self, P: int) -> None:
        """One-time (per model instance and P) log of the chosen grouped
        path. Config-caused eager fallbacks log at WARNING; running off CUDA
        is normal and logs at DEBUG."""
        if P in self._announced_paths:
            return
        self._announced_paths.add(P)
        info = self.fast_path_info(P)
        if info["path"] == "fused":
            logger.info(
                "grouped fast path: fused CUDA forward kernel "
                "(P=%d, point tile %s)", P, info["tile"],
            )
        elif info["reason"].startswith("not on CUDA"):
            logger.debug("grouped path: eager (%s)", info["reason"])
        else:
            logger.warning(
                "grouped path FALLING BACK to eager for P=%d: %s. The fused "
                "kernel is the serving fast path — see PERF.md.", P, info["reason"],
            )

    # ------------------------------------------------- subnetwork extraction
    def p_to_w(self, t):
        """(t, mu) -> flattened ShapeNet weight vector."""
        wb, _ = self.pnet(self._compute(t))
        return wb

    def p_to_lr(self, t):
        """(t, mu) -> latent representation."""
        return self.pnet.latent(self._compute(t))

    def lr_to_w(self, lr):
        """latent -> flattened ShapeNet weight vector."""
        return self.pnet.head(self._compute(lr))

    def x_to_u_given_w(self, x, wb):
        """coords + weight vector -> field, point-wise."""
        u = shapenet_pointwise(self._compute(wb), self._compute(x),
                               self.cfg_shape_net, self.shapenet_variant)
        return u.to(self.policy.param_dtype)

    def x_to_u_given_w_grouped(self, x, wb):
        """Grouped variant: ``x [G, P, si]``, ``wb [G, po]`` -> ``[G, P, so]``."""
        u = shapenet_grouped(self._compute(wb), self._compute(x),
                             self.cfg_shape_net, self.shapenet_variant)
        return u.to(self.policy.param_dtype)

    # ------------------------------------------------------------- config IO
    def save_config(self, filename: str = "config.json") -> None:
        """The JAX package's (and the reference's) JSON schema."""
        NIFConfig(
            shape_net=self.cfg_shape_net,
            parameter_net=self.cfg_parameter_net,
            mixed_policy=self.mixed_policy,
        ).save(filename)

    @classmethod
    def from_config(cls, filename: str, device=None, seed: int = 0):
        cfg = NIFConfig.load(filename)
        return cls(cfg.shape_net, cfg.parameter_net, cfg.mixed_policy,
                   device=device, seed=seed)


class NIFMultiScale(NIF):
    """SIREN-based multi-scale NIF.

    ParameterNet is a SIREN stack (activation='sine') or an MLP stack, ending
    in the SIREN-aware hypernetwork head; ShapeNet is a sine-activated
    per-sample MLP, optionally with resblocks.
    """

    shapenet_variant = "siren"
    _vanilla_pnet = False

    def __init__(self, cfg_shape_net, cfg_parameter_net, mixed_policy="float32",
                 device=None, seed: int = 0):
        cfg_s = _as_shape_cfg(cfg_shape_net)
        if cfg_s.connectivity not in ("full", "last_layer"):
            raise ValueError("cfg_shape_net missing correct `connectivity`")
        if cfg_s.connectivity == "last_layer" and type(self) is NIFMultiScale:
            raise ValueError(
                "connectivity='last_layer' needs "
                "NIFMultiScaleLastLayerParameterized (the phi(x)·a + b "
                "model); plain NIFMultiScale only runs the full generated "
                "chain"
            )
        super().__init__(cfg_s, cfg_parameter_net, mixed_policy, device=device, seed=seed)
