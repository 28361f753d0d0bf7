"""NIF and NIFMultiScale as ``nn.Module``s (counterpart of
``nif_tpu/models/nif.py``).

Each model holds its configuration and its ParameterNet's parameters:

* ``apply(inputs)``          — point-wise forward on ``[B, pi_dim + si_dim]``.
* ``apply_grouped(t, x)``    — grouped forward: the P points of a snapshot
  share one generated weight vector, so the ShapeNet runs as batched
  matmuls, through the fused CUDA kernel on the card (the serving path),
  differentiable through the fused backward kernel.
* ``mse_value_and_grad(t, x, u)`` — the grouped weighted-MSE loss and its
  gradient, through the fused train kernel on the card (the train path).
* ``sobolev_value_and_grad(t, x, u, target_jac=..., target_hess=...)`` —
  the grouped Sobolev loss (values, Jacobians and Hessians) and its
  gradient, through the fused Sobolev train kernel (K6), or with Hessian
  targets the fused Hessian train kernel (K8), on the card.
* ``regularization_loss`` — the configured L1/L2, activity and
  latent-Jacobian terms.
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
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
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
    shapenet_mse_grads,
)
from ..ops.derivatives import sobolev_loss_grouped
from ..ops.fused_derivatives import (
    _device_constant,
    derivative_geometry,
    shapenet_sobolev_grads,
    sobolev_fused_unsupported_reason,
)
from ..ops.fused_hessian import (
    _hess_pairs,
    hessian_fused_unsupported_reason,
    hessian_geometry,
    shapenet_hessian_grads,
)
from ..ops.shapenet import shapenet_grouped, shapenet_pointwise
from ..utils.policy import get_policy
from .parameter_net import (ParameterNet, parameter_net_apply, parameter_net_kind,
                            parameter_net_latent, parameter_sum)

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
        self._announced_sobolev_paths = set()
        self.init(seed)

    # ---------------------------------------------------------------- init
    def init(self, seed: int = 0) -> "NIF":
        """(Re)draw every parameter from ``seed``. The draw runs on a CPU
        generator, so one seed gives the same weights on every device."""
        self._init_params(torch.Generator(device="cpu").manual_seed(seed))
        return self

    def _init_params(self, generator: torch.Generator) -> None:
        """Draw the ParameterNet from ``generator``."""
        self.pnet = ParameterNet(
            self.cfg_parameter_net, self.cfg_shape_net, self.po_dim,
            self.pnet_kind, generator, dtype=self.policy.param_dtype,
            device=self.device,
        )

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
          fused: run the ShapeNet through K1, with K3 as its backward under
            autograd (the CUDA kernels on the card, their plain versions on
            the CPU). Default (None): fused when the tensors are on CUDA, the
            compute dtype is f32 or bf16 and the config is supported; eager
            otherwise. ``False`` runs eager.

        Returns:
          ``[G, P, so_dim]`` in the param dtype.
        """
        t = self._compute(t)
        x = self._compute(x)
        wb, _ = self.pnet(t)
        if fused is None:
            self._announce_path(x.shape[1])
            fused = self.fast_path_info(x.shape[1])["path"] == "fused"
        if fused:
            u = shapenet_grouped_fused(wb, x, self.cfg_shape_net, self.shapenet_variant)
        else:
            u = shapenet_grouped(wb, x, self.cfg_shape_net, self.shapenet_variant)
        return u.to(self.policy.param_dtype)

    # ------------------------------------------------ fast-path observability
    def fast_path_info(self, P: int) -> Dict[str, Any]:
        """Which path a ``[G, P, ...]`` batch takes under auto selection:
        ``{"path": "fused"|"eager", "tile": int|None, "reason": str|None}``.
        ``tile`` is the points per block of the K1 the compute dtype runs
        (``k1_variant``); ``reason`` explains an eager fallback — a config
        the kernel can't take, an awkward P, an f64 compute dtype, or simply
        not running on CUDA."""
        cfg, variant, dtype = self.cfg_shape_net, self.shapenet_variant, self.policy.compute_dtype
        reason = fused_unsupported_reason(cfg, variant, P, self.device, dtype)
        return self._path_info(reason, lambda: kernel_geometry(cfg, variant, dtype)[0])

    def _path_info(self, reason: Optional[str], tile_fn) -> Dict[str, Any]:
        """A kernel gate's ``reason`` -> ``{"path", "tile", "reason"}``: the
        kernels also refuse f64 parameters and a compute dtype other than
        f32/bf16, and run only on CUDA; ``tile_fn()`` gives the kernel's
        point tile when it runs."""
        if reason is None and self._any_f64():
            reason = "float64 parameters (the kernels take float32 or bfloat16)"
        if reason is None and self.policy.compute_dtype not in (torch.float32,
                                                                torch.bfloat16):
            reason = (f"compute dtype {self.policy.compute_dtype} (the kernel "
                      f"takes float32 or bfloat16)")
        if reason is None and self.device.type != "cuda":
            return {"path": "eager", "tile": None,
                    "reason": f"not on CUDA (device {str(self.device)!r})"}
        return {"path": "fused" if reason is None else "eager",
                "tile": tile_fn() if reason is None else None, "reason": reason}

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
                "grouped fast path: fused CUDA kernels "
                "(P=%d, point tile %s)", P, info["tile"],
            )
        elif info["reason"].startswith("not on CUDA"):
            logger.debug("grouped path: eager (%s)", info["reason"])
        else:
            logger.warning(
                "grouped path FALLING BACK to eager for P=%d: %s. The fused "
                "kernel is the serving fast path — see PERF.md.", P, info["reason"],
            )

    def _any_f64(self) -> bool:
        """True when any parameter is float64: the kernels are f32/bf16, so
        auto-selection keeps an f64 model (e.g. f64 fine-tuning) eager."""
        return any(p.dtype == torch.float64 for p in self.parameters())

    # ------------------------------------------------------------ training
    def param_items(self) -> List[Tuple[Tuple[str, ...], nn.Parameter]]:
        """``[(path, parameter)]`` in the order of :meth:`parameters`, each
        path a key path of the JAX params tree, e.g.
        ``("pnet", "hidden_0", "dense", "w")``."""
        return [(("pnet",) + tuple(name.split(".")), p)
                for name, p in self.pnet.params.named_parameters()]

    def param_tree(self) -> nn.ModuleDict:
        """Every parameter in one module keyed like the JAX params tree
        (``{"pnet": ...}``; NIF-linear adds ``"snet"``): what a train state
        and its checkpoints carry."""
        return nn.ModuleDict({"pnet": self.pnet.params})

    def _grad_tree(self, grads) -> Dict[str, Any]:
        """Gradients in :meth:`param_items` order -> the JAX params tree's
        nested dicts (the ``to_numpy_params`` layout)."""
        tree: Dict[str, Any] = {}
        for (path, _), g in zip(self.param_items(), grads):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = g
        return tree

    def mse_value_and_grad(self, t, x, u, weight=None, fused: Optional[bool] = None,
                           use_reg: bool = True, reg_weight=None):
        """The grouped weighted-MSE loss and its gradient: ``(loss, grads)``.

        ``t [G, pi]``, ``x [G, P, si]``, ``u [G, P, so]``, ``weight [G, P]``
        (optional) as arrays or tensors. ``loss`` is a 0-dim tensor on the
        model's device (no host sync) and ``grads`` a tree of tensors keyed
        like the JAX params tree (``{"pnet": {"first": {"w", "b"}, ...}}``).

        The fused path runs the ParameterNet forward, then K2 (forward +
        weighted MSE + backward of the ShapeNet in one kernel on the card,
        its plain version on the CPU), then sends ``d_wb`` back through the
        ParameterNet with autograd. The eager path (``fused=False``) is plain
        autograd over ``apply_grouped(fused=False)``. Default (None): fused
        where :meth:`fast_path_info` says so (CUDA, f32/bf16, a supported
        config, no f64 parameter). The configured regularization is added
        (``use_reg``) on both paths; ``reg_weight [G]`` reweights its
        batch-mean rows (see :meth:`regularization_loss`)."""
        params = [p for _, p in self.param_items()]
        u = torch.as_tensor(u, device=self.device)
        weight = None if weight is None else torch.as_tensor(weight, device=self.device)
        if fused is None:
            P = x.shape[1]
            self._announce_path(P)
            fused = self.fast_path_info(P)["path"] == "fused"
        reg = use_reg and self.has_regularization
        if not fused:
            pred = self.apply_grouped(t, x, fused=False)
            err = torch.square(pred - u.to(pred.dtype))
            if weight is not None:
                err = err * weight.unsqueeze(-1).to(pred.dtype)
            loss = torch.mean(err)
            if reg:
                loss = loss + self.regularization_loss(t=t, reg_weight=reg_weight)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            return loss.detach(), self._grad_tree(grads)
        wb, _ = self.pnet(self._compute(t))
        loss, d_wb = shapenet_mse_grads(wb, self._compute(x), u, self.cfg_shape_net,
                                        self.shapenet_variant, weight)
        grads = torch.autograd.grad(wb, params, d_wb)
        if reg:
            reg_loss = self.regularization_loss(t=t, reg_weight=reg_weight)
            reg_grads = torch.autograd.grad(reg_loss, params, allow_unused=True)
            grads = [g if r is None else g + r for g, r in zip(grads, reg_grads)]
            loss = loss + reg_loss.detach()
        return loss, self._grad_tree(grads)

    # ------------------------------------------------------ Sobolev training
    def _derivative_kernel_cfg(self):
        """(cfg, variant) of the chain the fused derivative kernels take:
        the generated ShapeNet chain (NIF-linear: its effective chain)."""
        return self.cfg_shape_net, self.shapenet_variant

    def _derivative_weights(self, t) -> torch.Tensor:
        """The ``[G, po]`` weights of that chain for parameter rows ``t``,
        differentiable in the parameters: the generated weight vector."""
        return self.pnet(self._compute(t))[0]

    def sobolev_path_info(self, P: int, si: int, hess: bool = False) -> Dict[str, Any]:
        """Which path :meth:`sobolev_value_and_grad` takes for ``[G, P, si]``
        batches under auto selection: ``{"path": "fused"|"eager", "tile":
        int|None, "reason": str|None, "kernel": "tc"|"simt"|None}``, the
        Sobolev counterpart of :meth:`fast_path_info`: K6's gate and
        geometry, or with ``hess=True`` (Hessian targets) K8's, and which of
        the kernel's variants runs (the tensor-core or the CUDA-core one)."""
        cfg_k, variant_k = self._derivative_kernel_cfg()
        dtype = self.policy.compute_dtype
        reason = self._sobolev_gate(cfg_k, variant_k, P, si, hess)
        info = self._path_info(reason, lambda: None)
        info["kernel"] = None
        if info["path"] == "fused":
            geo = (hessian_geometry("train", cfg_k, variant_k, 1, P, dtype, si) if hess else
                   derivative_geometry("sobolev", cfg_k, variant_k, 1, P, dtype, si))
            info.update(tile=geo["tile"], kernel=geo["kernel"])
        return info

    def _sobolev_gate(self, cfg_k, variant_k, P: int, si: int, hess: bool) -> Optional[str]:
        """K6's gate, or K8's (Hessian targets), for the kernel variant of
        the compute dtype and the chain."""
        gate = hessian_fused_unsupported_reason if hess else sobolev_fused_unsupported_reason
        return gate(cfg_k, variant_k, P, si, self.device, self.policy.compute_dtype)

    def _announce_sobolev_path(self, P: int, si: int, hess: bool = False) -> None:
        """One-time log of the Sobolev train path for ``[G, P, si]``
        batches (the Sobolev kernels' rules differ from the MSE kernel's)."""
        if (P, si, hess) in self._announced_sobolev_paths:
            return
        self._announced_sobolev_paths.add((P, si, hess))
        info = self.sobolev_path_info(P, si, hess=hess)
        if info["path"] == "fused":
            logger.info("sobolev fast path: fused CUDA kernel %s, %s variant (P=%d, point "
                        "tile %s)", "K8" if hess else "K6", info["kernel"], P, info["tile"])
        elif info["reason"].startswith("not on CUDA"):
            logger.debug("sobolev path: eager (%s)", info["reason"])
        else:
            logger.warning("sobolev path FALLING BACK to eager for P=%d: %s — see PERF.md.",
                           P, info["reason"])

    def _hessian_targets(self, target_hess, G, P, si, so, yi, xi, full_sel, weight):
        """K8's Hessian targets from ``target_hess [G, P, |yi|, |xi|, |xi|]``
        (``yi``, ``xi`` the selected output and input indices):
        ``(ht_flat [G, P, n_pairs*so], hess_mask, asym_const)``. Index
        subsets are scattered to full width under a 0/1 mask over the unique
        pairs; the targets are symmetrized, since the kernel carries one
        column per unique pair (the gradient is unchanged), and
        ``asym_const``, the parameter-independent mean of their asymmetric
        part, makes ``hess_mse + asym_const`` the full-grid mean."""
        dev = self.device
        pairs = _hess_pairs(si)
        ht = torch.as_tensor(target_hess, device=dev)
        cells = (yi[:, None, None], xi[None, :, None], xi[None, None, :])
        sel = np.zeros((so, si, si), np.float32)
        sel[cells] = 1.0
        if full_sel:
            hess_mask = None
        else:
            o, j, k = (_device_constant(c, dev) for c in cells)
            full = torch.zeros((G, P, so, si, si), dtype=ht.dtype, device=dev)
            full[:, :, o, j, k] = ht
            ht = full
            hess_mask = np.concatenate([sel[:, j, k] for j, k in pairs])  # [n_pairs*so]
        ht_sym = 0.5 * (ht + ht.transpose(-1, -2))
        asym = torch.square(ht - ht_sym) * _device_constant(sel, dev)
        if weight is not None:
            asym = asym * weight[..., None, None, None]
        asym_const = torch.sum(asym) / (G * P * int(np.sum(sel)))
        ht_flat = torch.cat([ht_sym[..., j, k] for j, k in pairs], dim=-1)
        return ht_flat, hess_mask, asym_const

    def sobolev_value_and_grad(self, t, x, u, target_jac=None, target_hess=None,
                               w_value: float = 1.0, w_jac: float = 1.0, w_hess: float = 1.0,
                               y_index=None, x_index=None, fused: Optional[bool] = None,
                               use_reg: bool = True, reg_weight=None, weight=None):
        """The grouped Sobolev loss and its gradient: ``(total, terms,
        grads)``, ``terms`` the value and Jacobian (and Hessian) MSEs as
        0-dim tensors, ``grads`` keyed like the JAX params tree.

        ``t [G, pi]``, ``x [G, P, si]``, ``u [G, P, so]`` (or the y_index
        columns), ``target_jac [G, P, |y_index|, |x_index|]``, ``weight [G,
        P]`` (optional; it multiplies every term's squared error under a
        plain mean). The fused path runs the ParameterNet forward, then K6
        (forward, Jacobian tangents, both MSE terms and the backward through
        the tangent chain in one kernel on the card, its plain version on
        the CPU), then sends ``d_wb`` back through the ParameterNet with
        autograd; index subsets become 0/1 masks over full-width targets.
        ``target_hess [G, P, |y_index|, |x_index|, |x_index|]`` (Hessian
        targets, with or without ``target_jac``) takes K8 in place of K6: the
        second-order streams ride the same kernel, the off-diagonal targets
        are symmetrized (the gradient is the same) and the
        parameter-independent asymmetry constant is added back to
        ``hessian_mse``, so it equals the full-grid mean; without
        ``target_jac`` the Jacobian streams carry zero targets at zero weight.
        The eager path (``fused=False``, or no derivative target) is
        autograd over :func:`~nif_tpu_torch.ops.derivatives.sobolev_loss_grouped`.
        Default (None): fused where :meth:`sobolev_path_info` says so."""
        G, P, si = x.shape
        so = self.cfg_shape_net.output_dim
        cfg_k, variant_k = self._derivative_kernel_cfg()
        hess = target_hess is not None
        yi = None if y_index is None else np.atleast_1d(np.asarray(y_index))
        xi = None if x_index is None else np.atleast_1d(np.asarray(x_index))
        yi_full = np.arange(so) if yi is None else yi
        xi_full = np.arange(si) if xi is None else xi
        for name, target, expect in (
                ("target_jac", target_jac, (G, P, len(yi_full), len(xi_full))),
                ("target_hess", target_hess, (G, P, len(yi_full), len(xi_full), len(xi_full)))):
            if target is not None and tuple(target.shape) != expect:
                raise ValueError(f"sobolev_value_and_grad: {name} shape {tuple(target.shape)} "
                                 f"!= {expect} for the given y_index/x_index")
        if fused:
            if target_jac is None and not hess:
                raise ValueError("sobolev_value_and_grad: fused=True requires target_jac or "
                                 "target_hess (value-only training is mse_value_and_grad)")
            bad = self._sobolev_gate(cfg_k, variant_k, P, si, hess)
            if bad is not None:
                raise ValueError(f"sobolev_value_and_grad: fused=True unsupported here: {bad}")
        if fused is None:
            self._announce_sobolev_path(P, si, hess=hess)
            fused = ((target_jac is not None or hess)
                     and self.sobolev_path_info(P, si, hess=hess)["path"] == "fused")
        params = [p for _, p in self.param_items()]
        dev = self.device
        u = torch.as_tensor(u, device=dev)
        weight = None if weight is None else torch.as_tensor(weight, device=dev)
        reg = use_reg and self.has_regularization
        if not fused:
            total, terms = sobolev_loss_grouped(
                self, t, x, u, target_jac=target_jac, target_hess=target_hess,
                w_value=w_value, w_jac=w_jac, w_hess=w_hess, y_index=y_index,
                x_index=x_index, weight=weight)
            if reg:
                total = total + self.regularization_loss(t=t, reg_weight=reg_weight)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            return (total.detach(), {k: v.detach() for k, v in terms.items()},
                    self._grad_tree(grads))

        # scatter index-subset targets to full width; 0/1 masks select them
        if tuple(u.shape) == (G, P, so):
            tgt, y_mask = u, None
        elif yi is not None and tuple(u.shape) == (G, P, len(yi)):
            tgt = torch.zeros((G, P, so), dtype=u.dtype, device=dev)
            tgt[:, :, _device_constant(yi, dev)] = u
            y_mask = np.zeros(so, np.float32)
            y_mask[yi] = 1.0
        else:
            raise ValueError(f"sobolev_value_and_grad: value targets shape {tuple(u.shape)} "
                             f"matches neither the full output {(G, P, so)} nor the "
                             f"y_index-selected columns")
        full_sel = (len(yi_full) == so and len(xi_full) == si
                    and np.array_equal(yi_full, np.arange(so))
                    and np.array_equal(xi_full, np.arange(si)))
        if target_jac is None:
            # Hessian-only training: the Jacobian streams still ride the
            # kernel (they carry the second-order state), at zero weight
            jt_flat, jac_mask = torch.zeros((G, P, si * so), device=dev), None
        else:
            jt = torch.as_tensor(target_jac, device=dev)
            if full_sel:
                jac_mask = None
            else:
                full = torch.zeros((G, P, so, si), dtype=jt.dtype, device=dev)
                full[:, :, _device_constant(yi_full, dev)[:, None],
                     _device_constant(xi_full, dev)[None, :]] = jt
                jt = full
                mask = np.zeros((so, si), np.float32)
                mask[yi_full[:, None], xi_full[None, :]] = 1.0
                jac_mask = mask.T.reshape(si * so)  # the kernel's column k*so + j
            jt_flat = jt.transpose(2, 3).reshape(G, P, si * so)

        wb = self._derivative_weights(t)
        terms = {}
        if not hess:
            value_mse, jac_mse, d_wb = shapenet_sobolev_grads(
                wb, self._compute(x), tgt, jt_flat, cfg_k, variant_k, w_value=w_value,
                w_jac=w_jac, y_mask=y_mask, jac_mask=jac_mask, weight=weight)
        else:
            ht_flat, hess_mask, asym_const = self._hessian_targets(
                target_hess, G, P, si, so, yi_full, xi_full, full_sel, weight)
            value_mse, jac_mse, hess_mse, d_wb = shapenet_hessian_grads(
                wb, self._compute(x), tgt, jt_flat, ht_flat, cfg_k, variant_k,
                w_value=w_value, w_jac=w_jac if target_jac is not None else 0.0,
                w_hess=w_hess, y_mask=y_mask, jac_mask=jac_mask, hess_mask=hess_mask,
                weight=weight)
            terms["hessian_mse"] = hess_mse + asym_const
        grads = torch.autograd.grad(wb, params, d_wb)
        terms["value_mse"] = value_mse
        total = w_value * value_mse
        if target_jac is not None:
            terms["jacobian_mse"] = jac_mse
            total = total + w_jac * jac_mse
        if hess:
            total = total + w_hess * terms["hessian_mse"]
        if reg:
            reg_loss = self.regularization_loss(t=t, reg_weight=reg_weight)
            reg_grads = torch.autograd.grad(reg_loss, params, allow_unused=True)
            grads = [g if r is None else g + r for g, r in zip(grads, reg_grads)]
            total = total + reg_loss.detach()
        return total, terms, self._grad_tree(grads)

    # ------------------------------------------------------- regularization
    @property
    def has_regularization(self) -> bool:
        """True when any regularization term is configured: one source of
        truth for the fused and the eager training paths."""
        cfg_p = self.cfg_parameter_net
        return any(v is not None for v in (cfg_p.l1_reg, cfg_p.l2_reg, cfg_p.act_l1_reg,
                                           cfg_p.act_l2_reg, cfg_p.jac_reg))

    def regularization_loss(self, inputs=None, t=None, reg_weight=None,
                            parts: str = "all") -> torch.Tensor:
        """Sum of the configured regularization terms, as the JAX package
        computes them: ``l2_reg`` (else ``l1_reg``) times the sum of squares
        (absolute values) of every ParameterNet parameter; ``act_l2_reg``
        (else ``act_l1_reg``) times the batch mean of each row's sum of
        squares (absolute values) of the generated weight vector (the Keras
        activity regularizer's division by the batch); and ``jac_reg`` times
        the batch mean of ``mean((d latent / d t)^2)`` per row.

        ``t`` (parameter rows) or ``inputs`` (point-wise rows, whose first
        ``pi_dim`` columns are taken) is needed for the activity and Jacobian
        terms. ``reg_weight [batch]`` makes each batch mean
        ``mean(per_row * reg_weight)`` (the trainers pass ``reg_row_weights``
        so zero-weight padding changes nothing). ``parts``: ``"all"``,
        ``"params"`` (the L1/L2 term only) or ``"batch"`` (the batch terms
        only)."""
        if parts not in ("all", "params", "batch"):
            raise ValueError(f"unknown parts {parts!r}")
        cfg_p = self.cfg_parameter_net
        loss = torch.zeros((), dtype=self.policy.param_dtype, device=self.device)
        if parts in ("all", "params"):
            if cfg_p.l2_reg is not None:
                loss = loss + cfg_p.l2_reg * parameter_sum(
                    self.pnet.params, lambda p: torch.sum(torch.square(p)))
            elif cfg_p.l1_reg is not None:
                loss = loss + cfg_p.l1_reg * parameter_sum(
                    self.pnet.params, lambda p: torch.sum(torch.abs(p)))
        if parts == "params":
            return loss
        needs_act = cfg_p.act_l1_reg is not None or cfg_p.act_l2_reg is not None
        needs_jac = cfg_p.jac_reg is not None
        if not (needs_act or needs_jac):
            return loss
        if inputs is None and t is None:
            raise ValueError(
                "regularization_loss needs `inputs` (point-wise rows) or `t` "
                "(parameter rows) when activity or jacobian regularization "
                "is configured"
            )
        if t is None:
            t = torch.as_tensor(inputs)[..., : self.pi_dim]
        t = self._compute(t)
        rw = None if reg_weight is None else torch.as_tensor(reg_weight, device=self.device).to(t.dtype)

        def batch_mean(per_row):
            return torch.mean(per_row if rw is None else per_row * rw)

        if needs_act:
            wb, _ = parameter_net_apply(self.pnet.params, t, cfg_p, self.pnet_kind)
            if cfg_p.act_l2_reg is not None:
                per_row, coef = torch.sum(torch.square(wb), dim=-1), cfg_p.act_l2_reg
            else:
                per_row, coef = torch.sum(torch.abs(wb), dim=-1), cfg_p.act_l1_reg
            loss = loss + coef * batch_mean(per_row)
        if needs_jac:
            def latent_fn(ti):
                return parameter_net_latent(self.pnet.params, ti, cfg_p, self.pnet_kind)

            # d latent / d t per row, forward mode (pi_dim is tiny)
            jac = torch.func.vmap(torch.func.jacfwd(latent_fn))(t)
            per_row = torch.mean(torch.square(jac), dim=tuple(range(1, jac.dim())))
            loss = loss + cfg_p.jac_reg * batch_mean(per_row)
        return loss

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
