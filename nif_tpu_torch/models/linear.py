"""NIFMultiScaleLastLayerParameterized ("NIF-linear") as an ``nn.Module``
(counterpart of ``nif_tpu/models/linear.py``): only the ShapeNet's last
layer is generated by the ParameterNet, so

    u(x; t, mu) = phi(x)^T a(t, mu) + b

a learned modal decomposition (POD-like) for linear-subspace ROMs.

The trunk ``x -> phi(x)`` is a trainable SIREN (``snet``: ``first``, the
hidden layers, a linear ``bottleneck`` of width ``so * latent_dim`` and the
non-generated output ``bias [so]``), shared by every snapshot. On the card:

* ``apply_grouped(fused=True)`` / ``x_to_phi(fused=True)`` run the trunk
  through K1 (the grouped ShapeNet forward, with the trunk's weights as every
  group's row), differentiable through K3;
* ``mse_value_and_grad`` runs K4, the fused NIF-linear train pass (trunk
  forward, contraction, weighted MSE and backward in one kernel), and sends
  ``d_a`` back through the ParameterNet with autograd;
* the derivative kernels (K5-K8) run on the *effective* generated chain
  (``_fwd_jac_effective_chain``): the bottleneck and the contraction with
  ``a(t)`` are both linear, so they fold into a per-group last layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import ShapeNetConfig
from ..layers.initializers import truncated_normal_init
from ..layers.siren import siren_apply, siren_init, siren_resnet_apply, siren_resnet_init
from ..ops.fused_linear import linear_fused_unsupported_reason, linear_geometry, niflinear_mse_grads
from ..ops.fused_shapenet import shapenet_grouped_fused
from .nif import NIFMultiScale, _as_shape_cfg
from .parameter_net import _as_module

__all__ = ["NIFMultiScaleLastLayerParameterized"]


class _Trunk(nn.Module):
    """The trunk's params tree as a module: each layer (``first``,
    ``hidden_{i}``, ``bottleneck``) a ``ParameterDict`` and the output
    ``bias`` a parameter, indexed by key like the JAX package's
    ``params["snet"]``."""

    def __init__(self, layers: Dict[str, Dict[str, torch.Tensor]], bias: torch.Tensor):
        super().__init__()
        for key, tree in layers.items():
            self.add_module(key, _as_module(tree))
        self.bias = nn.Parameter(bias)

    def keys(self) -> List[str]:
        return [*self._modules, "bias"]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __getitem__(self, key: str):
        return getattr(self, key)


class NIFMultiScaleLastLayerParameterized(NIFMultiScale):
    """NIF-linear: a SIREN trunk ``phi(x)`` contracted with the
    ParameterNet's output ``a(t)`` (``po_dim == latent_dim``), plus a bias."""

    def __init__(self, cfg_shape_net, cfg_parameter_net, mixed_policy="float32",
                 device=None, seed: int = 0):
        cfg_s = _as_shape_cfg(cfg_shape_net)
        if cfg_s.connectivity != "last_layer":
            raise ValueError("you should assign cfg_shape_net['connectivity'] == 'last_layer'")
        super().__init__(cfg_s, cfg_parameter_net, mixed_policy, device=device, seed=seed)
        # po_dim == latent_dim here (reference nif/model.py:583-585)
        assert self.po_dim == self.pi_hidden

    # ---------------------------------------------------------------- init
    def _init_params(self, generator: torch.Generator) -> None:
        """The ParameterNet, then the trunk (first -> hidden, resblock or
        plain -> linear bottleneck of width so * latent_dim, and the output
        bias with TruncatedNormal(0.1) init), from one generator."""
        super()._init_params(generator)
        c, dtype, dev = self.cfg_shape_net, self.policy.param_dtype, self.device
        layers = {"first": siren_init(generator, c.input_dim, c.units, "first", c.omega_0,
                                      dtype, dev)}
        for i in range(c.nlayers):
            if c.use_resblock:
                layers[f"hidden_{i}"] = siren_resnet_init(generator, c.units, c.omega_0, dtype, dev)
            else:
                layers[f"hidden_{i}"] = siren_init(generator, c.units, c.units, "hidden",
                                                   c.omega_0, dtype, dev)
        layers["bottleneck"] = siren_init(generator, c.units, self.pi_hidden * self.so_dim,
                                          "bottleneck", c.omega_0, dtype, dev)
        bias = truncated_normal_init(generator, (self.so_dim,), 0.1, dtype, dev)
        self.snet = _Trunk(layers, bias)

    def param_tree(self) -> nn.ModuleDict:
        return nn.ModuleDict({"pnet": self.pnet.params, "snet": self.snet})

    def param_items(self) -> List[Tuple[Tuple[str, ...], nn.Parameter]]:
        return super().param_items() + [(("snet",) + tuple(name.split(".")), p)
                                        for name, p in self.snet.named_parameters()]

    # --------------------------------------------------------------- trunk
    @property
    def _trunk_cfg(self) -> ShapeNetConfig:
        """The phi trunk viewed as a generated-chain config: the same SIREN
        stack with output width so_dim * latent_dim (the bottleneck)."""
        c = self.cfg_shape_net
        return ShapeNetConfig(input_dim=c.input_dim, output_dim=self.so_dim * self.pi_hidden,
                              units=c.units, nlayers=c.nlayers, activation="sine",
                              use_resblock=c.use_resblock, omega_0=c.omega_0,
                              connectivity="full")

    def _trunk_keys(self) -> List[Tuple[str, str, str]]:
        """``(layer, weight key, bias key)`` of each trunk matrix in chain
        order (a resblock contributes two; the bottleneck last)."""
        c = self.cfg_shape_net
        keys = [("first", "w", "b")]
        for i in range(c.nlayers):
            keys.append((f"hidden_{i}", "w", "b"))
            if c.use_resblock:
                keys.append((f"hidden_{i}", "w2", "b2"))
        return keys + [("bottleneck", "w", "b")]

    def _trunk_lists(self):
        """The trunk's weight matrices and biases in chain order."""
        keys = self._trunk_keys()
        return ([self.snet[l][w] for l, w, _ in keys], [self.snet[l][b] for l, _, b in keys])

    def _trunk_flat_weights(self) -> torch.Tensor:
        """The trunk in the chain's flat layout ``[W_first | W_hidden... |
        W_bot | b_first | ... | b_bot]`` as one ``[1, po]`` row, so the
        grouped ShapeNet kernels run the shared-weight MLP."""
        ws, bs = self._trunk_lists()
        return torch.cat([w.reshape(-1) for w in ws] + list(bs))[None]

    def _phi(self, x: torch.Tensor) -> torch.Tensor:
        """The eager trunk on compute-dtype ``x [..., si]`` -> ``[..., so*K]``."""
        c, s = self.cfg_shape_net, self.snet
        h = siren_apply(s["first"], x, c.omega_0, "first")
        for i in range(c.nlayers):
            if c.use_resblock:
                h = siren_resnet_apply(s[f"hidden_{i}"], h, c.omega_0)
            else:
                h = siren_apply(s[f"hidden_{i}"], h, c.omega_0, "hidden")
        return siren_apply(s["bottleneck"], h, c.omega_0, "bottleneck")

    def x_to_phi(self, x, fused: bool = False) -> torch.Tensor:
        """x -> phi(x) of shape ``[..., so_dim, latent_dim]`` at the compute
        dtype. ``fused=True`` runs the trunk through K1 (K3 as its backward)
        on the card, its plain version on the CPU: one launch for ``x [P,
        si]`` or ``[G, P, si]``, with the trunk's weights broadcast to the G
        rows (as the JAX package does)."""
        x = self._compute(x)
        if fused:
            wb = self._trunk_flat_weights().to(x.dtype)
            if x.dim() == 2:
                phi = shapenet_grouped_fused(wb, x[None], self._trunk_cfg, "siren")[0]
            else:
                phi = shapenet_grouped_fused(wb.expand(x.shape[0], -1), x, self._trunk_cfg,
                                             "siren")
        else:
            phi = self._phi(x)
        return phi.reshape(*x.shape[:-1], self.so_dim, self.pi_hidden)

    # --------------------------------------------------------------- apply
    def _bias(self, dtype: torch.dtype) -> torch.Tensor:
        return self.snet.bias.to(dtype)

    def apply(self, inputs, return_latent: bool = False):
        """Point-wise forward on ``[B, pi_dim + si_dim]`` rows; the latent is
        ``a(t)``."""
        inputs = self._compute(inputs)
        a, _ = self.pnet(inputs[..., : self.pi_dim])
        phi = self.x_to_phi(inputs[..., self.pi_dim: self.pi_dim + self.si_dim])
        u = (torch.einsum("bok,bk->bo", phi, a) + self._bias(phi.dtype)).to(self.policy.param_dtype)
        return (u, a) if return_latent else u

    def apply_grouped(self, t, x, fused: Optional[bool] = None):
        """``t [G, pi]``, ``x [G, P, si]`` -> ``[G, P, so]``. ``fused=True``
        runs the trunk through K1; the default (None) and False run it eager,
        as the JAX package's ``fused=bool(fused)``."""
        a, _ = self.pnet(self._compute(t))
        phi = self.x_to_phi(x, fused=bool(fused))
        u = torch.einsum("gpok,gk->gpo", phi, a) + self._bias(phi.dtype)
        return u.to(self.policy.param_dtype)

    def apply_shared_mesh(self, t, x):
        """``t [G, pi]``, ``x [P, si]`` (one mesh for every snapshot) ->
        ``[G, P, so]``: phi is evaluated once and the reconstruction is one
        product."""
        a, _ = self.pnet(self._compute(t))
        phi = self.x_to_phi(x)
        u = torch.einsum("pok,gk->gpo", phi, a) + self._bias(phi.dtype)
        return u.to(self.policy.param_dtype)

    # ------------------------------------------------ fused derivative path
    @property
    def _fwd_jac_cfg(self) -> ShapeNetConfig:
        """The static config of the effective generated chain."""
        c = self.cfg_shape_net
        return ShapeNetConfig(input_dim=c.input_dim, output_dim=self.so_dim, units=c.units,
                              nlayers=c.nlayers, activation="sine", use_resblock=c.use_resblock,
                              omega_0=c.omega_0, connectivity="full")

    def _fwd_jac_effective_chain(self, t):
        """Trunk and latent contraction as an equivalent generated chain for
        the derivative kernels: ``W_eff = W_bot.reshape(n, so, K) @ a_g``,
        ``b_eff = b_bot.reshape(so, K) @ a_g + bias``, the shared hidden
        weights repeated for each of the G groups, in the chain layout at the
        compute dtype. Returns ``(wb_eff [G, po], cfg_eff)``; differentiable
        in the trunk and the ParameterNet."""
        a, _ = self.pnet(self._compute(t))
        cdt = a.dtype
        ws, bs = self._trunk_lists()
        n, so, K, G = self.cfg_shape_net.units, self.so_dim, self.pi_hidden, a.shape[0]
        w_eff = torch.einsum("nok,gk->gno", ws[-1].to(cdt).reshape(n, so, K), a)
        b_eff = torch.einsum("ok,gk->go", bs[-1].to(cdt).reshape(so, K), a) + self._bias(cdt)
        flat = ([w.to(cdt).reshape(1, -1).expand(G, -1) for w in ws[:-1]]
                + [w_eff.reshape(G, -1)]
                + [b.to(cdt).reshape(1, -1).expand(G, -1) for b in bs[:-1]] + [b_eff])
        return torch.cat(flat, dim=-1), self._fwd_jac_cfg

    def _derivative_kernel_cfg(self):
        return self._fwd_jac_cfg, "siren"

    def _derivative_weights(self, t) -> torch.Tensor:
        return self._fwd_jac_effective_chain(t)[0]

    # ----------------------------------------------------- fused train path
    def fast_path_info(self, P: int) -> Dict[str, Any]:
        """Which path :meth:`mse_value_and_grad` takes for P-point groups
        under auto selection: K4, gated by ``linear_fused_unsupported_reason``
        (its reasons are the JAX package's), or eager."""
        reason = linear_fused_unsupported_reason(self._trunk_cfg, self.so_dim, P, self.device,
                                                 self.policy.compute_dtype)
        return self._path_info(reason, lambda: linear_geometry(
            self._trunk_cfg, self.so_dim, 1, P, self.policy.compute_dtype)["tile"])

    def mse_value_and_grad(self, t, x, u, weight=None, fused: Optional[bool] = None,
                           use_reg: bool = True, reg_weight=None):
        """The grouped weighted-MSE loss and its gradient: ``(loss, grads)``,
        ``grads`` keyed like the JAX params tree, the trunk under ``"snet"``.

        The fused path runs the ParameterNet forward to ``a [G, K]``, then K4
        (the trunk forward, the contraction, the weighted MSE and the whole
        backward in one kernel on the card, its plain version on the CPU),
        whose ``d_a`` goes back through the ParameterNet with autograd and
        whose trunk grads are the trunk's. ``fused=False`` is autograd over
        the eager ``apply_grouped``. Default (None): fused where
        :meth:`fast_path_info` says so. Regularization as the base class."""
        if fused is None:
            self._announce_path(x.shape[1])
            fused = self.fast_path_info(x.shape[1])["path"] == "fused"
        if not fused:
            return super().mse_value_and_grad(t, x, u, weight=weight, fused=False,
                                              use_reg=use_reg, reg_weight=reg_weight)
        items = self.param_items()
        params = [p for _, p in items]
        u = torch.as_tensor(u, device=self.device)
        weight = None if weight is None else torch.as_tensor(weight, device=self.device)
        x_c = self._compute(x)
        a, _ = self.pnet(self._compute(t))
        cdt = x_c.dtype
        ws, bs = self._trunk_lists()
        loss, d_ws, d_bs, d_a, d_bias = niflinear_mse_grads(
            [w.to(cdt) for w in ws], [b.to(cdt) for b in bs], a.to(cdt), self._bias(cdt), x_c, u,
            self._trunk_cfg, self.so_dim, weight)
        pnet_params = list(self.pnet.params.parameters())
        grads = dict(zip(map(id, pnet_params),
                         torch.autograd.grad(a, pnet_params, d_a.to(a.dtype))))
        for p, g in zip([*ws, *bs, self.snet.bias], [*d_ws, *d_bs, d_bias]):
            grads[id(p)] = g.to(p.dtype)
        grads = [grads[id(p)] for p in params]
        if use_reg and self.has_regularization:
            reg_loss = self.regularization_loss(t=t, reg_weight=reg_weight)
            reg_grads = torch.autograd.grad(reg_loss, params, allow_unused=True)
            grads = [g if r is None else g + r for g, r in zip(grads, reg_grads)]
            loss = loss + reg_loss.detach()
        return loss, self._grad_tree(grads)

    # ------------------------------------------------- subnetwork extraction
    def p_to_lr(self, t):
        """(t, mu) -> a(t): for this model the latent IS the generated last
        layer."""
        return self.pnet(self._compute(t))[0]

    def lr_to_w(self, lr):
        raise ValueError("In this class: NIFMultiScaleLastLayerParameterized, `w` is the same "
                         "as `lr`")

    def _x_to_u(self, x: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        """phi(x) . wb + bias on compute-dtype ``x [B, si]``, ``wb [B, K]``."""
        phi = self._phi(x).reshape(*x.shape[:-1], self.so_dim, self.pi_hidden)
        return torch.einsum("bok,bk->bo", phi, wb) + self._bias(phi.dtype)

    def x_to_u_given_w(self, x, wb):
        """coords + generated last layer ``a(t)`` -> field, point-wise: ``x
        [B, si]``, ``wb [B, K]`` -> ``[B, so]``."""
        return self._x_to_u(self._compute(x), self._compute(wb)).to(self.policy.param_dtype)

    # ------------------------------------------------------- regularization
    @property
    def has_regularization(self) -> bool:
        c = self.cfg_shape_net
        return super().has_regularization or c.l1_reg is not None or c.l2_reg is not None

    def regularization_loss(self, inputs=None, t=None, reg_weight=None,
                            parts: str = "all") -> torch.Tensor:
        """The base class's terms (the ParameterNet's L1/L2 and the batch
        terms), plus the trunk's own ``cfg_shape_net`` L2 (else L1) over every
        trunk parameter, in ``"all"`` and ``"params"``."""
        loss = super().regularization_loss(inputs, t=t, reg_weight=reg_weight, parts=parts)
        if parts == "batch":
            return loss
        c = self.cfg_shape_net
        leaves = list(self.snet.parameters())
        if c.l2_reg is not None:
            loss = loss + c.l2_reg * sum(torch.sum(torch.square(p)) for p in leaves)
        elif c.l1_reg is not None:
            loss = loss + c.l1_reg * sum(torch.sum(torch.abs(p)) for p in leaves)
        return loss
