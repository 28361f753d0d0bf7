"""Input-output derivatives and Sobolev losses (counterpart of
``nif_tpu/ops/derivatives.py``), in ``torch.func``.

NIF inputs are tiny (a handful of coordinates per point), so forward mode
(``jacfwd``) is the right mode, one tangent per input column; ``vmap`` takes
it over the points. The point-wise functions take a batched function
``fn: [B, d_in] -> [B, d_out]``. The grouped ones take a model: its
ParameterNet runs once per group, and on the card ``(y, dy/dx)`` runs
through the fused Jacobian kernel K5 (``ops.fused_derivatives``) and ``(y,
dy/dx, d2y/dx2)`` through the fused Hessian kernel K7 (``ops.fused_hessian``)
where the config allows it. Everything on the eager path stays
differentiable in the model's parameters (the Sobolev training loss rides
it off the card).
"""
from __future__ import annotations

import functools
import logging
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch.func import jacfwd, vmap

from .fused_derivatives import fwd_jac_unsupported_reason, shapenet_fwd_jac
from .fused_hessian import fwd_hess_unsupported_reason, shapenet_fwd_hess
from .shapenet import shapenet_pointwise

__all__ = [
    "output_and_jacobian",
    "output_jacobian_hessian",
    "jacobian_regularization",
    "sobolev_loss",
    "output_and_jacobian_grouped",
    "output_jacobian_hessian_grouped",
    "sobolev_loss_grouped",
]

Index = Union[int, Sequence[int], None]

logger = logging.getLogger("nif_tpu_torch")


def _as_index(idx: Index, dim: int, device) -> torch.Tensor:
    if idx is None:
        return torch.arange(dim, device=device)
    return torch.atleast_1d(torch.as_tensor(idx, device=device))


def _select_jac(jac, y_index: Index, x_index: Index):
    """y_index/x_index subsetting of ``[..., d_out, d_in]`` (a no-op when
    both are None)."""
    if y_index is not None:
        jac = jac[..., _as_index(y_index, jac.shape[-2], jac.device), :]
    if x_index is not None:
        jac = jac[..., _as_index(x_index, jac.shape[-1], jac.device)]
    return jac


def _select_hess(hess, y_index: Index, x_index: Index):
    """Same, for ``[..., d_out, d_in, d_in]`` (x_index on both trailing axes)."""
    if y_index is not None:
        hess = hess[..., _as_index(y_index, hess.shape[-3], hess.device), :, :]
    if x_index is not None:
        xi = _as_index(x_index, hess.shape[-1], hess.device)
        hess = hess[..., xi, :][..., xi]
    return hess


def _with_value(f: Callable) -> Callable:
    """``r -> (f(r), f(r))``: jacfwd's ``has_aux`` hands back the value of
    the same evaluation."""
    def g(r):
        y = f(r)
        return y, y
    return g


def output_and_jacobian(fn: Callable, inputs: torch.Tensor, y_index: Index = None,
                        x_index: Index = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``(y [B, d_out], jac [B, |y_index|, |x_index|])`` of a
    batched ``fn``: the ``JacobianLayer`` equivalent."""
    def single(row):
        jac, y = jacfwd(_with_value(lambda r: fn(r[None, :])[0]), has_aux=True)(row)
        return y, jac

    y, jac = vmap(single)(inputs)
    return y, _select_jac(jac, y_index, x_index)


def output_jacobian_hessian(fn: Callable, inputs: torch.Tensor, y_index: Index = None,
                            x_index: Index = None):
    """Per-sample ``(y, dy/dx, d2y/dx2)`` by nested forward mode: the
    ``HessianLayer`` equivalent; ``hess [B, |yi|, |xi|, |xi|]``."""
    def single(row):
        f = lambda r: fn(r[None, :])[0]  # noqa: E731
        jac, y = jacfwd(_with_value(f), has_aux=True)(row)
        return y, jac, jacfwd(jacfwd(f))(row)

    y, jac, hess = vmap(single)(inputs)
    return y, _select_jac(jac, y_index, x_index), _select_hess(hess, y_index, x_index)


def _is_linear(model) -> bool:
    """NIF-linear: its trunk carries trainable parameters, and the kernels
    take its effective generated chain."""
    return hasattr(model, "_fwd_jac_effective_chain")


def _grouped_point_fn(model, wb_g: torch.Tensor) -> Callable:
    """One point's field given one group's generated weights (NIF-linear:
    its ``a(t)`` row, contracted with the trunk), as the model's
    ``x_to_u_given_w`` computes it (compute dtype in, param dtype out)."""
    cdt, pdt = model.policy.compute_dtype, model.policy.param_dtype
    if _is_linear(model):
        return lambda r: model._x_to_u(r[None].to(cdt), wb_g[None].to(cdt))[0].to(pdt)
    cfg, variant = model.cfg_shape_net, model.shapenet_variant
    return lambda r: shapenet_pointwise(wb_g[None].to(cdt), r[None].to(cdt), cfg,
                                        variant)[0].to(pdt)


def _kernel_dtype_ok(model) -> bool:
    return (model.policy.compute_dtype in (torch.float32, torch.bfloat16)
            and not model._any_f64())


def _fusable(model, x, fused: Optional[bool], kernel: str, reason_fn) -> bool:
    """Route a derivative evaluation through ``kernel``? ``fused=False``
    never; ``True`` when ``reason_fn`` (its gate) takes the config (the
    plain version on the CPU); ``None`` (auto) additionally needs CUDA, and
    where the config sends a CUDA batch to the eager path it logs why, at
    WARNING, once per model and shape."""
    if fused is False:
        return False
    cfg, variant = model._derivative_kernel_cfg()
    device = x.device if torch.is_tensor(x) else model.device
    P, si = x.shape[1], x.shape[2]
    reason = (reason_fn(cfg, variant, P, si, device) if _kernel_dtype_ok(model) else
              "float64 parameters or a compute dtype the kernels do not take")
    if fused is True:
        return reason is None
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and reason is not None and (kernel, P, si) not in model._announced_sobolev_paths:
        model._announced_sobolev_paths.add((kernel, P, si))
        logger.warning("%s path FALLING BACK to eager for P=%d: %s — see PERF.md.", kernel, P,
                       reason)
    return on_cuda and reason is None


def output_and_jacobian_grouped(model, t, x, y_index: Index = None, x_index: Index = None,
                                fused: Optional[bool] = None):
    """Grouped ``(y [G, P, so], jac [G, P, |y_index|, |x_index|])``: the
    ParameterNet runs once per group and forward mode differentiates the
    ShapeNet chain in x.

    On the card ``(y, jac)`` runs in one launch of K5 (reverse cotangent
    sweeps when so < si, the flagship's case, on the tensor cores in
    bfloat16; forward tangents otherwise), in the compute dtype, gated on
    the limits of the kernel that dtype runs. ``fused=False`` forces the eager ``jacfwd`` path
    (param dtype, differentiable in the parameters); ``fused=True`` forces
    the kernel path (plain K5 on the CPU)."""
    # K5's limits are those of the kernel the compute dtype runs (k5_variant)
    k5_gate = functools.partial(fwd_jac_unsupported_reason, dtype=model.policy.compute_dtype)
    if _fusable(model, x, fused, "K5", k5_gate):
        cfg, variant = model._derivative_kernel_cfg()
        wb = model._derivative_weights(t)  # the hypernetwork runs once per group
        y, jac = shapenet_fwd_jac(wb, model._compute(x), cfg, variant)
    else:
        wb = model.p_to_w(t)
        x = model._compute(x).to(model.policy.param_dtype)

        def group(wb_g, x_g):
            f = _grouped_point_fn(model, wb_g)

            def point(row):
                jac, y = jacfwd(_with_value(f), has_aux=True)(row)
                return y, jac

            return vmap(point)(x_g)

        y, jac = vmap(group)(wb, x)
    return y, _select_jac(jac, y_index, x_index)


def output_jacobian_hessian_grouped(model, t, x, y_index: Index = None,
                                    x_index: Index = None, fused: Optional[bool] = None):
    """Grouped ``(y, dy/dx, d2y/dx2)``, the ParameterNet once per group.

    On the card ``(y, jac, hess)`` runs in one launch of K7 (the value rows,
    the si tangents and the si(si+1)/2 unique second-order streams stacked
    in every product; the Hessian mirrored, exactly symmetric), in the
    compute dtype, for sine chains with si <= 4. ``fused=False`` forces the
    eager nested ``jacfwd`` path (param dtype, differentiable in the
    parameters); ``fused=True`` forces the kernel path (plain K7 on the
    CPU)."""
    # K7's limits are those of the kernel the compute dtype runs (k7_variant)
    k7_gate = functools.partial(fwd_hess_unsupported_reason, dtype=model.policy.compute_dtype)
    if _fusable(model, x, fused, "K7", k7_gate):
        cfg, variant = model._derivative_kernel_cfg()
        wb = model._derivative_weights(t)  # the hypernetwork runs once per group
        y, jac, hess = shapenet_fwd_hess(wb, model._compute(x), cfg, variant)
        return y, _select_jac(jac, y_index, x_index), _select_hess(hess, y_index, x_index)
    wb = model.p_to_w(t)
    x = model._compute(x).to(model.policy.param_dtype)

    def group(wb_g, x_g):
        f = _grouped_point_fn(model, wb_g)

        def point(row):
            jac, y = jacfwd(_with_value(f), has_aux=True)(row)
            return y, jac, jacfwd(jacfwd(f))(row)

        return vmap(point)(x_g)

    y, jac, hess = vmap(group)(wb, x)
    return y, _select_jac(jac, y_index, x_index), _select_hess(hess, y_index, x_index)


def _value_term(y, targets, y_index, name):
    """The outputs the value term compares: the full output, or with
    y_index the selected columns; anything else raises (a silent broadcast
    would give a plausible wrong loss)."""
    tshape = tuple(targets.shape)
    if tshape == tuple(y.shape):
        return y
    if y_index is not None:
        y_val = y[..., _as_index(y_index, y.shape[-1], y.device)]
        if tuple(y_val.shape) == tshape:
            return y_val
        raise ValueError(f"{name}: value targets shape {tshape} matches neither the full "
                         f"output {tuple(y.shape)} nor the y_index-selected output "
                         f"{tuple(y_val.shape)}")
    raise ValueError(f"{name}: value targets shape {tshape} does not match the output "
                     f"shape {tuple(y.shape)}")


def _total(terms, w_value, w_jac, w_hess):
    total = w_value * terms["value_mse"]
    if "jacobian_mse" in terms:
        total = total + w_jac * terms["jacobian_mse"]
    if "hessian_mse" in terms:
        total = total + w_hess * terms["hessian_mse"]
    return total


def sobolev_loss_grouped(model, t, x, targets, target_jac=None, target_hess=None,
                         w_value: float = 1.0, w_jac: float = 1.0, w_hess: float = 1.0,
                         y_index: Index = None, x_index: Index = None, weight=None):
    """The Sobolev loss on the grouped layout, eager and differentiable in
    the model's parameters: ``(total, terms)`` with ``terms`` the value,
    Jacobian and (with ``target_hess``) Hessian MSEs. ``weight [G, P]``
    (optional) multiplies every term's squared error per point under a
    plain mean (the trainers' zero-weight padding stays exact)."""
    dev = model.device
    as_t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    targets, target_jac, target_hess, weight = map(as_t, (targets, target_jac, target_hess,
                                                          weight))

    def wmean(sq, extra_dims):
        if weight is None:
            return torch.mean(sq)
        return torch.mean(sq * weight.to(sq.dtype).reshape(weight.shape + (1,) * extra_dims))

    if target_hess is not None:
        y, jac, hess = output_jacobian_hessian_grouped(model, t, x, y_index, x_index,
                                                       fused=False)
        terms = {"hessian_mse": wmean(torch.square(hess - target_hess), 3)}
    else:
        y, jac = output_and_jacobian_grouped(model, t, x, y_index, x_index, fused=False)
        terms = {}
    y_val = _value_term(y, targets, y_index, "sobolev_loss_grouped")
    terms["value_mse"] = wmean(torch.square(y_val - targets), 1)
    if target_jac is not None:
        terms["jacobian_mse"] = wmean(torch.square(jac - target_jac), 2)
    return _total(terms, w_value, w_jac, w_hess), terms


def jacobian_regularization(fn: Callable, inputs: torch.Tensor, l1: float,
                            y_index: Index = None, x_index: Index = None) -> torch.Tensor:
    """``l1 * mean((d fn / d x)^2)``: the ``JacRegLatentLayer`` penalty."""
    _, jac = output_and_jacobian(fn, inputs, y_index, x_index)
    return l1 * torch.mean(torch.square(jac))


def sobolev_loss(fn: Callable, inputs: torch.Tensor, targets, target_jac=None,
                 target_hess=None, w_value: float = 1.0, w_jac: float = 1.0,
                 w_hess: float = 1.0, y_index: Index = None, x_index: Index = None):
    """The point-wise Sobolev loss (tutorial 8): ``(total, terms)``."""
    terms = {}
    if target_hess is not None:
        y, jac, hess = output_jacobian_hessian(fn, inputs, y_index, x_index)
        terms["hessian_mse"] = torch.mean(torch.square(hess - target_hess))
    else:
        y, jac = output_and_jacobian(fn, inputs, y_index, x_index)
    y_val = _value_term(y, targets, y_index, "sobolev_loss")
    terms["value_mse"] = torch.mean(torch.square(y_val - targets))
    if target_jac is not None:
        terms["jacobian_mse"] = torch.mean(torch.square(jac - target_jac))
    return _total(terms, w_value, w_jac, w_hess), terms
