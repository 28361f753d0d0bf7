"""The fused kernels of the grouped ShapeNet chain (counterparts of
``nif_tpu/ops/pallas_shapenet.py``):

* **K1**, :func:`shapenet_grouped_fused`: ``wb [G, po]``, ``x [G, P, si]`` ->
  ``[G, P, so]`` in x's dtype (float32 or bfloat16), what the Pallas
  kernel's ``_forward_layers(save=False)`` computes. It is differentiable:
  its backward is K3. Its forward is the registered op
  ``torch.ops.nif_tpu_torch.shapenet_fwd``, so ``torch.export`` records it
  as one call (``serving.export_apply``).
* **K2**, :func:`shapenet_mse_grads`: forward + weighted MSE + backward in
  one pass, ``(loss, d_wb)`` (the Pallas ``_train_kernel``).
* **K3**, the backward of K1 (the Pallas ``_bwd_kernel`` behind
  ``_fused_bwd``): it recomputes the forward and takes ``g_out`` to
  ``(d_wb, dx)``.

Rounding points, shared by all three:

* omega_0 is folded into every sine-fed weight matrix (all but the last
  layer) at the compute dtype before the kernel (:func:`_prescale`), and
  the sine-fed weight grads are multiplied back by omega_0 in f32
  (:func:`_unscale_grads`);
* every product is summed in f32 and every bias added in f32; activations
  are rounded to the compute dtype before each matmul;
* resblock and shortcut sums are taken in f32;
* the sine is the degree-7 polynomial of :func:`fast_sin` for bf16 compute
  (degree 9 under ``NIF_SIN_DEGREE=9``) and exact for f32 compute; the
  backward uses the exact derivative of the function the forward computes
  (:func:`fast_sin_grad` for the polynomial), saved by the forward at the
  compute dtype;
* the backward carries ``du`` in f32 and rounds each ``dz = du * act'`` to
  the compute dtype before its weight product and bias sum.

On a CUDA tensor each entry launches its hand-written kernel
(``nif_tpu_torch/csrc/shapenet_fwd.cu`` for K1, ``shapenet_bwd.cu`` for K2
and K3), or raises. K1, K2 and K3 have three variants (:func:`k1_variant`,
:func:`k2_variant`, :func:`k3_variant`): bfloat16 sine chains run the first
body whose geometry takes the shape of ``"wgmma"`` (warpgroup products fed
by TMA: ``csrc/shapenet_fwd_wgmma.cu`` for K1, with its A operand in
registers, ``csrc/shapenet_bwd_wgmma.cu`` for K2 and K3), ``"tc"``
(``mma.sync``: ``csrc/shapenet_fwd_tc.cu``, ``csrc/shapenet_bwd_tc.cu``)
and ``"simt"`` (the CUDA-core ``shapenet_fwd.cu``, ``shapenet_bwd.cu``),
float32 the last, whose f32 products never round to TF32. On a CPU tensor it
runs the plain PyTorch version of the same function (``*_reference``),
which the CPU tests hold against the JAX package's interpret-mode kernels
and ``chip_smoke.py`` holds the CUDA kernels against. A config the kernels
cannot take goes to the eager
:func:`~nif_tpu_torch.ops.shapenet.shapenet_grouped` (and autograd), as in
the JAX package.
"""
from __future__ import annotations

import ctypes
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ShapeNetConfig, shapenet_param_count
from ..layers.siren import omega_in
from . import _build
from .shapenet import shapenet_grouped, unpack_shapenet_weights

__all__ = [
    "shapenet_grouped_fused",
    "shapenet_grouped_fused_reference",
    "shapenet_fwd_cuda",
    "shapenet_mse_grads",
    "shapenet_mse_grads_reference",
    "shapenet_mse_grads_cuda",
    "shapenet_fused_bwd_reference",
    "shapenet_bwd_cuda",
    "backward_chain_reference",
    "fused_supported",
    "fused_unsupported_reason",
    "fast_sin",
    "fast_sin_grad",
    "fast_sin_and_grad",
    "fast_sin_grad2",
    "fast_sin_grad3",
    "kernel_geometry",
    "k1_geometry",
    "k1_variant",
    "k2_geometry",
    "k2_variant",
    "k3_geometry",
    "k3_variant",
    "train_geometry",
]

# sin(2*pi*t) ~ t*(c1 + c3 t^2 + c5 t^4 + c7 t^6 [+ c9 t^8]), t in [-0.5, 0.5]
_INV2PI = float(1.0 / (2.0 * np.pi))
_SIN_C = (6.28308846, -41.33324754, 81.40008977, -74.67588387, 33.16809461)
_SIN_C7 = (6.27863546, -41.09373072, 77.93034984, -56.08639487)


def _sin_degree() -> int:
    return 9 if os.environ.get("NIF_SIN_DEGREE") == "9" else 7


def _reduce(y: torch.Tensor) -> torch.Tensor:
    """t = y/2pi - round(y/2pi), rounding half to even, in [-0.5, 0.5]."""
    t = y * _INV2PI
    return t - torch.round(t)


def _sin_poly(t: torch.Tensor) -> torch.Tensor:
    s = t * t
    if _sin_degree() == 7:
        c1, c3, c5, c7 = _SIN_C7
        return t * (c1 + s * (c3 + s * (c5 + s * c7)))
    c1, c3, c5, c7, c9 = _SIN_C
    return t * (c1 + s * (c3 + s * (c5 + s * (c7 + s * c9))))


def _dsin_poly(t: torch.Tensor) -> torch.Tensor:
    """d/dt of :func:`_sin_poly` (the caller multiplies by dt/dy = 1/2pi)."""
    s = t * t
    if _sin_degree() == 7:
        c1, c3, c5, c7 = _SIN_C7
        return c1 + s * (3 * c3 + s * (5 * c5 + s * (7 * c7)))
    c1, c3, c5, c7, c9 = _SIN_C
    return c1 + s * (3 * c3 + s * (5 * c5 + s * (7 * c7 + s * (9 * c9))))


def fast_sin(y: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' sine: range-reduce to t = y/2pi - round(y/2pi)
    (half to even), then an odd minimax polynomial in t. Degree 7 (max error
    2.5e-4) by default, degree 9 (1.7e-5) under ``NIF_SIN_DEGREE=9``."""
    return _sin_poly(_reduce(y))


def fast_sin_grad(y: torch.Tensor) -> torch.Tensor:
    """d/dy of :func:`fast_sin`: the exact derivative of the polynomial."""
    return _dsin_poly(_reduce(y)) * _INV2PI


def fast_sin_and_grad(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fast_sin(y), fast_sin_grad(y)) from one range reduction."""
    t = _reduce(y)
    return _sin_poly(t), _dsin_poly(t) * _INV2PI


def fast_sin_grad2(y: torch.Tensor) -> torch.Tensor:
    """d2/dy2 of :func:`fast_sin`, the exact curvature of the polynomial:
    P''(t) = t (6 c3 + 20 c5 s + 42 c7 s^2 [+ 72 c9 s^3]), s = t^2, times
    (1/2pi)^2."""
    t = _reduce(y)
    s = t * t
    if _sin_degree() == 7:
        _, c3, c5, c7 = _SIN_C7
        poly = 6 * c3 + s * (20 * c5 + s * (42 * c7))
    else:
        _, c3, c5, c7, c9 = _SIN_C
        poly = 6 * c3 + s * (20 * c5 + s * (42 * c7 + s * (72 * c9)))
    return t * poly * (_INV2PI * _INV2PI)


def fast_sin_grad3(y: torch.Tensor) -> torch.Tensor:
    """d3/dy3 of :func:`fast_sin`, the polynomial's third derivative (the
    Hessian train kernel's backward multiplies by it): P'''(t) = 6 c3 +
    60 c5 s + 210 c7 s^2 [+ 504 c9 s^3], s = t^2, times (1/2pi)^3."""
    t = _reduce(y)
    s = t * t
    if _sin_degree() == 7:
        _, c3, c5, c7 = _SIN_C7
        poly = 6 * c3 + s * (60 * c5 + s * (210 * c7))
    else:
        _, c3, c5, c7, c9 = _SIN_C
        poly = 6 * c3 + s * (60 * c5 + s * (210 * c7 + s * (504 * c9)))
    return poly * (_INV2PI * _INV2PI * _INV2PI)


# Vanilla-chain activations the kernel implements (the JAX kernel's
# _act_pair table), evaluated on f32 pre-activations.
_VANILLA_ACTS = {
    "sine": torch.sin,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "linear": lambda z: z,
}


def _d_swish(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def _d_sigmoid(z):
    s = torch.sigmoid(z)
    return s * (1.0 - s)


# Their derivatives, as functions of the pre-activation (the JAX kernel's
# _act_pair derivative column).
_VANILLA_DERIVS = {
    "sine": torch.cos,
    "tanh": lambda z: 1.0 - torch.square(torch.tanh(z)),
    "relu": lambda z: (z > 0.0).to(z.dtype),
    "swish": _d_swish,
    "silu": _d_swish,
    "sigmoid": _d_sigmoid,
    "linear": torch.ones_like,
}


def _d2_tanh(z):
    a = torch.tanh(z)
    return -2.0 * a * (1.0 - torch.square(a))


def _d2_swish(z):
    s = torch.sigmoid(z)
    return s * (1.0 - s) * (2.0 + z * (1.0 - 2.0 * s))


def _d2_sigmoid(z):
    s = torch.sigmoid(z)
    return s * (1.0 - s) * (1.0 - 2.0 * s)


# Their second derivatives (the JAX kernel's _act_triple): reverse mode
# through a forward-mode tangent multiplies by act''.
_VANILLA_DERIVS2 = {
    "sine": lambda z: -torch.sin(z),
    "tanh": _d2_tanh,
    "relu": torch.zeros_like,
    "swish": _d2_swish,
    "silu": _d2_swish,
    "sigmoid": _d2_sigmoid,
    "linear": torch.zeros_like,
}

# Codes shared with csrc/shapenet_fwd.cu and csrc/shapenet_bwd.cu (enum
# Act, enum Chain).
_ACT_CODES = {"poly7": 0, "poly9": 1, "sine": 2, "tanh": 3, "relu": 4,
              "swish": 5, "silu": 5, "sigmoid": 6, "linear": 7}
_CHAIN_CODES = {"siren": 0, "siren_resblock": 1, "vanilla": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_geometry(cfg: ShapeNetConfig, variant: str = "siren",
                    dtype: Optional[torch.dtype] = None,
                    kernel: Optional[str] = None) -> Tuple[Optional[int], Optional[str]]:
    """``(points per block, None)`` of the CUDA K1 at this width, or ``(None,
    reason)`` when it cannot take it: of ``kernel`` ("wgmma", "tc" or
    "simt"), else of the variant :func:`k1_variant` picks for ``dtype`` (the
    CUDA-core K1 when no dtype is given). The kernels' libraries own the
    geometry, so this builds them on first use (it needs nvcc)."""
    kernel = kernel or k1_variant(dtype, cfg, variant)
    if kernel in _K1_BODIES:
        status, geo = _K1_BODIES[kernel](cfg, variant, 1, 1)
        name, holds = _K1_BODY_NAMES[kernel]
        if status == 0:
            return geo["tile"], None
        if status == 2:
            return None, (f"units={cfg.units} needs {geo['smem_bytes']} bytes of shared memory "
                          f"per block in the {name} ({holds.format(**geo)}), more than a block "
                          f"may have")
        return None, f"the {name} cannot take {cfg} (status {status})"
    status, geo = _simt_fwd_status("forward", cfg, variant, cfg.input_dim, 1, 1,
                                   dtype or torch.float32)
    if status == 0:
        return geo["tile"], None
    reason = _simt_fwd_reason(status, cfg, cfg.input_dim, geo)
    if status in (1, 2):
        return None, reason
    raise ValueError(reason)


def _simt_fwd_status(mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int,
                     dtype: torch.dtype = torch.float32):
    """``(status, geometry)`` of the CUDA-core forward body
    (``csrc/shapenet_fwd.cu``) at ``[G, P]`` in ``dtype``: ``mode``
    "forward" is K1, "reverse" K5's reverse body (so < si). The geometry
    names the body ("simt"), points per tile, the blocks of its one wave
    over every group's tiles and blocks per SM, shared memory per block, and
    where the planes sit (bfloat16's always in the global scratch) with the
    bytes of that scratch."""
    lib = _library()
    entry = (lib.nif_shapenet_fwd_geometry if mode == "forward"
             else lib.nif_shapenet_fwd_jac_rev_workspace)
    tile, blocks, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem, scratch = ctypes.c_longlong(), ctypes.c_longlong()
    status = entry(cfg.units, si, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant), G, P,
                   _DTYPE_CODES.get(dtype, 0), ctypes.byref(tile), ctypes.byref(blocks),
                   ctypes.byref(per_sm), ctypes.byref(smem), ctypes.byref(scratch))
    geo = {"mode": mode, "kernel": "simt", "body": "simt", "tile": tile.value,
           "blocks": blocks.value, "blocks_per_sm": per_sm.value, "smem_bytes": smem.value,
           "residuals": "global" if scratch.value else "shared", "weights": "shared",
           "partial_floats": 0, "scratch_bytes": scratch.value}
    return status, geo


def _simt_fwd_reason(status: int, cfg: ShapeNetConfig, si: int, geo: dict) -> Optional[str]:
    """Why the CUDA-core forward body cannot take a chain (None: it can)."""
    if status == 0:
        return None
    if status == 1:
        return (f"units={cfg.units} is wider than the CUDA kernel takes (it "
                f"keeps a thread's columns of a layer in registers)")
    if status == 2:
        return (f"input_dim={si} needs {geo['smem_bytes']} bytes of shared "
                f"memory per block, more than a block may have")
    return f"the CUDA kernel cannot take {cfg} with si={si} (geometry status {status})"


def k1_geometry(cfg: ShapeNetConfig, variant: str, G: int, P: int, dtype: torch.dtype,
                kernel: Optional[str] = None) -> dict:
    """The launch geometry of K1 at ``[G, P]`` in ``dtype`` on ``kernel``
    ("wgmma", "tc" or "simt") or the variant :func:`k1_variant` picks (it
    needs nvcc): the kernel and its body, points per tile, shared memory per
    block, and the workspace the wrapper allocates; the tensor-core bodies'
    splits a group, the CUDA-core one's blocks of one wave over every
    group's tiles. It raises where the body cannot take the shape."""
    if kernel not in (None, *_K1_BODIES, "simt"):
        raise ValueError(f"unknown K1 body {kernel!r}")
    kernel = kernel or k1_variant(dtype, cfg, variant)
    if kernel in _K1_BODIES:
        if dtype != torch.bfloat16:
            raise ValueError(f"the {_K1_BODY_NAMES[kernel][0]} takes bfloat16 inputs, "
                             f"not {dtype}")
        status, geo = _K1_BODIES[kernel](cfg, variant, G, P)
        if status != 0:
            raise ValueError(f"the {_K1_BODY_NAMES[kernel][0]} cannot take {cfg} at G={G}, "
                             f"P={P} (geometry status {status})")
        return {**geo, "body": kernel}
    status, geo = _simt_fwd_status("forward", cfg, variant, cfg.input_dim, G, P, dtype)
    if status != 0:
        raise ValueError(_simt_fwd_reason(status, cfg, cfg.input_dim, geo))
    return geo


def fused_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int, device=None,
                             dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why the fused kernel can NOT handle this config (None = it can).

    The reasons and their strings are the JAX package's; the P rule is kept
    for routing parity with it (its kernel tiles P in multiples of 8), though
    this kernel masks a ragged edge. On a CUDA ``device`` the own width
    limits of the CUDA K1 that ``dtype`` runs (:func:`kernel_geometry`; the
    CUDA-core one when no dtype is given) apply too; the plain version that
    runs elsewhere takes any width."""
    if cfg.connectivity != "full":
        return f"connectivity={cfg.connectivity!r} (fused kernel runs the full generated chain)"
    if variant == "vanilla" and cfg.activation not in _VANILLA_ACTS:
        return f"activation {cfg.activation!r} has no fused kernel implementation"
    if cfg.units < 8:
        return f"units={cfg.units} < 8 (tiny widths gain nothing from the kernel)"
    if device is not None and torch.device(device).type == "cuda":
        reason = kernel_geometry(cfg, variant, dtype)[1]
        if reason is not None:
            return reason
    if P % 8:
        return (f"points-per-group P={P} is not divisible by any supported "
                f"point tile — pad P to a multiple of 256")
    return None


def fused_supported(cfg: ShapeNetConfig, variant: str, P: int, device=None,
                    dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the fused kernel handles this config (else the eager path)."""
    return fused_unsupported_reason(cfg, variant, P, device, dtype) is None


def _n_mats(cfg: ShapeNetConfig) -> int:
    return 2 * cfg.nlayers if cfg.use_resblock else cfg.nlayers


def _prescale(wb: torch.Tensor, cfg: ShapeNetConfig, variant: str) -> torch.Tensor:
    """Fold omega_0 into the sine-fed weight matrices (all but the linear
    last layer) at wb's dtype: for bf16, ``bf16(w) * bf16(omega_0)`` rounds
    to bf16 as the JAX package's ``_prescale`` does. The weights lie first
    in the flat order, so this scales one leading slice of each row."""
    if variant != "siren":
        return wb
    k = _n_scaled(cfg, variant)
    return torch.cat([wb[..., :k] * omega_in(wb.dtype, cfg.omega_0), wb[..., k:]], dim=-1)


def _activation(cfg: ShapeNetConfig, variant: str, cdt: torch.dtype) -> Callable:
    if variant == "siren":
        return fast_sin if cdt == torch.bfloat16 else torch.sin
    return _VANILLA_ACTS[cfg.activation]


def _act_code(cfg: ShapeNetConfig, variant: str, cdt: torch.dtype) -> int:
    if variant == "siren":
        if cdt == torch.bfloat16:
            return _ACT_CODES["poly9" if _sin_degree() == 9 else "poly7"]
        return _ACT_CODES["sine"]
    return _ACT_CODES[cfg.activation]


def _train_act_code(cfg: ShapeNetConfig, variant: str, cdt: torch.dtype) -> int:
    """The activation of the residual-saving forward (K2, K3). As in the
    JAX package's ``_act_with_grad``, a bf16 sine is the polynomial in
    the vanilla chain too (its K1 forward takes the exact sine there)."""
    if variant == "siren" or cfg.activation == "sine":
        return _act_code(cfg, "siren", cdt)
    return _ACT_CODES[cfg.activation]


def _act_with_grad(cfg: ShapeNetConfig, variant: str,
                   cdt: torch.dtype) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """z -> (act(z), act'(z)) of the residual-saving forward, on f32 z."""
    if variant == "siren" or cfg.activation == "sine":
        if cdt == torch.bfloat16:
            return fast_sin_and_grad
        return lambda z: (torch.sin(z), torch.cos(z))
    act, dact = _VANILLA_ACTS[cfg.activation], _VANILLA_DERIVS[cfg.activation]
    return lambda z: (act(z), dact(z))


def _act_triple(cfg: ShapeNetConfig, variant: str, cdt: torch.dtype):
    """(act, act', act'') on f32 z of the tangent chains (K5's forward
    tangents, K6): the activation K1 takes (:func:`_act_code`), i.e. the
    JAX kernel's ``_trig2_for`` (the polynomial for a bf16 SIREN chain, the
    true sine in f32) or ``_act_triple`` (vanilla chains, exact)."""
    if variant == "siren":
        if cdt == torch.bfloat16:
            return fast_sin, fast_sin_grad, fast_sin_grad2
        return torch.sin, torch.cos, lambda z: -torch.sin(z)
    name = cfg.activation
    return _VANILLA_ACTS[name], _VANILLA_DERIVS[name], _VANILLA_DERIVS2[name]


def _act_quad(cfg: ShapeNetConfig, variant: str, cdt: torch.dtype):
    """(act, act', act'', act''') on f32 z of the Hessian chains (K7, K8),
    the JAX kernel's ``_trig3_for``: the polynomial for a bf16 SIREN chain,
    the true sine in f32. Sine chains only, as the kernels."""
    if variant != "siren":
        raise ValueError("the Hessian kernels run sine chains only")
    if cdt == torch.bfloat16:
        return fast_sin, fast_sin_grad, fast_sin_grad2, fast_sin_grad3
    return torch.sin, torch.cos, lambda z: -torch.sin(z), lambda z: -torch.cos(z)


def _n_scaled(cfg: ShapeNetConfig, variant: str) -> int:
    """How many leading entries of wb :func:`_prescale` scales (the weight
    matrices of every sine-fed layer; 0 for the vanilla chain)."""
    if variant != "siren":
        return 0
    return cfg.input_dim * cfg.units + _n_mats(cfg) * cfg.units ** 2


def _unscale_grads(d_flat: torch.Tensor, cfg: ShapeNetConfig, variant: str) -> torch.Tensor:
    """Chain rule back to the unscaled weights, dL/dW = omega_0 * dL/dW',
    on a flat f32 gradient in wb's layout (multiplied in f32 by omega_0)."""
    k = _n_scaled(cfg, variant)
    if k == 0:
        return d_flat
    return torch.cat([d_flat[..., :k] * cfg.omega_0, d_flat[..., k:]], dim=-1)


def _flat_grads(dws, dbs, G: int) -> torch.Tensor:
    """Per-layer weight and bias grads -> ``[G, po]`` in wb's flat order."""
    return torch.cat([d.reshape(G, -1) for d in dws] + [d.reshape(G, -1) for d in dbs], dim=-1)


def _chain_lists(parts):
    """The unpack dict as per-layer (weights, biases) lists in chain order."""
    return ([parts["w_first"], *parts["w_hidden"], parts["w_last"]],
            [parts["b_first"], *parts["b_hidden"], parts["b_last"]])


def _forward_saved(wbp: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig, variant: str):
    """The residual-saving forward (``_forward_layers(save=True)``) on
    prescaled weights: ``(out f32 [G, P, so], ins, dacts, ws)``. ``ins`` are
    the layer inputs at the compute dtype (x first, the last layer's input
    last); ``dacts`` the activation derivatives at the compute dtype, one per
    activated layer; ``ws`` the weight matrices in chain order."""
    cdt = x.dtype
    acc = torch.promote_types(cdt, torch.float32)
    ws, bs = _chain_lists(unpack_shapenet_weights(wbp, cfg))
    pair = _act_with_grad(cfg, variant, cdt)
    ins, dacts = [], []

    def layer(u, i):
        u_c = u.to(cdt)
        z = torch.matmul(u_c.to(acc), ws[i].to(acc)) + bs[i].to(acc).unsqueeze(-2)
        ins.append(u_c)
        a, d = pair(z)
        dacts.append(d.to(cdt))
        return a

    u = layer(x, 0)
    if variant == "siren" and cfg.use_resblock:
        for i in range(cfg.nlayers):
            h = layer(u, 1 + 2 * i)
            u = 0.5 * (u + layer(h, 2 + 2 * i))
    elif variant == "siren":
        for i in range(cfg.nlayers):
            u = layer(u, 1 + i)
    elif variant == "vanilla":
        for i in range(cfg.nlayers):
            u = layer(u, 1 + i) + u
    else:
        raise ValueError(f"unknown shapenet variant {variant!r}")
    u_last = u.to(cdt)
    ins.append(u_last)
    out = torch.matmul(u_last.to(acc), ws[-1].to(acc)) + bs[-1].to(acc).unsqueeze(-2)
    return out, ins, dacts, ws


def backward_chain_reference(go: torch.Tensor, ws, ins, dacts, cfg: ShapeNetConfig,
                             variant: str, need_dx: bool = True):
    """The plain backward of the chain (``_backward_chain``), with its
    rounding points rather than autograd's: from ``go = dL/dout`` (f32,
    ``[G, P, so]``) and the saved residuals to ``(dws, dbs, dx)``, each
    summed over P in f32 (``dx`` is None unless ``need_dx``)."""
    cdt = ins[-1].dtype
    acc = torch.promote_types(cdt, torch.float32)

    def lift(a):
        return a.to(cdt).to(acc)

    def d32(k):
        return dacts[k].to(acc)

    def w_grad(a, dz_c):  # a^T @ dz over the points: [G, K, n]
        return torch.matmul(a.to(acc).transpose(-1, -2), dz_c)

    def back(dz_c, w):  # dz @ w^T: [G, P, K]
        return torch.matmul(dz_c, w.to(acc).transpose(-1, -2))

    n_w = len(ws)
    dws, dbs = [None] * n_w, [None] * n_w
    go_c = lift(go)
    dws[-1] = w_grad(ins[-1], go_c)
    dbs[-1] = go_c.sum(dim=-2)
    if ws[-1].shape[-1] == 1:
        # so == 1: a broadcast product with the last weight column, on the
        # f32 go (not a matmul of the lifted go)
        du = go.to(acc) * ws[-1][..., 0].to(acc).unsqueeze(-2)
    else:
        du = back(go_c, ws[-1])

    l = cfg.nlayers
    if variant == "siren" and cfg.use_resblock:
        for i in range(l - 1, -1, -1):
            dz2_c = lift(0.5 * du * d32(2 + 2 * i))
            dws[2 + 2 * i] = w_grad(ins[2 + 2 * i], dz2_c)
            dbs[2 + 2 * i] = dz2_c.sum(dim=-2)
            dh = back(dz2_c, ws[2 + 2 * i])
            dz1_c = lift(dh * d32(1 + 2 * i))
            dws[1 + 2 * i] = w_grad(ins[1 + 2 * i], dz1_c)
            dbs[1 + 2 * i] = dz1_c.sum(dim=-2)
            du = 0.5 * du + back(dz1_c, ws[1 + 2 * i])
    else:
        for i in range(l - 1, -1, -1):
            dz_c = lift(du * d32(1 + i))
            dws[1 + i] = w_grad(ins[1 + i], dz_c)
            dbs[1 + i] = dz_c.sum(dim=-2)
            back_i = back(dz_c, ws[1 + i])
            # the vanilla shortcut adds the gradient straight through
            du = du + back_i if variant == "vanilla" else back_i

    dz0_c = lift(du * d32(0))
    dws[0] = w_grad(ins[0], dz0_c)
    dbs[0] = dz0_c.sum(dim=-2)
    dx = back(dz0_c, ws[0]) if need_dx else None
    return dws, dbs, dx


def shapenet_mse_grads_reference(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                 cfg: ShapeNetConfig, variant: str = "siren",
                                 weight: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K2: ``(loss, d_wb)`` of
    ``mean(weight * (shapenet(wb, x) - target)^2)`` over the G*P*so
    outputs, with K2's rounding points. The target and the weight are cast
    to x's dtype; the error is taken against the f32 output; the loss is f32
    and ``d_wb`` is in wb's dtype."""
    G, P, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    out, ins, dacts, ws = _forward_saved(_prescale(wb, cfg, variant), x, cfg, variant)
    err = out - target.to(x.dtype).to(acc)
    if weight is None:
        loss = torch.sum(torch.square(err))
        go = 2.0 * err
    else:
        w = weight.to(x.dtype).to(acc).unsqueeze(-1)
        loss = torch.sum(torch.square(err) * w)
        go = 2.0 * err * w
    dws, dbs, _ = backward_chain_reference(go, ws, ins, dacts, cfg, variant, need_dx=False)
    n_elem = G * P * cfg.output_dim
    d_wb = _unscale_grads(_flat_grads(dws, dbs, G), cfg, variant) / n_elem
    return loss / n_elem, d_wb.to(wb.dtype)


def shapenet_fused_bwd_reference(wb: torch.Tensor, x: torch.Tensor, g_out: torch.Tensor,
                                 cfg: ShapeNetConfig, variant: str = "siren"):
    """The plain PyTorch version of K3: recompute the forward with its
    residuals, then take ``g_out [G, P, so]`` to ``(d_wb, dx)`` in wb's and
    x's dtypes. ``dx`` goes through the prescaled first matrix."""
    acc = torch.promote_types(x.dtype, torch.float32)
    _, ins, dacts, ws = _forward_saved(_prescale(wb, cfg, variant), x, cfg, variant)
    dws, dbs, dx = backward_chain_reference(g_out.to(acc), ws, ins, dacts, cfg, variant)
    d_wb = _unscale_grads(_flat_grads(dws, dbs, x.shape[0]), cfg, variant)
    return d_wb.to(wb.dtype), dx.to(x.dtype)


def shapenet_grouped_fused_reference(wb: torch.Tensor, x: torch.Tensor,
                                     cfg: ShapeNetConfig,
                                     variant: str = "siren") -> torch.Tensor:
    """The plain PyTorch version of K1, with the kernel's rounding points.

    Products are taken as ``u.to(cdt).float() @ w.float()`` so bf16 operands
    sum in f32 exactly as the kernel's f32-accumulated matmul does (a bf16
    ``torch.matmul`` would round its output to bf16 as well)."""
    cdt = x.dtype
    acc_dt = torch.promote_types(cdt, torch.float32)
    parts = unpack_shapenet_weights(_prescale(wb, cfg, variant), cfg)
    act = _activation(cfg, variant, cdt)

    def layer(u, w, b):
        z = torch.matmul(u.to(cdt).to(acc_dt), w.to(acc_dt))
        return act(z + b.to(acc_dt).unsqueeze(-2))

    ws, bs = parts["w_hidden"], parts["b_hidden"]
    u = layer(x, parts["w_first"], parts["b_first"])
    if variant == "siren" and cfg.use_resblock:
        for i in range(cfg.nlayers):
            h = layer(u, ws[2 * i], bs[2 * i])
            u = 0.5 * (u + layer(h, ws[2 * i + 1], bs[2 * i + 1]))
    elif variant == "siren":
        for i in range(cfg.nlayers):
            u = layer(u, ws[i], bs[i])
    elif variant == "vanilla":
        for i in range(cfg.nlayers):
            u = layer(u, ws[i], bs[i]) + u
    else:
        raise ValueError(f"unknown shapenet variant {variant!r}")
    out = torch.matmul(u.to(cdt).to(acc_dt), parts["w_last"].to(acc_dt))
    return (out + parts["b_last"].to(acc_dt).unsqueeze(-2)).to(x.dtype)


def _library() -> ctypes.CDLL:
    """The CUDA-core K1 and K5's CUDA-core reverse body
    (``csrc/shapenet_fwd.cu``)."""
    lib = _build.load_library("shapenet_fwd")
    if lib.nif_shapenet_fwd.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        for entry in (lib.nif_shapenet_fwd_geometry, lib.nif_shapenet_fwd_jac_rev_workspace):
            entry.argtypes = [c_int] * 8 + [ptr] * 5
            entry.restype = c_int
        lib.nif_shapenet_fwd.argtypes = [ptr] * 4 + [c_int] * 8 + [c_ll, c_ll, c_int, ptr]
        lib.nif_shapenet_fwd.restype = c_int
        lib.nif_shapenet_fwd_jac_rev.argtypes = [ptr] * 5 + [c_int] * 8 + [c_ll, c_ll, c_int, ptr]
        lib.nif_shapenet_fwd_jac_rev.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _fwd_tc_library() -> ctypes.CDLL:
    """The tensor-core K1 and K5's tensor-core reverse body
    (``csrc/shapenet_fwd_tc.cu``)."""
    lib = _build.load_library("shapenet_fwd_tc")
    if lib.nif_shapenet_fwd_tc.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        for entry in (lib.nif_shapenet_fwd_tc_workspace, lib.nif_shapenet_fwd_jac_tc_workspace):
            entry.argtypes = [c_int] * 7 + [ptr] * 7
            entry.restype = c_int
        lib.nif_shapenet_fwd_tc.argtypes = [ptr] * 4 + [c_int] * 8 + [c_ll, c_ll, ptr]
        lib.nif_shapenet_fwd_tc.restype = c_int
        lib.nif_shapenet_fwd_jac_tc.argtypes = [ptr] * 5 + [c_int] * 8 + [c_ll, c_ll, ptr]
        lib.nif_shapenet_fwd_jac_tc.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _fwd_wg_library() -> ctypes.CDLL:
    """The wgmma K1 and K5's wgmma reverse body
    (``csrc/shapenet_fwd_wgmma.cu``): the C entries of the ``mma.sync``
    body's library, under their own names."""
    lib = _build.load_library("shapenet_fwd_wgmma")
    if lib.nif_shapenet_fwd_wg.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        for entry in (lib.nif_shapenet_fwd_wg_workspace, lib.nif_shapenet_fwd_jac_wg_workspace):
            entry.argtypes = [c_int] * 7 + [ptr] * 7
            entry.restype = c_int
        lib.nif_shapenet_fwd_wg.argtypes = [ptr] * 4 + [c_int] * 8 + [c_ll, c_ll, ptr]
        lib.nif_shapenet_fwd_wg.restype = c_int
        lib.nif_shapenet_fwd_jac_wg.argtypes = [ptr] * 5 + [c_int] * 8 + [c_ll, c_ll, ptr]
        lib.nif_shapenet_fwd_jac_wg.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load_library("shapenet_bwd")
    if lib.nif_shapenet_mse_grads.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        shape = [c_int] * 8 + [c_ll] * 3 + [ctypes.c_float, c_int, ptr]
        lib.nif_shapenet_mse_grads.argtypes = [ptr] * 8 + shape
        lib.nif_shapenet_mse_grads.restype = c_int
        lib.nif_shapenet_bwd.argtypes = [ptr] * 7 + shape
        lib.nif_shapenet_bwd.restype = c_int
        lib.nif_shapenet_bwd_workspace.argtypes = [c_int] * 8 + [ptr] * 5
        lib.nif_shapenet_bwd_workspace.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_tc_library() -> ctypes.CDLL:
    lib = _build.load_library("shapenet_bwd_tc")
    if lib.nif_shapenet_mse_grads_tc.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.nif_shapenet_mse_tc_workspace.argtypes = [c_int] * 7 + [ptr] * 7
        lib.nif_shapenet_mse_tc_workspace.restype = c_int
        lib.nif_shapenet_mse_grads_tc.argtypes = (
            [ptr] * 8 + [c_int] * 8 + [c_ll] * 3 + [ctypes.c_float, ptr])
        lib.nif_shapenet_mse_grads_tc.restype = c_int
        lib.nif_shapenet_bwd_tc_workspace.argtypes = [c_int] * 7 + [ptr] * 7
        lib.nif_shapenet_bwd_tc_workspace.restype = c_int
        lib.nif_shapenet_bwd_tc.argtypes = (
            [ptr] * 7 + [c_int] * 8 + [c_ll] * 3 + [ctypes.c_float, ptr])
        lib.nif_shapenet_bwd_tc.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_wg_library() -> ctypes.CDLL:
    """The wgmma K2 and K3 (``csrc/shapenet_bwd_wgmma.cu``): the C entries
    of the ``mma.sync`` body's library, under their own names."""
    lib = _build.load_library("shapenet_bwd_wgmma")
    if lib.nif_shapenet_mse_grads_wg.argtypes is None:
        c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.nif_shapenet_mse_wg_workspace.argtypes = [c_int] * 7 + [ptr] * 7
        lib.nif_shapenet_mse_wg_workspace.restype = c_int
        lib.nif_shapenet_mse_grads_wg.argtypes = (
            [ptr] * 8 + [c_int] * 8 + [c_ll] * 3 + [ctypes.c_float, ptr])
        lib.nif_shapenet_mse_grads_wg.restype = c_int
        lib.nif_shapenet_bwd_wg_workspace.argtypes = [c_int] * 7 + [ptr] * 7
        lib.nif_shapenet_bwd_wg_workspace.restype = c_int
        lib.nif_shapenet_bwd_wg.argtypes = (
            [ptr] * 7 + [c_int] * 8 + [c_ll] * 3 + [ctypes.c_float, ptr])
        lib.nif_shapenet_bwd_wg.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stack_tc_status(workspace, mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int,
                     P: int, kernel: str = "tc"):
    """``(status, geometry)`` of a stacked-stream tensor-core kernel (K1, K2,
    K3, K5, K6, K7 or K8, or the wgmma K2 and K3: ``kernel="wgmma"``) from
    its library's ``workspace`` entry."""
    tile, splits, resident, staged_w = (ctypes.c_int() for _ in range(4))
    smem, partial_floats, scratch = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    status = workspace(
        cfg.units, si, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant), G, P,
        ctypes.byref(tile), ctypes.byref(splits), ctypes.byref(smem), ctypes.byref(resident),
        ctypes.byref(staged_w), ctypes.byref(partial_floats), ctypes.byref(scratch))
    geo = {"mode": mode, "kernel": kernel, "tile": tile.value, "splits": splits.value,
           "smem_bytes": smem.value, "residuals": "shared" if resident.value else "global",
           "weights": "shared" if staged_w.value else "global",
           "partial_floats": partial_floats.value, "scratch_bytes": scratch.value}
    return status, geo


def _k1_tc_status(cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K1 (``csrc/shapenet_fwd_tc.cu``)."""
    return _stack_tc_status(_fwd_tc_library().nif_shapenet_fwd_tc_workspace, "forward", cfg,
                            variant, cfg.input_dim, G, P)


def _wg_fwd_status(mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int):
    """``(status, geometry)`` of the wgmma K1 (``mode="forward"``) or K5
    reverse body (``"reverse"``) of ``csrc/shapenet_fwd_wgmma.cu``; a chain
    it has no instance for (a width other than 64 or 128, a vanilla chain)
    is status 3 without asking its library."""
    if variant != "siren" or cfg.units not in _WGMMA_WIDTHS:
        return 3, {"mode": mode, "kernel": "wgmma"}
    lib = _fwd_wg_library()
    entry = (lib.nif_shapenet_fwd_wg_workspace if mode == "forward"
             else lib.nif_shapenet_fwd_jac_wg_workspace)
    return _stack_tc_status(entry, mode, cfg, variant, si, G, P, kernel="wgmma")


def _k1_wg_status(cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(status, geometry)`` of the wgmma K1 (``csrc/shapenet_fwd_wgmma.cu``)."""
    return _wg_fwd_status("forward", cfg, variant, cfg.input_dim, G, P)


# K1's bf16 bodies with their geometry, in the order a launch prefers them,
# and each one's name and what its shared memory holds (for a refusal)
_K1_BODIES = {"wgmma": _k1_wg_status, "tc": _k1_tc_status}
_K1_BODY_NAMES = {"wgmma": ("wgmma K1", "every W_m staged"),
                  "tc": ("tensor-core K1", "two planes of {tile} points")}


def _k1_routed(cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(body, geometry)`` of the first bf16 K1 body whose geometry takes
    ``[G, P]`` (one query a body), or ``(None, None)``."""
    for body, status in _K1_BODIES.items():
        code, geo = status(cfg, variant, G, P)
        if code == 0:
            return body, {**geo, "body": body}
    return None, None


def k1_variant(dtype: Optional[torch.dtype], cfg: Optional[ShapeNetConfig] = None,
               variant: str = "siren") -> str:
    """Which CUDA kernel K1 runs for inputs of ``dtype``. bfloat16 sine
    chains run, in order of preference, the body whose geometry takes the
    chain: ``"wgmma"`` (``csrc/shapenet_fwd_wgmma.cu``, Hopper's warpgroup
    products with the activations in registers; widths 64 and 128, si and
    so <= 4), ``"tc"`` (the ``mma.sync`` body, ``csrc/shapenet_fwd_tc.cu``;
    si <= 4 and a width whose planes fit), then ``"simt"`` (the CUDA-core
    kernel, ``csrc/shapenet_fwd.cu``). float32 (and any other dtype, which
    the wrapper refuses) runs ``"simt"``, whose products stay full f32.
    Without a chain bfloat16 names ``"tc"``, the body that takes every sine
    chain the tensor cores do. Given a chain this asks the bodies' libraries
    (it needs nvcc): the wgmma library only for a width it has instances
    for."""
    if dtype != torch.bfloat16:
        return "simt"
    if cfg is None:
        return "tc"
    return _k1_routed(cfg, variant, 1, 1)[0] or "simt"


def _k2_tc_status(cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K2 (``csrc/shapenet_bwd_tc.cu``)."""
    return _stack_tc_status(_bwd_tc_library().nif_shapenet_mse_tc_workspace, "train", cfg,
                            variant, cfg.input_dim, G, P)


def _k3_tc_status(cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K3 (``csrc/shapenet_bwd_tc.cu``,
    beside the tensor-core K2)."""
    return _stack_tc_status(_bwd_tc_library().nif_shapenet_bwd_tc_workspace, "backward", cfg,
                            variant, cfg.input_dim, G, P)


#: The widths the wgmma bodies (K1 and K5's reverse body, K2 and K3) have
#: instances for; each library's workspace entry decides the rest of the
#: chain (and shared memory).
_WGMMA_WIDTHS = (64, 128)


def _wg_status(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int):
    """``(status, geometry)`` of the wgmma K2 (``mode="train"``) or K3
    (``"backward"``) of ``csrc/shapenet_bwd_wgmma.cu``; a chain it has no
    instance for (a width other than 64 or 128, a vanilla chain) is status
    3 without asking its library."""
    if variant != "siren" or cfg.units not in _WGMMA_WIDTHS:
        return 3, None
    lib = _bwd_wg_library()
    entry = (lib.nif_shapenet_mse_wg_workspace if mode == "train"
             else lib.nif_shapenet_bwd_wg_workspace)
    return _stack_tc_status(entry, mode, cfg, variant, cfg.input_dim, G, P, kernel="wgmma")


# K2's and K3's bf16 bodies, each with its geometry
_BODY_STATUS = {
    "train": {"wgmma": lambda *a: _wg_status("train", *a), "tc": _k2_tc_status},
    "backward": {"wgmma": lambda *a: _wg_status("backward", *a), "tc": _k3_tc_status},
}
# ... and the bodies a launch routes to, in order of preference
_ROUTE = {"train": ("wgmma", "tc"), "backward": ("wgmma", "tc")}


def _train_variant(mode: str, dtype: torch.dtype, cfg: Optional[ShapeNetConfig],
                   variant: str) -> str:
    if dtype != torch.bfloat16:
        return "simt"
    if cfg is None:
        return "tc"
    for body in _ROUTE[mode]:
        if _BODY_STATUS[mode][body](cfg, variant, 1, 1)[0] == 0:
            return body
    return "simt"


def k2_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None,
               variant: str = "siren") -> str:
    """Which CUDA kernel K2 runs for inputs of ``dtype``. bfloat16 sine
    chains run, in order of preference, the body whose geometry takes the
    chain: ``"wgmma"`` (``csrc/shapenet_bwd_wgmma.cu``, Hopper's warpgroup
    products fed by TMA; widths 64 and 128 whose planes and weights fit its
    shared memory), ``"tc"`` (the ``mma.sync`` body,
    ``csrc/shapenet_bwd_tc.cu``; si <= 4 and a width whose two working
    planes fit), then ``"simt"`` (the CUDA-core kernel,
    ``csrc/shapenet_bwd.cu``). float32 (and any other dtype, which the
    wrapper refuses) runs ``"simt"``, whose products stay full f32. Without a
    chain bfloat16 names ``"tc"``, the body that takes every sine chain the
    tensor cores do. Given a chain this asks the bodies' libraries (it needs
    nvcc): the wgmma library only for a width it has instances for."""
    return _train_variant("train", dtype, cfg, variant)


def k3_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None,
               variant: str = "siren") -> str:
    """Which CUDA kernel K3 runs for inputs of ``dtype``: the bodies and the
    order of :func:`k2_variant` (the K3 mode of each library; the wgmma,
    ``mma.sync`` and CUDA-core bodies in ``shapenet_bwd_wgmma.cu``,
    ``shapenet_bwd_tc.cu`` and ``shapenet_bwd.cu``)."""
    return _train_variant("backward", dtype, cfg, variant)


def _train_body_geometry(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int,
                         dtype: torch.dtype, kernel: Optional[str]) -> dict:
    """The geometry of K2 (``mode="train"``) or K3 at ``[G, P]`` on
    ``kernel`` ("wgmma", "tc" or "simt"; it raises if that body cannot take
    the shape) or, with ``kernel=None``, on the first bf16 body of the
    mode's route (:func:`k2_variant`, :func:`k3_variant`) whose geometry
    takes this shape (one query a body), else the CUDA-core one."""
    if kernel not in (None, "wgmma", "tc", "simt"):
        raise ValueError(f"unknown K2/K3 body {kernel!r}")
    if dtype == torch.bfloat16 and kernel != "simt":
        for body in _ROUTE[mode] if kernel is None else (kernel,):
            code, geo = _BODY_STATUS[mode][body](cfg, variant, G, P)
            if code == 0:
                return geo
            if kernel is not None:
                raise ValueError(f"the {body} K2/K3 body cannot take {cfg} at G={G}, "
                                 f"P={P} (geometry status {code})")
    elif kernel not in (None, "simt"):
        raise ValueError(f"the {kernel} K2/K3 body takes bfloat16 inputs, not {dtype}")
    return {"kernel": "simt", **train_geometry(cfg, G, P, dtype, variant)}


def k2_geometry(cfg: ShapeNetConfig, variant: str, G: int, P: int, dtype: torch.dtype,
                kernel: Optional[str] = None) -> dict:
    """The launch geometry of K2 at ``[G, P]`` in ``dtype`` on ``kernel``
    ("wgmma", "tc" or "simt") or the body a launch at this shape takes (it
    needs nvcc): the kernel, points per tile, P splits per group, shared
    memory per block, where a tile's residuals sit, and the workspace sizes
    the wrapper allocates."""
    return _train_body_geometry("train", cfg, variant, G, P, dtype, kernel)


def k3_geometry(cfg: ShapeNetConfig, variant: str, G: int, P: int, dtype: torch.dtype,
                kernel: Optional[str] = None) -> dict:
    """The launch geometry of K3, as :func:`k2_geometry`'s."""
    return _train_body_geometry("backward", cfg, variant, G, P, dtype, kernel)


def train_geometry(cfg: ShapeNetConfig, G: int, P: int, dtype: torch.dtype,
                   variant: str = "siren") -> dict:
    """The launch geometry the CUDA-core K2 and K3 take for ``[G, P]`` at
    this width, chain and dtype, from the kernels' library (it needs nvcc):
    points per tile, P splits per group (SMs / G, one block per SM),
    shared memory per block, whether the residuals of a tile sit in shared
    memory or in a per-block global scratch, and the workspace sizes the
    wrappers allocate."""
    tile, splits = ctypes.c_int(), ctypes.c_int()
    smem, partial_floats, scratch = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    status = _bwd_library().nif_shapenet_bwd_workspace(
        cfg.units, cfg.input_dim, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant), G, P,
        _DTYPE_CODES[dtype],
        ctypes.byref(tile), ctypes.byref(splits), ctypes.byref(smem),
        ctypes.byref(partial_floats), ctypes.byref(scratch))
    if status != 0:
        raise ValueError(f"the CUDA train kernels cannot take {cfg} at G={G}, P={P} "
                         f"(geometry status {status})")
    return {"tile": tile.value, "splits": splits.value, "smem_bytes": smem.value,
            "residuals": "global" if scratch.value else "shared",
            "partial_floats": partial_floats.value, "scratch_bytes": scratch.value}


def _check_cuda_inputs(name: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                       variant: str, unsupported: Callable = None) -> None:
    """What every CUDA wrapper refuses: tensors off CUDA, a dtype other than
    float32/bfloat16 (wb and x must share it), shapes that do not match
    ``cfg``, or a config the kernel cannot take: ``unsupported(cfg, variant,
    P, device)`` says why (default :func:`fused_unsupported_reason`)."""
    unsupported = unsupported or fused_unsupported_reason
    if variant not in ("siren", "vanilla"):
        raise ValueError(f"unknown shapenet variant {variant!r}")
    if not (x.is_cuda and wb.is_cuda and wb.device == x.device):
        raise ValueError(f"{name} needs wb and x on one CUDA device, "
                         f"got {wb.device} and {x.device}")
    if x.dtype not in _DTYPE_CODES or wb.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 wb and x of "
                        f"one dtype, got {wb.dtype} and {x.dtype}")
    if wb.requires_grad or x.requires_grad:
        raise RuntimeError(f"{name} has no backward of its own: call it on detached "
                           f"tensors, or differentiate through shapenet_grouped_fused")
    if x.dim() != 3 or wb.dim() != 2 or wb.shape[0] != x.shape[0]:
        raise ValueError(f"expected wb [G, po] and x [G, P, si], got "
                         f"{tuple(wb.shape)} and {tuple(x.shape)}")
    reason = unsupported(cfg, variant, x.shape[1], x.device)
    if reason is not None:
        raise ValueError(f"{name} cannot take this config: {reason}")
    if x.shape[2] != cfg.input_dim or wb.shape[1] != shapenet_param_count(cfg, 0):
        raise ValueError(f"wb {tuple(wb.shape)} / x {tuple(x.shape)} do not match {cfg}")


def _chain_code(cfg: ShapeNetConfig, variant: str) -> int:
    if variant == "siren":
        return _CHAIN_CODES["siren_resblock" if cfg.use_resblock else "siren"]
    return _CHAIN_CODES["vanilla"]


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.nif_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


# each bf16 K1 body's library, its C entry and its launch counter
_K1_ENTRIES = {"wgmma": (_fwd_wg_library, "nif_shapenet_fwd_wg", "shapenet_fwd_wg"),
               "tc": (_fwd_tc_library, "nif_shapenet_fwd_tc", "shapenet_fwd_tc")}


def _launch_k1(kernel: Optional[str], wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
               variant: str) -> torch.Tensor:
    """K1 after the wrapper's checks, counting the launch: on ``kernel``
    ("wgmma", "tc" or "simt"; it raises where that body cannot take the
    shape) or, for ``None``, on the first bf16 body of :func:`k1_variant`'s
    order whose geometry takes this shape (one query a body decides, and
    gives the launch its scratch size), else on the CUDA-core kernel."""
    _check_cuda_inputs("shapenet_fwd_cuda", wb, x, cfg, variant)
    G, P, si = x.shape
    out = torch.empty((G, P, cfg.output_dim), dtype=x.dtype, device=x.device)
    if G == 0 or P == 0:
        return out
    wbp = _prescale(wb, cfg, variant).contiguous()
    x = x.contiguous()
    with torch.cuda.device(x.device):  # the geometry reads this device's SM count
        body, geo = None, None
        if kernel is None:
            if x.dtype == torch.bfloat16:
                body, geo = _k1_routed(cfg, variant, G, P)
        elif kernel != "simt":
            geo = k1_geometry(cfg, variant, G, P, x.dtype, kernel=kernel)
            body = kernel
        if body is None:
            geo = k1_geometry(cfg, variant, G, P, x.dtype, kernel="simt")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        shape = (G, P, si, cfg.output_dim, cfg.units, _n_mats(cfg))
        codes = (_chain_code(cfg, variant), _act_code(cfg, variant, x.dtype), wb.shape[1])
        scratch = torch.empty(max(geo["scratch_bytes"], 1), dtype=torch.uint8, device=x.device)
        if body is not None:
            # rows padded to 16 bytes: W_m stages with cp.async (tc) or TMA (wgmma)
            wbp = F.pad(wbp, (0, -wbp.shape[1] % 8))
            library, entry, counter = _K1_ENTRIES[body]
            lib = library()
            err = getattr(lib, entry)(wbp.data_ptr(), x.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), *shape, *codes, wbp.shape[1], stream)
        else:
            wbp = _simt_weights(wbp)
            lib = _library()
            err = lib.nif_shapenet_fwd(wbp.data_ptr(), x.data_ptr(), out.data_ptr(),
                                       scratch.data_ptr(), *shape, *codes, wbp.shape[1],
                                       _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "shapenet_fwd", err)
    _build.LAUNCHES["shapenet_fwd"] += 1
    if body is not None:
        _build.LAUNCHES[counter] += 1
    return out


def shapenet_fwd_cuda(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                      variant: str = "siren") -> torch.Tensor:
    """Launch K1 on ``torch.cuda.current_stream()``, through the kernel
    :func:`k1_variant` picks for the dtype and the chain.

    Raises on anything the kernel does not take (:func:`_check_cuda_inputs`),
    including an input that requires grad: :func:`shapenet_grouped_fused`
    is the differentiable entry. A build or launch failure raises too;
    nothing here falls back to another path."""
    return _launch_k1(None, wb, x, cfg, variant)


def _shapenet_fwd_on(kernel: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                     variant: str = "siren") -> torch.Tensor:
    """K1 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape. ``chip_smoke.py``
    and the probes time the bodies side by side on the same inputs."""
    return _launch_k1(kernel, wb, x, cfg, variant)


def _shapenet_fwd_simt(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                       variant: str = "siren") -> torch.Tensor:
    """K1 on the CUDA-core kernel whatever the dtype and chain.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k1("simt", wb, x, cfg, variant)


def _simt_weights(wbp: torch.Tensor) -> torch.Tensor:
    """wb' as the CUDA-core K2/K3 read it: f32 (a bf16 value is exact in
    f32), rows padded to a multiple of 4 floats so every group's W_m stages
    with 16-byte cp.async copies."""
    return F.pad(wbp.float(), (0, -wbp.shape[1] % 4)).contiguous()


def _shape_args(cfg: ShapeNetConfig, variant: str, x: torch.Tensor, po: int):
    G, P, si = x.shape
    return (G, P, si, cfg.output_dim, cfg.units, _n_mats(cfg), _chain_code(cfg, variant),
            _train_act_code(cfg, variant, x.dtype), po, _n_scaled(cfg, variant),
            float(cfg.omega_0) if variant == "siren" else 1.0, _DTYPE_CODES[x.dtype])


def _train_launch_setup(kernel: Optional[str], mode: str, wb: torch.Tensor, x: torch.Tensor,
                        cfg: ShapeNetConfig, variant: str):
    """What a K2 (``mode="train"``) or K3 (``"backward"``) launch takes,
    under the tensor's device (the geometry reads its SM count): ``(kernel,
    wb', partials, scratch)``. The kernel is ``kernel`` or, for ``None``, the
    body :func:`k2_variant`'s order picks at this shape (one geometry query a
    body decides and sizes the workspace); wb' is prescaled as that kernel
    reads it."""
    G, P, _ = x.shape
    geo = _train_body_geometry(mode, cfg, variant, G, P, x.dtype, kernel)
    wbp = _prescale(wb, cfg, variant).contiguous()
    if geo["kernel"] == "simt":
        wbp = _simt_weights(wbp)
    else:  # rows padded to 16 bytes: W_m stages with cp.async (tc) or TMA (wgmma)
        wbp = F.pad(wbp, (0, -wbp.shape[1] % 8))
    partials = torch.empty(geo["partial_floats"], dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(geo["scratch_bytes"], 1), dtype=torch.uint8, device=x.device)
    return geo["kernel"], wbp, partials, scratch


# each body's library and its K2 and K3 C entries, and its launch counters' suffix
_TRAIN_ENTRIES = {
    "wgmma": (_bwd_wg_library, "nif_shapenet_mse_grads_wg", "nif_shapenet_bwd_wg", "_wg"),
    "tc": (_bwd_tc_library, "nif_shapenet_mse_grads_tc", "nif_shapenet_bwd_tc", "_tc"),
    "simt": (_bwd_library, "nif_shapenet_mse_grads", "nif_shapenet_bwd", None),
}


def _launch_k2(kernel: Optional[str], wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
               cfg: ShapeNetConfig, variant: str, weight: Optional[torch.Tensor]):
    """K2 after the wrapper's checks, counting the launch: on ``kernel``
    ("wgmma", "tc" or "simt"), or the body :func:`k2_variant`'s order picks
    for ``None`` (:func:`_train_launch_setup`)."""
    _check_cuda_inputs("shapenet_mse_grads_cuda", wb, x, cfg, variant)
    G, P, _ = x.shape
    if tuple(target.shape) != (G, P, cfg.output_dim) or target.device != x.device:
        raise ValueError(f"target {tuple(target.shape)} on {target.device} is not "
                         f"[G, P, so] = {(G, P, cfg.output_dim)} on {x.device}")
    if weight is not None and (tuple(weight.shape) != (G, P) or weight.device != x.device):
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} is not "
                         f"[G, P] = {(G, P)} on {x.device}")
    d_wb = torch.empty_like(wb, memory_format=torch.contiguous_format)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    if G == 0 or P == 0:
        return loss.fill_(float("nan")), d_wb.zero_()
    with torch.cuda.device(x.device):
        kernel, wbp, partials, scratch = _train_launch_setup(kernel, "train", wb, x, cfg, variant)
        x = x.contiguous()
        target = target.to(x.dtype).contiguous()
        weight = None if weight is None else weight.to(x.dtype).contiguous()
        library, entry, _, suffix = _TRAIN_ENTRIES[kernel]
        lib = library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), target.data_ptr(),
                None if weight is None else weight.data_ptr(), loss.data_ptr(), d_wb.data_ptr(),
                partials.data_ptr(), scratch.data_ptr())
        # (G, P, si, so, n, n_mats, chain, act, po), wb_ld, n_scaled, omega[, dtype]
        shape = _shape_args(cfg, variant, x, wb.shape[1])
        if suffix:
            err = getattr(lib, entry)(*args, *shape[:9], wbp.shape[1], *shape[9:11], stream)
        else:
            err = getattr(lib, entry)(*args, *shape[:9], wbp.shape[1], *shape[9:], stream)
    _raise_on_error(lib, "shapenet_mse_grads", err)
    _build.LAUNCHES["shapenet_mse_grads"] += 1
    if suffix:
        _build.LAUNCHES["shapenet_mse_grads" + suffix] += 1
    return loss, d_wb


def shapenet_mse_grads_cuda(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                            cfg: ShapeNetConfig, variant: str = "siren",
                            weight: Optional[torch.Tensor] = None):
    """Launch K2 on ``torch.cuda.current_stream()``: ``(loss, d_wb)`` as
    :func:`shapenet_mse_grads_reference` computes them, through the kernel
    :func:`k2_variant` picks for the dtype and the chain. ``target`` must be
    ``[G, P, so]`` and ``weight`` (optional) ``[G, P]``; both are cast to x's
    dtype. Raises on anything that kernel does not take; never falls back."""
    return _launch_k2(None, wb, x, target, cfg, variant, weight)


def _shapenet_mse_grads_on(kernel: str, wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                           cfg: ShapeNetConfig, variant: str = "siren",
                           weight: Optional[torch.Tensor] = None):
    """K2 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape. ``chip_smoke.py``
    and the probes time the bodies side by side on the same inputs."""
    return _launch_k2(kernel, wb, x, target, cfg, variant, weight)


def _shapenet_mse_grads_simt(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                             cfg: ShapeNetConfig, variant: str = "siren",
                             weight: Optional[torch.Tensor] = None):
    """K2 on the CUDA-core kernel whatever the dtype and chain.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k2("simt", wb, x, target, cfg, variant, weight)


def _launch_k3(kernel: Optional[str], wb: torch.Tensor, x: torch.Tensor, g_out: torch.Tensor,
               cfg: ShapeNetConfig, variant: str):
    """K3 after the wrapper's checks, counting the launch: on ``kernel`` or
    the body :func:`k3_variant`'s order picks for ``None``
    (:func:`_train_launch_setup`)."""
    _check_cuda_inputs("shapenet_bwd_cuda", wb, x, cfg, variant)
    G, P, _ = x.shape
    if tuple(g_out.shape) != (G, P, cfg.output_dim) or g_out.device != x.device:
        raise ValueError(f"g_out {tuple(g_out.shape)} on {g_out.device} is not "
                         f"[G, P, so] = {(G, P, cfg.output_dim)} on {x.device}")
    d_wb = torch.empty_like(wb, memory_format=torch.contiguous_format)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if G == 0 or P == 0:
        return d_wb.zero_(), dx
    with torch.cuda.device(x.device):
        kernel, wbp, partials, scratch = _train_launch_setup(kernel, "backward", wb, x, cfg,
                                                             variant)
        x = x.contiguous()
        g_out = g_out.to(x.dtype).contiguous()
        library, _, entry, suffix = _TRAIN_ENTRIES[kernel]
        lib = library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), g_out.data_ptr(), d_wb.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), scratch.data_ptr())
        # (G, P, si, so, n, n_mats, chain, act, po), wb_ld, n_scaled, omega[, dtype]
        shape = _shape_args(cfg, variant, x, wb.shape[1])
        if suffix:
            err = getattr(lib, entry)(*args, *shape[:9], wbp.shape[1], *shape[9:11], stream)
        else:
            err = getattr(lib, entry)(*args, *shape[:9], wbp.shape[1], *shape[9:], stream)
    _raise_on_error(lib, "shapenet_bwd", err)
    _build.LAUNCHES["shapenet_bwd"] += 1
    if suffix:
        _build.LAUNCHES["shapenet_bwd" + suffix] += 1
    return d_wb, dx


def shapenet_bwd_cuda(wb: torch.Tensor, x: torch.Tensor, g_out: torch.Tensor,
                      cfg: ShapeNetConfig, variant: str = "siren"):
    """Launch K3 on ``torch.cuda.current_stream()``: ``(d_wb, dx)`` as
    :func:`shapenet_fused_bwd_reference` computes them, from ``g_out
    [G, P, so]`` (cast to x's dtype), through the kernel :func:`k3_variant`
    picks for the dtype and the chain. Raises on anything that kernel does
    not take; never falls back."""
    return _launch_k3(None, wb, x, g_out, cfg, variant)


def _shapenet_bwd_on(kernel: str, wb: torch.Tensor, x: torch.Tensor, g_out: torch.Tensor,
                     cfg: ShapeNetConfig, variant: str = "siren"):
    """K3 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape."""
    return _launch_k3(kernel, wb, x, g_out, cfg, variant)


def _shapenet_bwd_simt(wb: torch.Tensor, x: torch.Tensor, g_out: torch.Tensor,
                       cfg: ShapeNetConfig, variant: str = "siren"):
    """K3 on the CUDA-core kernel whatever the dtype and chain.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k3("simt", wb, x, g_out, cfg, variant)


# K1's forward as a registered op, ``torch.ops.nif_tpu_torch.shapenet_fwd``,
# so that ``torch.export`` (which traces with fake tensors, which have no
# data_ptr) records one call where a CUDA tensor launches K1. The chain's
# config travels as the schema's plain fields; the fields K1 does not read
# (init factor, regularization) are left at their defaults.
def _cfg_fields(cfg: ShapeNetConfig) -> tuple:
    return (cfg.input_dim, cfg.output_dim, cfg.units, cfg.nlayers, cfg.activation,
            cfg.use_resblock, float(cfg.omega_0))


def _fields_cfg(input_dim, output_dim, units, nlayers, activation, use_resblock,
                omega_0) -> ShapeNetConfig:
    return ShapeNetConfig(input_dim=input_dim, output_dim=output_dim, units=units,
                          nlayers=nlayers, activation=activation, use_resblock=use_resblock,
                          omega_0=omega_0, connectivity="full")


@torch.library.custom_op("nif_tpu_torch::shapenet_fwd", mutates_args=(), device_types="cpu")
def _shapenet_fwd_op(wb: torch.Tensor, x: torch.Tensor, input_dim: int, output_dim: int,
                     units: int, nlayers: int, activation: str, use_resblock: bool,
                     omega_0: float, variant: str) -> torch.Tensor:
    """K1 on CPU tensors: its plain version."""
    cfg = _fields_cfg(input_dim, output_dim, units, nlayers, activation, use_resblock, omega_0)
    return shapenet_grouped_fused_reference(wb, x, cfg, variant)


@_shapenet_fwd_op.register_kernel("cuda")
def _(wb, x, input_dim, output_dim, units, nlayers, activation, use_resblock, omega_0, variant):
    cfg = _fields_cfg(input_dim, output_dim, units, nlayers, activation, use_resblock, omega_0)
    return shapenet_fwd_cuda(wb.detach(), x.detach(), cfg, variant)


@_shapenet_fwd_op.register_fake
def _(wb, x, input_dim, output_dim, units, nlayers, activation, use_resblock, omega_0, variant):
    return x.new_empty((x.shape[0], x.shape[1], output_dim))


def _fused_forward(wb, x, cfg, variant):
    """K1 with no graph, through the registered op: plain K1 on the CPU, the
    kernel on CUDA."""
    return _shapenet_fwd_op(wb, x, *_cfg_fields(cfg), variant)


class _FusedShapeNet(torch.autograd.Function):
    """K1 forward (the registered op), K3 backward (plain K1 and plain K3 on
    the CPU): the counterpart of the JAX package's ``jax.custom_vjp`` around
    ``shapenet_grouped_fused``. Only wb and x are saved; the backward
    recomputes the forward with its residuals, as the JAX kernel does."""

    @staticmethod
    def forward(ctx, wb, x, cfg, variant):
        ctx.cfg, ctx.variant = cfg, variant
        ctx.save_for_backward(wb, x)
        return _fused_forward(wb, x, cfg, variant)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        wb, x = (t.detach() for t in ctx.saved_tensors)
        g_out = g_out.detach()
        if x.device.type == "cpu":
            d_wb, dx = shapenet_fused_bwd_reference(wb, x, g_out, ctx.cfg, ctx.variant)
        else:
            d_wb, dx = shapenet_bwd_cuda(wb, x, g_out, ctx.cfg, ctx.variant)
        return (d_wb if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None, None)


def shapenet_grouped_fused(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                           variant: str = "siren") -> torch.Tensor:
    """Fused replacement for :func:`shapenet_grouped`: ``wb [G, po]``,
    ``x [G, P, si]`` -> ``[G, P, so]``, differentiable in wb and x.

    A config the kernel cannot take (:func:`fused_unsupported_reason`) runs
    the eager path, as the JAX package's does. Otherwise a CUDA tensor
    launches K1 (and K3 in the backward) and a CPU tensor runs the plain
    versions."""
    if not fused_supported(cfg, variant, x.shape[1], x.device, x.dtype):
        return shapenet_grouped(wb, x, cfg, variant)
    if torch.is_grad_enabled() and (wb.requires_grad or x.requires_grad):
        return _FusedShapeNet.apply(wb, x, cfg, variant)
    return _fused_forward(wb, x, cfg, variant)


def shapenet_mse_grads(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                       cfg: ShapeNetConfig, variant: str = "siren",
                       weight: Optional[torch.Tensor] = None):
    """Fused train-step core: ``(loss, d_wb)`` of the weighted MSE
    ``mean(weight * (shapenet(wb, x) - target)^2)`` over the grouped layout
    (``wb [G, po]``, ``x [G, P, si]``, ``target [G, P, so]``, ``weight
    [G, P]`` optional). Not differentiable itself: the caller sends ``d_wb``
    on through the ParameterNet.

    A config the kernel cannot take runs eager autograd over
    :func:`shapenet_grouped`, as the JAX package's does; otherwise a CUDA
    tensor launches K2 and a CPU tensor runs the plain K2."""
    wb, x = wb.detach(), x.detach()
    if not fused_supported(cfg, variant, x.shape[1], x.device):
        with torch.enable_grad():
            wb_ = wb.requires_grad_()
            pred = shapenet_grouped(wb_, x, cfg, variant)
            err = torch.square(pred - target.to(pred.dtype))
            if weight is not None:
                err = err * weight.unsqueeze(-1).to(pred.dtype)
            loss = torch.mean(err)
            (d_wb,) = torch.autograd.grad(loss, wb_)
        return loss.detach(), d_wb
    if x.device.type == "cpu":
        return shapenet_mse_grads_reference(wb, x, target, cfg, variant, weight)
    return shapenet_mse_grads_cuda(wb, x, target, cfg, variant, weight)
