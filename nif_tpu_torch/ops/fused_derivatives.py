"""The fused derivative kernels of the grouped ShapeNet chain (counterparts
of ``nif_tpu/ops/pallas_shapenet.py``):

* **K5**, :func:`shapenet_fwd_jac`: ``wb [G, po]``, ``x [G, P, si]`` ->
  ``(y [G, P, so], jac [G, P, so, si])`` in x's dtype. With ``so < si`` it
  runs the residual-saving forward and ``so`` dx-only cotangent sweeps (the
  Pallas ``_jac_rev_layers``); otherwise the ``si`` forward tangent streams
  ride the forward, stacked under the value rows of every product (the
  Pallas ``_fwd_jac_layers``).
* **K6**, :func:`shapenet_sobolev_grads`: the stacked forward with its
  residuals, the masked, weighted value and Jacobian MSE, and the backward
  through the tangent chain (which multiplies by ``act''``) in one pass,
  ``(value_mse, jac_mse, d_wb)`` (the Pallas ``_sobolev_kernel``).

Rounding points, beyond those of K1-K3 (``fused_shapenet``): the tangent
streams are kept in f32 and rounded to the compute dtype at every product
(the stacked state S is stored rounded, since every use rounds it); the raw
products Z stay f32; the reverse sweeps carry ``du`` in f32 and round each
``dz`` before its product; the targets are rounded to x's dtype; K5's
outputs are cast to x's dtype; K6's bias gradients sum the unrounded ``dz``.

On a CUDA tensor each entry launches its hand-written kernel, or raises.
K5 and K6 have two variants (:func:`k5_variant`, :func:`k6_variant`):
bfloat16 runs the tensor-core kernel (variant ``"tc"``: K5's reverse body
in ``csrc/shapenet_fwd_tc.cu`` beside the tensor-core K1, K5's tangent body
and K6 in ``csrc/shapenet_jac_tc.cu``, the former K6's forward half;
before it K5's reverse body prefers ``"wgmma"``, ``csrc/shapenet_fwd_wgmma.cu``
beside the wgmma K1) wherever its geometry takes the shape, and the CUDA-core one (variant
``"simt"``) otherwise and for float32, whose f32 products never round to
TF32: K5's CUDA-core reverse body is ``csrc/shapenet_fwd.cu``'s, one body
with the CUDA-core K1; its tangent body and K6 are ``csrc/shapenet_jac.cu``'s,
one body template for si <= 4 (the tangent body its forward half; the
geometry names it ``"simt"``) and the first port's ``"stacked"`` body past
that. On a
CPU tensor it runs the plain PyTorch version (``*_reference``), which the
CPU tests hold against the JAX package's interpret-mode kernels and
``chip_smoke.py`` holds the CUDA kernels against. Nothing here falls
back to another path: callers route (``ops.derivatives``,
``NIF.sobolev_value_and_grad``) with the ``*_supported`` gates.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ShapeNetConfig
from . import _build
from .fused_shapenet import (
    _DTYPE_CODES,
    _act_code,
    _act_quad,
    _act_triple,
    _chain_code,
    _chain_lists,
    _check_cuda_inputs,
    _fwd_tc_library,
    _flat_grads,
    _fwd_wg_library,
    _library as _fwd_library,
    _forward_saved,
    _n_mats,
    _n_scaled,
    _prescale,
    _raise_on_error,
    _simt_fwd_reason,
    _simt_fwd_status,
    _simt_weights,
    _stack_tc_status,
    _unscale_grads,
    _train_act_code,
    _wg_fwd_status,
    fused_unsupported_reason,
)
from .shapenet import unpack_shapenet_weights

__all__ = [
    "shapenet_fwd_jac",
    "shapenet_fwd_jac_reference",
    "shapenet_fwd_jac_cuda",
    "shapenet_sobolev_grads",
    "shapenet_sobolev_grads_reference",
    "shapenet_sobolev_grads_cuda",
    "fwd_jac_supported",
    "fwd_jac_unsupported_reason",
    "sobolev_fused_supported",
    "sobolev_fused_unsupported_reason",
    "derivative_geometry",
    "k5_variant",
    "k6_variant",
]

# Kernel bodies of csrc/shapenet_jac.cu (its enum Mode; "reverse" runs in
# csrc/shapenet_fwd.cu, and shapenet_jac.cu refuses it).
_MODES = {"reverse": 0, "tangent": 1, "sobolev": 2}


def _jac_mode(cfg: ShapeNetConfig, si: int) -> str:
    """K5's body: reverse sweeps when there are fewer outputs than inputs."""
    return "reverse" if cfg.output_dim < si else "tangent"


# --------------------------------------------------------------- geometry
def _library(kernel: str = "simt") -> ctypes.CDLL:
    c_int, ptr, c_ll, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    if kernel == "tc":
        lib = _build.load_library("shapenet_jac_tc")
        if lib.nif_shapenet_sobolev_grads_tc.argtypes is None:
            lib.nif_shapenet_sobolev_tc_workspace.argtypes = [c_int] * 7 + [ptr] * 7
            lib.nif_shapenet_sobolev_tc_workspace.restype = c_int
            lib.nif_shapenet_sobolev_grads_tc.argtypes = (
                [ptr] * 11 + [c_int] * 8 + [c_ll] * 3 + [c_f] * 5 + [ptr])
            lib.nif_shapenet_sobolev_grads_tc.restype = c_int
            lib.nif_shapenet_fwd_jac_tan_tc_workspace.argtypes = [c_int] * 7 + [ptr] * 6
            lib.nif_shapenet_fwd_jac_tan_tc_workspace.restype = c_int
            lib.nif_shapenet_fwd_jac_tan_tc.argtypes = [ptr] * 5 + [c_int] * 8 + [c_ll, c_ll, ptr]
            lib.nif_shapenet_fwd_jac_tan_tc.restype = c_int
    else:
        lib = _build.load_library("shapenet_jac")
        if lib.nif_shapenet_fwd_jac.argtypes is None:
            lib.nif_shapenet_jac_workspace.argtypes = [c_int] * 9 + [ptr] * 7
            lib.nif_shapenet_jac_workspace.restype = c_int
            lib.nif_shapenet_fwd_jac.argtypes = [ptr] * 5 + [c_int] * 8 + [c_ll, c_ll, c_int, ptr]
            lib.nif_shapenet_fwd_jac.restype = c_int
            lib.nif_shapenet_sobolev_grads.argtypes = (
                [ptr] * 11 + [c_int] * 8 + [c_ll] * 3 + [c_f] * 5 + [c_int, ptr])
            lib.nif_shapenet_sobolev_grads.restype = c_int
    if lib.nif_cuda_error_string.argtypes is None:
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _tc_status(cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K6 (``csrc/shapenet_jac_tc.cu``)."""
    return _stack_tc_status(_library("tc").nif_shapenet_sobolev_tc_workspace, "sobolev", cfg,
                            variant, si, G, P)


def _k5_tc_status(cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K5 reverse body
    (``csrc/shapenet_fwd_tc.cu``)."""
    return _stack_tc_status(_fwd_tc_library().nif_shapenet_fwd_jac_tc_workspace, "reverse",
                            cfg, variant, si, G, P)


def _k5_wg_status(cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int):
    """``(status, geometry)`` of the wgmma K5 reverse body
    (``csrc/shapenet_fwd_wgmma.cu``; a chain it has no instance for is
    status 3 without asking its library)."""
    return _wg_fwd_status("reverse", cfg, variant, si, G, P)


# K5's bf16 reverse bodies with their geometry, in the order a launch
# prefers them
_REVERSE_BODIES = {"wgmma": _k5_wg_status, "tc": _k5_tc_status}


def _k5_tan_tc_status(cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K5 tangent body
    (``csrc/shapenet_jac_tc.cu``): points per tile, the blocks of its one
    wave over every group's tiles and blocks per SM, shared memory per
    block, whether W_m is staged there, and the bytes of its scratch (a
    resblock's f32 carry)."""
    tile, blocks, per_sm, staged_w = (ctypes.c_int() for _ in range(4))
    smem, scratch = ctypes.c_longlong(), ctypes.c_longlong()
    status = _library("tc").nif_shapenet_fwd_jac_tan_tc_workspace(
        cfg.units, si, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant), G, P,
        ctypes.byref(tile), ctypes.byref(blocks), ctypes.byref(per_sm), ctypes.byref(smem),
        ctypes.byref(staged_w), ctypes.byref(scratch))
    geo = {"mode": "tangent", "kernel": "tc", "body": "tc", "tile": tile.value,
           "blocks": blocks.value, "blocks_per_sm": per_sm.value, "smem_bytes": smem.value,
           "residuals": "shared", "weights": "shared" if staged_w.value else "global",
           "partial_floats": 0, "scratch_bytes": scratch.value}
    return status, geo


def k5_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None, variant: str = "siren",
               si: Optional[int] = None) -> str:
    """Which CUDA kernel K5 runs for inputs of ``dtype``: ``"tc"`` (the
    tensor-core kernels: the reverse body, so < si, in
    ``csrc/shapenet_fwd_tc.cu``, the tangent body, so >= si, in
    ``csrc/shapenet_jac_tc.cu``) for bfloat16 and ``"simt"`` (the
    CUDA-core kernels) for float32, whose products stay full f32 (and for
    any other dtype, which the wrapper refuses). "simt" runs the reverse
    body in ``csrc/shapenet_fwd.cu``, one body with the CUDA-core K1, and
    the tangent body in ``csrc/shapenet_jac.cu``. Given a chain (``cfg``,
    ``variant``, ``si``), bfloat16 runs the first body of its mode whose
    geometry takes the shape (asking that body's library, so it needs
    nvcc): the reverse body ``"wgmma"`` (``csrc/shapenet_fwd_wgmma.cu``,
    widths 64 and 128; its library asked only for those), then ``"tc"``;
    the tangent body ``"tc"``; then the CUDA-core kernel (a vanilla chain,
    si > 4, or a width whose planes exceed a block's shared memory)."""
    if dtype != torch.bfloat16:
        return "simt"
    if cfg is None:
        return "tc"
    si = cfg.input_dim if si is None else si
    if _jac_mode(cfg, si) == "reverse":
        for body, status in _REVERSE_BODIES.items():
            if status(cfg, variant, si, 1, 1)[0] == 0:
                return body
        return "simt"
    return "tc" if _k5_tan_tc_status(cfg, variant, si, 1, 1)[0] == 0 else "simt"


def k6_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None, variant: str = "siren",
               si: Optional[int] = None) -> str:
    """Which CUDA kernel K6 runs for inputs of ``dtype``: ``"tc"`` (the
    tensor-core kernel, ``csrc/shapenet_jac_tc.cu``) for bfloat16 and
    ``"simt"`` (the CUDA-core kernel, ``csrc/shapenet_jac.cu``) for float32,
    whose products stay full f32 (and for any other dtype, which the wrapper
    refuses). Given a chain (``cfg``, ``variant``, ``si``; this asks the
    tensor-core kernel's library, so it needs nvcc), bfloat16 runs the
    CUDA-core kernel where the tensor-core one does not take the shape: a
    vanilla chain, si > 4, or a width whose stacked planes exceed a block's
    shared memory."""
    if dtype != torch.bfloat16:
        return "simt"
    if cfg is None:
        return "tc"
    si = cfg.input_dim if si is None else si
    return "tc" if _tc_status(cfg, variant, si, 1, 1)[0] == 0 else "simt"


def _geometry_status(mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int,
                     dtype: torch.dtype, kernel: Optional[str] = None):
    if mode == "sobolev" and (kernel or k6_variant(dtype, cfg, variant, si)) == "tc":
        return _tc_status(cfg, variant, si, G, P)
    if mode == "reverse":
        kernel = kernel or k5_variant(dtype, cfg, variant, si)
        if kernel in _REVERSE_BODIES:
            status, geo = _REVERSE_BODIES[kernel](cfg, variant, si, G, P)
            return status, {**geo, "body": kernel}
        return _simt_fwd_status("reverse", cfg, variant, si, G, P, dtype)
    if kernel == "wgmma":  # the wgmma body has no tangent or Sobolev mode
        return 3, {"mode": mode, "kernel": "wgmma", "body": "wgmma"}
    if mode == "tangent" and (kernel or k5_variant(dtype, cfg, variant, si)) == "tc":
        return _k5_tan_tc_status(cfg, variant, si, G, P)
    body, tile, splits, per_sm = (ctypes.c_int() for _ in range(4))
    smem, partial_floats, scratch = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    status = _library().nif_shapenet_jac_workspace(
        _MODES[mode], cfg.units, si, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant),
        G, P, _DTYPE_CODES[dtype], ctypes.byref(body), ctypes.byref(tile), ctypes.byref(splits),
        ctypes.byref(per_sm), ctypes.byref(smem), ctypes.byref(partial_floats),
        ctypes.byref(scratch))
    geo = {"mode": mode, "kernel": "simt", "tile": tile.value, "splits": splits.value,
           "smem_bytes": smem.value, "residuals": "global" if scratch.value else "shared",
           "weights": "shared", "partial_floats": partial_floats.value,
           "scratch_bytes": scratch.value}
    if mode == "tangent":
        if body.value:  # K6's forward half: one wave of blocks over every group's tiles
            geo.update(body="simt", blocks=geo.pop("splits"), blocks_per_sm=per_sm.value)
        else:  # the first port's stacked body (si > 4)
            geo["body"] = "stacked"
    return status, geo


def _status_reason(status: int, cfg: ShapeNetConfig, si: int, geo: dict) -> Optional[str]:
    if status == 0:
        return None
    if geo.get("body") == "simt":
        return _simt_fwd_reason(status, cfg, si, geo)
    if geo["kernel"] in ("tc", "wgmma"):
        what, planes = (("Sobolev", "two stacked planes of 32 points")
                        if geo["mode"] == "sobolev" else
                        ("Jacobian", "every W_m and its act' slots" if geo["kernel"] == "wgmma"
                         else f"its planes of {geo['tile']} points"))
        name = "wgmma" if geo["kernel"] == "wgmma" else "tensor-core"
        if status == 2:
            return (f"units={cfg.units} with si={si} needs {geo['smem_bytes']} bytes of shared "
                    f"memory per block in the {name} {what} kernel ({planes}), more than "
                    f"a block may have")
        return (f"the {name} {what} kernel cannot take {cfg} with si={si} "
                f"(status {status})")
    if status == 1:
        return (f"units={cfg.units} is wider than the CUDA derivative kernels take (a "
                f"thread keeps its columns of a layer in registers)")
    if status == 2:
        return (f"units={cfg.units} needs {geo['smem_bytes']} bytes of shared memory per "
                f"block, more than a block may have")
    if status == 4:
        return (f"si={si}: {1 + si} stacked streams do not fit the CUDA kernel's point "
                f"tile at units={cfg.units}")
    return f"the CUDA derivative kernels cannot take {cfg} with si={si} (status {status})"


def derivative_geometry(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int,
                        dtype: torch.dtype, si: Optional[int] = None) -> dict:
    """The launch geometry of one body (``mode`` "reverse" or "tangent" for
    K5, "sobolev" for K6) at ``[G, P]`` in ``dtype``, from the library of
    the variant that runs it (it needs nvcc): K5's from :func:`k5_variant`'s
    (the reverse body from ``csrc/shapenet_fwd_tc.cu``, or
    ``csrc/shapenet_fwd.cu`` for "simt"; the tangent body from
    ``csrc/shapenet_jac_tc.cu``, or ``csrc/shapenet_jac.cu`` for "simt"),
    K6's from :func:`k6_variant`'s: the kernel and, for K5, its body ("tc",
    "simt" or, for the tangent body at si > 4, "stacked"), points per tile,
    P splits per group (or, for the "simt" bodies and the "tc" tangent body,
    the blocks of one wave over every group's tiles and blocks per SM),
    shared memory per block, whether a tile's residuals and the staged
    weights sit in shared memory or in global memory, and the workspace
    sizes the wrappers allocate."""
    return _geometry(mode, cfg, variant, G, P, dtype, si)


def _geometry(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int,
              dtype: torch.dtype, si: Optional[int] = None, kernel: Optional[str] = None) -> dict:
    """:func:`derivative_geometry` on ``kernel`` ("wgmma", "tc" or "simt")
    where one is named; a named tensor-core reverse body takes bfloat16
    only, and nothing is asked of a library for a name it does not know."""
    if kernel not in (None, *_REVERSE_BODIES, "simt"):
        raise ValueError(f"unknown K5 body {kernel!r}")
    if mode == "reverse" and kernel in _REVERSE_BODIES and dtype != torch.bfloat16:
        raise ValueError(f"the {kernel} K5 reverse body takes bfloat16 inputs, not {dtype}")
    si = cfg.input_dim if si is None else si
    status, geo = _geometry_status(mode, cfg, variant, si, G, P, dtype, kernel)
    if status != 0:
        raise ValueError(_status_reason(status, cfg, si, geo))
    return geo


def _cuda_reason(mode: str, cfg: ShapeNetConfig, variant: str, si: int,
                 dtype: torch.dtype = torch.bfloat16,
                 kernel: Optional[str] = None) -> Optional[str]:
    """The CUDA body's own limits (width, streams, shared memory) in the
    kernel that ``dtype`` (or ``kernel``) runs; they do not depend on G or
    P."""
    if dtype not in _DTYPE_CODES:  # the wrapper refuses other dtypes itself
        return None
    status, geo = _geometry_status(mode, cfg, variant, si, 1, 1, dtype, kernel)
    return _status_reason(status, cfg, si, geo)


def fwd_jac_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                               device=None, dtype: torch.dtype = torch.bfloat16,
                               kernel: Optional[str] = None) -> Optional[str]:
    """Why K5 can NOT take this config (None = it can). The reasons and
    their strings are the JAX package's (its P rule kept for routing
    parity, though the kernel masks a ragged tile); on a CUDA ``device``
    the own limits of the CUDA body that ``dtype`` runs (:func:`k5_variant`)
    or ``kernel`` apply too."""
    base = fused_unsupported_reason(cfg, variant, P)
    if base is None and device is not None and torch.device(device).type == "cuda":
        return _cuda_reason(_jac_mode(cfg, si), cfg, variant, si, dtype, kernel)
    return base


def fwd_jac_supported(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                      device=None, dtype: torch.dtype = torch.bfloat16) -> bool:
    return fwd_jac_unsupported_reason(cfg, variant, P, si, device, dtype) is None


def sobolev_fused_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                                     device=None, dtype: torch.dtype = torch.bfloat16,
                                     kernel: Optional[str] = None) -> Optional[str]:
    """Why K6 can NOT take this config (None = it can); as
    :func:`fwd_jac_unsupported_reason`, in the kernel that ``dtype`` runs
    (:func:`k6_variant`) or ``kernel``."""
    base = fused_unsupported_reason(cfg, variant, P)
    if base is None and device is not None and torch.device(device).type == "cuda":
        return _cuda_reason("sobolev", cfg, variant, si, dtype, kernel)
    return base


def sobolev_fused_supported(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                            device=None, dtype: torch.dtype = torch.bfloat16) -> bool:
    return sobolev_fused_unsupported_reason(cfg, variant, P, si, device, dtype) is None


# ----------------------------------------------------------- plain versions
def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _lifter(cdt: torch.dtype):
    acc = _acc(cdt)
    return lambda a: a.to(cdt).to(acc)


def _jac_reverse(wbp, x, cfg, variant):
    """``_jac_rev_layers``: the residual-saving forward, then one dx-only
    cotangent sweep per output from the one-hot last-layer column. Returns
    ``(out f32 [G, P, so], jac f32 [G, P, so, si])``."""
    cdt = x.dtype
    acc, lift = _acc(cdt), _lifter(cdt)
    out, _ins, dacts, ws = _forward_saved(wbp, x, cfg, variant)
    d1s = [d.to(acc) for d in dacts]

    def back(dz, w):  # lift(dz) @ w^T, f32
        return torch.matmul(lift(dz), w.to(acc).transpose(-1, -2))

    l = cfg.nlayers
    cols = []
    for j in range(cfg.output_dim):
        du = ws[-1][..., j].to(acc).unsqueeze(-2)  # [G, 1, n]
        if variant == "siren" and cfg.use_resblock:
            for i in range(l - 1, -1, -1):
                dh = back(0.5 * du * d1s[2 + 2 * i], ws[2 + 2 * i])
                du = 0.5 * du + back(dh * d1s[1 + 2 * i], ws[1 + 2 * i])
        elif variant == "siren":
            for i in range(l - 1, -1, -1):
                du = back(du * d1s[1 + i], ws[1 + i])
        else:
            for i in range(l - 1, -1, -1):
                du = du + back(du * d1s[1 + i], ws[1 + i])
        cols.append(back(du * d1s[0], ws[0]))  # [G, P, si]
    return out, torch.stack(cols, dim=2)


def _tangent_forward(wbp, x, cfg, variant, save: bool, pairs=()):
    """``_fwd_jac_layers``: the chain with ``si`` tangent streams stacked
    under the value rows, ``S [G, 1 + si, P, n]`` (stream 0 the values,
    stream 1 + k the tangent d/dx_k). Returns ``(out f32 [G, P, so], O f32
    [G, 1 + si, P, so], saved)`` where ``O[:, 1 + k]`` is d out / d x_k and
    ``saved = (z0, S_list, Z_list, ws, bs)`` when ``save`` (``S_list`` the
    lifted input of every hidden product and of the last one, ``Z_list``
    the f32 product of every hidden matrix).

    ``pairs`` (K7, K8: ``_hess_fwd_layers``) adds one second-order stream
    per unique pair (j, k) after the tangents, d2/dx_j dx_k: seeded with
    ``act''(z0) W0[j] W0[k]`` and carried by ``act'(z) Z_a + act''(z) Z_j
    Z_k``, so ``O[:, 1 + si + a]`` is d2 out / dx_j dx_k."""
    cdt = x.dtype
    acc, lift = _acc(cdt), _lifter(cdt)
    act, d1, d2 = _act_triple(cfg, variant, cdt)
    ws, bs = _chain_lists(unpack_shapenet_weights(wbp, cfg))
    si = x.shape[-1]
    w0 = ws[0].to(acc)
    z0 = torch.matmul(x.to(acc), w0) + bs[0].to(acc).unsqueeze(-2)
    g0 = d1(z0)
    rows = [w0[:, k].unsqueeze(-2) for k in range(si)]
    seeds = [act(z0)] + [g0 * r for r in rows]
    if pairs:
        h0 = d2(z0)
        seeds += [h0 * (rows[j] * rows[k]) for j, k in pairs]
    S = torch.stack(seeds, dim=1)
    S_list, Z_list = [], []

    def app(S, i):
        Z = torch.matmul(lift(S), ws[i].to(acc).unsqueeze(1))
        if save:
            S_list.append(lift(S))
            Z_list.append(Z)
        return Z, Z[:, 0] + bs[i].to(acc).unsqueeze(-2)

    def epilogue(Z, z):
        """The streams one product leaves: [act(z); act'(z) Z_k; act'(z)
        Z_a + act''(z) Z_j Z_k]."""
        g = d1(z)
        parts = [act(z).unsqueeze(1), g.unsqueeze(1) * Z[:, 1:1 + si]]
        if pairs:
            h = d2(z)
            parts.append(torch.stack([g * Z[:, 1 + si + a] + h * Z[:, 1 + j] * Z[:, 1 + k]
                                      for a, (j, k) in enumerate(pairs)], dim=1))
        return torch.cat(parts, dim=1)

    l = cfg.nlayers
    if variant == "siren" and cfg.use_resblock:
        for i in range(l):
            Sh = epilogue(*app(S, 1 + 2 * i))
            S = 0.5 * (S + epilogue(*app(Sh, 2 + 2 * i)))
    elif variant == "siren":
        for i in range(l):
            S = epilogue(*app(S, 1 + i))
    elif variant == "vanilla":
        for i in range(l):
            S = epilogue(*app(S, 1 + i)) + S
    else:
        raise ValueError(f"unknown shapenet variant {variant!r}")
    if save:
        S_list.append(lift(S))
    O = torch.matmul(lift(S), ws[-1].to(acc).unsqueeze(1))
    out = O[:, 0] + bs[-1].to(acc).unsqueeze(-2)
    return out, O, ((z0, S_list, Z_list, ws, bs) if save else None)


def shapenet_fwd_jac_reference(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                               variant: str = "siren"):
    """The plain PyTorch version of K5: ``(y [G, P, so], jac [G, P, so,
    si])`` in x's dtype, with the kernel's mode rule (reverse sweeps when
    so < si, forward tangents otherwise) and rounding points."""
    wbp = _prescale(wb, cfg, variant)
    if _jac_mode(cfg, x.shape[-1]) == "reverse":
        out, jac = _jac_reverse(wbp, x, cfg, variant)
    else:
        out, O, _ = _tangent_forward(wbp, x, cfg, variant, save=False)
        jac = O[:, 1:].permute(0, 2, 3, 1)  # [G, si, P, so] -> [G, P, so, si]
    return out.to(x.dtype), jac.to(x.dtype)


# index and mask constants of the Sobolev and Hessian steps on each device,
# made once per value: a step that passes the same ones uploads nothing from
# the host, so a CUDA graph can capture it
_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def _device_constant(array, device) -> torch.Tensor:
    """``array`` on ``device``, uploaded on its first use (read only)."""
    a = np.ascontiguousarray(array)
    key = (a.dtype.str, a.shape, a.tobytes(), str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, device=device)
    return t


def _mask_tensor(mask, n: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    m = np.asarray(mask, np.float32).reshape(-1)
    if m.size != n:
        raise ValueError(f"mask has {m.size} entries, expected {n}")
    return _device_constant(m, like.device)


def _sobolev_scales(G, P, si, so, w_value, w_jac, y_mask, jac_mask):
    """``(n_y, n_j, ky, kj)``: the selected entries of each term and the
    factors 2 w / n of their cotangents (the JAX wrapper's)."""
    n_y = G * P * (int(np.sum(y_mask)) if y_mask is not None else so)
    n_j = G * P * (int(np.sum(jac_mask)) if jac_mask is not None else si * so)
    return n_y, n_j, 2.0 * float(w_value) / n_y, 2.0 * float(w_jac) / n_j


def _sobolev_backward(D_out, x, saved, cfg, variant, pairs=()):
    """``_sobolev_backward_chain``: reverse the stacked chain from the
    stacked cotangent ``D_out [G, 1 + si, P, so]`` of the last product.
    Returns the per-layer ``(dws, dbs)`` in f32.

    With ``pairs`` (K8: ``_hessian_backward_chain``) ``D_out`` also holds
    the second-order streams' rows; their epilogue sends ``act'''`` into dz
    and, by the product rule, ``act''`` terms into the tangent streams."""
    cdt = x.dtype
    acc, lift = _acc(cdt), _lifter(cdt)
    z0, S_list, Z_list, ws, bs = saved
    if pairs:
        _, d1, d2, d3 = _act_quad(cfg, variant, cdt)
    else:
        (_, d1, d2), d3 = _act_triple(cfg, variant, cdt), None
    G, NS, P, _ = D_out.shape
    si = NS - 1 - len(pairs)
    n_w = len(ws)
    dws, dbs = [None] * n_w, [None] * n_w

    def w_grad(S_in, D):  # lift(S_in)^T lift(D), summed over streams and points
        return torch.matmul(S_in.reshape(G, NS * P, -1).transpose(-1, -2),
                            lift(D).reshape(G, NS * P, -1))

    def back(D, w):
        return torch.matmul(lift(D), w.to(acc).transpose(-1, -2).unsqueeze(1))

    def curvature(dS, Z, b, scale):
        """(dz, D): the reverse of one product's epilogue from the scaled
        cotangent of its output streams. dz = du g + sum_k dt_k Z_k act''
        + sum_a dh_a (Z_a act'' + Z_j Z_k act'''); D stacks dz, the tangent
        rows dt_k g (plus the pairs' product-rule terms) and dh_a g."""
        z = Z[:, 0] + b.to(acc).unsqueeze(-2)
        g, h = d1(z), d2(z)
        if scale != 1.0:
            dS = scale * dS
        dz = dS[:, 0] * g
        for k in range(si):
            dz = dz + dS[:, 1 + k] * Z[:, 1 + k] * h
        dT = [dS[:, 1 + k] * g for k in range(si)]
        dH = []
        if pairs:
            q = d3(z)
            for a, (j, k) in enumerate(pairs):
                dh = dS[:, 1 + si + a]
                dz = dz + dh * (Z[:, 1 + si + a] * h + Z[:, 1 + j] * Z[:, 1 + k] * q)
                dH.append(dh * g)
                if j == k:
                    dT[j] = dT[j] + 2.0 * dh * h * Z[:, 1 + j]
                else:
                    dT[j] = dT[j] + dh * h * Z[:, 1 + k]
                    dT[k] = dT[k] + dh * h * Z[:, 1 + j]
        return dz, torch.stack([dz] + dT + dH, dim=1)

    def app_bwd(dz, D, S_in, w):
        return w_grad(S_in, D), dz.sum(dim=-2), back(D, w)

    dws[-1] = w_grad(S_list[-1], D_out)
    dbs[-1] = D_out[:, 0].sum(dim=-2)
    dS = back(D_out, ws[-1])
    l = cfg.nlayers
    if variant == "siren" and cfg.use_resblock:
        for i in range(l - 1, -1, -1):
            dz2, D2 = curvature(dS, Z_list[2 * i + 1], bs[2 + 2 * i], 0.5)
            dws[2 + 2 * i], dbs[2 + 2 * i], dSh = app_bwd(dz2, D2, S_list[2 * i + 1],
                                                          ws[2 + 2 * i])
            dz1, D1 = curvature(dSh, Z_list[2 * i], bs[1 + 2 * i], 1.0)
            dws[1 + 2 * i], dbs[1 + 2 * i], dS_new = app_bwd(dz1, D1, S_list[2 * i],
                                                             ws[1 + 2 * i])
            dS = dS_new + 0.5 * dS  # the skip path
    else:
        for i in range(l - 1, -1, -1):
            dz, D = curvature(dS, Z_list[i], bs[1 + i], 1.0)
            dws[1 + i], dbs[1 + i], dS_new = app_bwd(dz, D, S_list[i], ws[1 + i])
            # the vanilla shortcut passes the gradient straight through
            dS = dS_new + dS if variant == "vanilla" else dS_new
    # first layer: z0 = x @ W0 + b0, tangent seeds t_k = act'(z0) W0[k, :],
    # second-order seeds act''(z0) W0[j, :] W0[k, :]
    g0, h0 = d1(z0), d2(z0)
    w0 = ws[0].to(acc)
    rows = [w0[:, k].unsqueeze(-2) for k in range(si)]
    dz0 = dS[:, 0] * g0
    for k in range(si):
        dz0 = dz0 + dS[:, 1 + k] * rows[k] * h0
    seed_rows = [(dS[:, 1 + k] * g0).sum(dim=-2) for k in range(si)]
    if pairs:
        q0 = d3(z0)
        for a, (j, k) in enumerate(pairs):
            dh = dS[:, 1 + si + a]
            dz0 = dz0 + dh * (rows[j] * rows[k]) * q0
            if j == k:
                seed_rows[j] = seed_rows[j] + 2.0 * (dh * h0 * rows[j]).sum(dim=-2)
            else:
                seed_rows[j] = seed_rows[j] + (dh * h0 * rows[k]).sum(dim=-2)
                seed_rows[k] = seed_rows[k] + (dh * h0 * rows[j]).sum(dim=-2)
    dw0 = torch.matmul(lift(x).transpose(-1, -2), lift(dz0))
    dws[0] = dw0 + torch.stack(seed_rows, dim=1)
    dbs[0] = dz0.sum(dim=-2)
    return dws, dbs


def shapenet_sobolev_grads_reference(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                     jac_target: torch.Tensor, cfg: ShapeNetConfig,
                                     variant: str = "siren", w_value: float = 1.0,
                                     w_jac: float = 1.0, y_mask=None, jac_mask=None,
                                     weight: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K6: ``(value_mse, jac_mse, d_wb)`` of
    ``w_value mean_sel(weight (y - target)^2) + w_jac mean_sel(weight (jac -
    jac_target)^2)``, with the kernel's rounding points.

    ``target [G, P, so]``, ``jac_target [G, P, si*so]`` in the kernel's flat
    layout (column ``k*so + j`` = d y_j / d x_k), both zero outside the 0/1
    masks ``y_mask [so]`` and ``jac_mask [si*so]`` (None = every entry) and
    cast to x's dtype; ``weight [G, P]`` (optional, cast to x's dtype)
    multiplies both squared errors. The means run over the selected
    entries; ``d_wb`` (wb's dtype) carries both term weights."""
    G, P, si = x.shape
    so = cfg.output_dim
    cdt = x.dtype
    acc, lift = _acc(cdt), _lifter(cdt)
    n_y, n_j, ky, kj = _sobolev_scales(G, P, si, so, w_value, w_jac, y_mask, jac_mask)
    out, O, saved = _tangent_forward(_prescale(wb, cfg, variant), x, cfg, variant, save=True)
    err_y = out - lift(target)
    jt = lift(jac_target).reshape(G, P, si, so).permute(0, 2, 1, 3)  # [G, si, P, so]
    err_j = O[:, 1:] - jt
    ym = _mask_tensor(y_mask, so, x)
    if ym is not None:
        err_y = err_y * ym
    jm = _mask_tensor(jac_mask, si * so, x)
    if jm is not None:
        err_j = err_j * jm.reshape(si, 1, so)
    if weight is None:
        lv = torch.sum(torch.square(err_y))
        lj = torch.sum(torch.square(err_j))
        D_out = torch.cat([(ky * err_y).unsqueeze(1), kj * err_j], dim=1)
    else:
        w = lift(weight).unsqueeze(-1)
        lv = torch.sum(torch.square(err_y) * w)
        lj = torch.sum(torch.square(err_j) * w.unsqueeze(1))
        D_out = torch.cat([(ky * err_y * w).unsqueeze(1), kj * err_j * w.unsqueeze(1)], dim=1)
    dws, dbs = _sobolev_backward(D_out, x, saved, cfg, variant)
    d_wb = _unscale_grads(_flat_grads(dws, dbs, G), cfg, variant)
    return lv / n_y, lj / n_j, d_wb.to(wb.dtype)


# ----------------------------------------------------------- CUDA wrappers
def _workspace(mode: str, cfg: ShapeNetConfig, variant: str, x: torch.Tensor,
               kernel: Optional[str] = None):
    geo = _geometry(mode, cfg, variant, x.shape[0], x.shape[1], x.dtype, kernel=kernel)
    partials = torch.empty(max(geo["partial_floats"], 1), dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(geo["scratch_bytes"], 1), dtype=torch.uint8, device=x.device)
    return partials, scratch


def _k5_entry(kernel: str, mode: str):
    """``(library, C entry)`` of K5's ``mode`` body on ``kernel``: "wgmma"
    the wgmma reverse body (``csrc/shapenet_fwd_wgmma.cu``, beside the
    wgmma K1); "tc" the tensor-core reverse body
    (``csrc/shapenet_fwd_tc.cu``, beside the tensor-core K1) or tangent body
    (``csrc/shapenet_jac_tc.cu``, beside the tensor-core K6); "simt" the
    reverse body of ``csrc/shapenet_fwd.cu`` (beside the CUDA-core K1) or
    the tangent body of ``csrc/shapenet_jac.cu`` (beside the CUDA-core
    K6)."""
    if mode == "reverse":
        if kernel == "wgmma":
            lib = _fwd_wg_library()
            return lib, lib.nif_shapenet_fwd_jac_wg
        if kernel == "tc":
            lib = _fwd_tc_library()
            return lib, lib.nif_shapenet_fwd_jac_tc
        lib = _fwd_library()
        return lib, lib.nif_shapenet_fwd_jac_rev
    lib = _library(kernel)
    return lib, (lib.nif_shapenet_fwd_jac_tan_tc if kernel == "tc" else lib.nif_shapenet_fwd_jac)


# the tensor-core bodies' own launch counters (beside "shapenet_fwd_jac")
_TC_COUNTERS = {"wgmma": "shapenet_fwd_jac_wg", "tc": "shapenet_fwd_jac_tc"}


def _launch_k5(kernel: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
               variant: str):
    """K5 through the library of ``kernel`` ("wgmma", "tc" or "simt") and
    the body its shape takes (:func:`_k5_entry`), after the wrapper's
    checks; counts the launch."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    _check_cuda_inputs("shapenet_fwd_jac_cuda", wb, x, cfg, variant,
                       lambda c, v, P, d: fwd_jac_unsupported_reason(c, v, P, si, d, x.dtype,
                                                                     kernel))
    G, P, si = x.shape
    so = cfg.output_dim
    y = torch.empty((G, P, so), dtype=x.dtype, device=x.device)
    jac = torch.empty((G, P, so, si), dtype=x.dtype, device=x.device)
    if G == 0 or P == 0:
        return y, jac
    mode = _jac_mode(cfg, si)
    act = _train_act_code(cfg, variant, x.dtype) if mode == "reverse" else _act_code(
        cfg, variant, x.dtype)
    wbp = _prescale(wb, cfg, variant).contiguous()
    # rows padded to 16 bytes, so every group's W_m stages with cp.async (tc)
    # or TMA (wgmma); the CUDA-core bodies read them widened to f32 (a bf16
    # value is exact in f32)
    wbp = (torch.nn.functional.pad(wbp, (0, -wbp.shape[1] % 8)) if kernel in _TC_COUNTERS
           else _simt_weights(wbp))
    x = x.contiguous()
    lib, entry = _k5_entry(kernel, mode)
    with torch.cuda.device(x.device):  # the geometry reads this device's SM count
        _, scratch = _workspace(mode, cfg, variant, x, kernel)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), y.data_ptr(), jac.data_ptr(), scratch.data_ptr(),
                G, P, si, so, cfg.units, _n_mats(cfg), _chain_code(cfg, variant), act,
                wb.shape[1])
        if kernel in _TC_COUNTERS:
            err = entry(*args, wbp.shape[1], stream)
        else:
            err = entry(*args, wbp.shape[1], _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "shapenet_fwd_jac", err)
    _build.LAUNCHES["shapenet_fwd_jac"] += 1
    if kernel in _TC_COUNTERS:
        _build.LAUNCHES[_TC_COUNTERS[kernel]] += 1
    return y, jac


def shapenet_fwd_jac_cuda(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                          variant: str = "siren"):
    """Launch K5 on ``torch.cuda.current_stream()``: ``(y, jac)`` as
    :func:`shapenet_fwd_jac_reference` computes them, through the kernel
    :func:`k5_variant` picks for the dtype, the body and the chain. Raises
    on anything that kernel does not take; never falls back."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    # off the card the wrapper's checks refuse x without asking a library
    kernel = k5_variant(x.dtype, cfg, variant, si) if x.is_cuda else "simt"
    return _launch_k5(kernel, wb, x, cfg, variant)


def _shapenet_fwd_jac_on(kernel: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                         variant: str = "siren"):
    """K5 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape. ``chip_smoke.py``
    and the probes time the bodies side by side on the same inputs."""
    return _launch_k5(kernel, wb, x, cfg, variant)


def _shapenet_fwd_jac_simt(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                           variant: str = "siren"):
    """K5 on the CUDA-core kernel whatever the dtype and chain.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k5("simt", wb, x, cfg, variant)


def _device_tensor(a, name: str, shape, x: torch.Tensor, dtype) -> torch.Tensor:
    if tuple(a.shape) != tuple(shape) or a.device != x.device:
        raise ValueError(f"{name} {tuple(a.shape)} on {a.device} is not {tuple(shape)} "
                         f"on {x.device}")
    return a.to(dtype).contiguous()


def _launch_k6(kernel: str, wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
               jac_target: torch.Tensor, cfg: ShapeNetConfig, variant: str, w_value: float,
               w_jac: float, y_mask, jac_mask, weight: Optional[torch.Tensor]):
    """K6 through the library of ``kernel`` ("tc" or "simt"), after the
    wrapper's checks; counts the launch."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    _check_cuda_inputs("shapenet_sobolev_grads_cuda", wb, x, cfg, variant,
                       lambda c, v, P, d: sobolev_fused_unsupported_reason(c, v, P, si, d,
                                                                           x.dtype, kernel))
    G, P, si = x.shape
    so = cfg.output_dim
    target = _device_tensor(target, "target", (G, P, so), x, x.dtype)
    jac_target = _device_tensor(jac_target, "jac_target", (G, P, si * so), x, x.dtype)
    if weight is not None:
        weight = _device_tensor(weight, "weight", (G, P), x, x.dtype)
    ym = _mask_tensor(y_mask, so, x)
    jm = _mask_tensor(jac_mask, si * so, x)
    d_wb = torch.empty_like(wb, memory_format=torch.contiguous_format)
    losses = torch.empty(2, dtype=torch.float32, device=x.device)
    if G == 0 or P == 0:
        return losses[0].fill_(float("nan")), losses[1].fill_(float("nan")), d_wb.zero_()
    n_y, n_j, ky, kj = _sobolev_scales(G, P, si, so, w_value, w_jac, y_mask, jac_mask)
    wbp = _prescale(wb, cfg, variant).contiguous()
    # rows padded to 16 bytes, so every group's W_m stages with cp.async; the
    # CUDA-core kernel reads them widened to f32 (a bf16 value is exact in f32)
    wbp = (torch.nn.functional.pad(wbp, (0, -wbp.shape[1] % 8)) if kernel == "tc"
           else _simt_weights(wbp))
    x = x.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library(kernel)
    with torch.cuda.device(x.device):  # the geometry reads this device's SM count
        partials, scratch = _workspace("sobolev", cfg, variant, x, kernel)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), target.data_ptr(), jac_target.data_ptr(),
                ptr(ym), ptr(jm), ptr(weight), losses.data_ptr(), d_wb.data_ptr(),
                partials.data_ptr(), scratch.data_ptr(), G, P, si, so, cfg.units, _n_mats(cfg),
                _chain_code(cfg, variant), _act_code(cfg, variant, x.dtype), wb.shape[1])
        rest = (_n_scaled(cfg, variant), float(cfg.omega_0) if variant == "siren" else 1.0,
                ky, kj, float(n_y), float(n_j))
        if kernel == "tc":
            err = lib.nif_shapenet_sobolev_grads_tc(*args, wbp.shape[1], *rest, stream)
        else:
            err = lib.nif_shapenet_sobolev_grads(*args, wbp.shape[1], *rest,
                                                 _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "shapenet_sobolev_grads", err)
    _build.LAUNCHES["shapenet_sobolev_grads"] += 1
    if kernel == "tc":
        _build.LAUNCHES["shapenet_sobolev_grads_tc"] += 1
    return losses[0], losses[1], d_wb


def shapenet_sobolev_grads_cuda(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                jac_target: torch.Tensor, cfg: ShapeNetConfig,
                                variant: str = "siren", w_value: float = 1.0,
                                w_jac: float = 1.0, y_mask=None, jac_mask=None,
                                weight: Optional[torch.Tensor] = None):
    """Launch K6 on ``torch.cuda.current_stream()``: ``(value_mse, jac_mse,
    d_wb)`` as :func:`shapenet_sobolev_grads_reference` computes them,
    through the kernel :func:`k6_variant` picks for the dtype and the chain.
    Raises on anything that kernel does not take; never falls back."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    # off the card the wrapper's checks refuse x without asking a library
    kernel = k6_variant(x.dtype, cfg, variant, si) if x.is_cuda else "simt"
    return _launch_k6(kernel, wb, x, target, jac_target, cfg, variant, w_value, w_jac, y_mask,
                      jac_mask, weight)


def _shapenet_sobolev_grads_simt(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                 jac_target: torch.Tensor, cfg: ShapeNetConfig,
                                 variant: str = "siren", w_value: float = 1.0,
                                 w_jac: float = 1.0, y_mask=None, jac_mask=None,
                                 weight: Optional[torch.Tensor] = None):
    """K6 on the CUDA-core kernel whatever the dtype and width.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k6("simt", wb, x, target, jac_target, cfg, variant, w_value, w_jac, y_mask,
                      jac_mask, weight)


# ---------------------------------------------------------------- entries
def shapenet_fwd_jac(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                     variant: str = "siren"):
    """Fused ``(y, dy/dx)`` of the grouped chain: ``wb [G, po]``, ``x [G, P,
    si]`` -> ``y [G, P, so]``, ``jac [G, P, so, si]`` in x's dtype. Not
    differentiable (an evaluation kernel, as in the JAX package). A CUDA
    tensor launches K5, a CPU tensor runs plain K5; callers check
    :func:`fwd_jac_supported` first."""
    wb, x = wb.detach(), x.detach()
    if x.device.type == "cpu":
        return shapenet_fwd_jac_reference(wb, x, cfg, variant)
    return shapenet_fwd_jac_cuda(wb, x, cfg, variant)


def shapenet_sobolev_grads(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                           jac_target: torch.Tensor, cfg: ShapeNetConfig,
                           variant: str = "siren", w_value: float = 1.0, w_jac: float = 1.0,
                           y_mask=None, jac_mask=None, weight: Optional[torch.Tensor] = None):
    """Fused Sobolev train-step core: ``(value_mse, jac_mse, d_wb)`` (see
    :func:`shapenet_sobolev_grads_reference` for the arguments). The caller
    combines ``w_value value_mse + w_jac jac_mse`` and sends ``d_wb`` on
    through the ParameterNet. A CUDA tensor launches K6, a CPU tensor runs
    plain K6; callers check :func:`sobolev_fused_supported` first."""
    wb, x = wb.detach(), x.detach()
    if x.device.type == "cpu":
        return shapenet_sobolev_grads_reference(wb, x, target, jac_target, cfg, variant,
                                                w_value, w_jac, y_mask, jac_mask, weight)
    return shapenet_sobolev_grads_cuda(wb, x, target, jac_target, cfg, variant, w_value,
                                       w_jac, y_mask, jac_mask, weight)
