"""The fused Hessian kernels of the grouped ShapeNet chain (counterparts of
the Hessian part of ``nif_tpu/ops/pallas_shapenet.py``):

* **K7**, :func:`shapenet_fwd_hess`: ``wb [G, po]``, ``x [G, P, si]`` ->
  ``(y [G, P, so], jac [G, P, so, si], hess [G, P, so, si, si])`` in x's
  dtype. The value rows, the ``si`` tangent streams and one second-order
  stream per unique pair (j <= k) ride every product stacked (the Pallas
  ``_hess_fwd_layers``); the pairs are mirrored across the diagonal, so the
  Hessian is exactly symmetric.
* **K8**, :func:`shapenet_hessian_grads`: the same stacked forward with its
  residuals, the masked, weighted value, Jacobian and Hessian MSE (an
  off-diagonal pair counts twice) and the backward through the second-order
  chain, which multiplies by ``act'''``, in one pass: ``(value_mse,
  jac_mse, hess_mse, d_wb)`` (the Pallas ``_hessian_kernel``).

Sine chains only, si <= 4. The rounding points are K5/K6's
(``fused_derivatives``): the stacked state S is stored rounded, the raw
products Z stay f32, the epilogues run in f32 from Z, each D is rounded
before its product, the bias gradients sum the unrounded dz, the targets
are rounded to x's dtype and K7's outputs are cast to it.

On a CUDA tensor each entry launches its hand-written kernel, or raises. K7
and K8 have three bodies each (:func:`k7_variant`, :func:`k8_variant`):
bfloat16 runs, in order of preference, the first whose geometry takes the
shape: the wgmma body (``csrc/shapenet_hess_wgmma.cu``, ``"wgmma"``:
Hopper's warpgroup products fed by TMA; widths 64 and 128 at si = 3, so <=
4), the ``mma.sync`` body (``csrc/shapenet_hess_tc.cu``, ``"tc"``), then the
CUDA-core one (``csrc/shapenet_hess.cu``, ``"simt"``), which float32 always
runs: its f32 products never round to TF32. On a CPU tensor it runs the plain
PyTorch version (``*_reference``), which the CPU tests hold against the JAX
package's interpret-mode kernels and ``chip_smoke.py`` holds the CUDA
kernels against. Nothing here falls
back to another path: callers route (``ops.derivatives``,
``NIF.sobolev_value_and_grad``) with the ``*_supported`` gates.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ShapeNetConfig
from . import _build
from .fused_derivatives import (
    _acc,
    _device_tensor,
    _lifter,
    _mask_tensor,
    _sobolev_backward,
    _sobolev_scales,
    _tangent_forward,
)
from .fused_shapenet import (
    _DTYPE_CODES,
    _act_code,
    _chain_code,
    _check_cuda_inputs,
    _flat_grads,
    _n_mats,
    _n_scaled,
    _prescale,
    _raise_on_error,
    _simt_weights,
    _stack_tc_status,
    _unscale_grads,
    fused_unsupported_reason,
)

__all__ = [
    "shapenet_fwd_hess",
    "shapenet_fwd_hess_reference",
    "shapenet_fwd_hess_cuda",
    "shapenet_hessian_grads",
    "shapenet_hessian_grads_reference",
    "shapenet_hessian_grads_cuda",
    "fwd_hess_supported",
    "fwd_hess_unsupported_reason",
    "hessian_fused_supported",
    "hessian_fused_unsupported_reason",
    "hessian_geometry",
    "k7_variant",
    "k8_variant",
]

# Kernel bodies of csrc/shapenet_hess.cu (its enum Mode).
_MODES = {"eval": 0, "train": 1}


def _hess_pairs(si: int) -> List[Tuple[int, int]]:
    """Unique symmetric second-order index pairs, (j <= k) row-major."""
    return [(j, k) for j in range(si) for k in range(j, si)]


def _mirror(hp: torch.Tensor, si: int) -> torch.Tensor:
    """``[G, P, so, n_pairs]`` unique-pair columns -> the symmetric ``[G,
    P, so, si, si]`` Hessian (entry (j, k) and (k, j) are one column)."""
    col = {pq: a for a, pq in enumerate(_hess_pairs(si))}
    idx = [col[(min(j, k), max(j, k))] for j in range(si) for k in range(si)]
    return hp[..., idx].reshape(hp.shape[:-1] + (si, si))


# --------------------------------------------------------------- geometry
def k7_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None, variant: str = "siren",
               si: Optional[int] = None) -> str:
    """Which CUDA kernel K7 runs for inputs of ``dtype``. bfloat16 runs, in
    order of preference, the body whose geometry takes the chain:
    ``"wgmma"`` (``csrc/shapenet_hess_wgmma.cu``; widths 64 and 128 at si =
    3, so <= 4, every W_m and two stacked planes a consumer in shared
    memory), ``"tc"`` (the ``mma.sync`` body, ``csrc/shapenet_hess_tc.cu``;
    sine chains, si <= 4, a width whose two working planes fit), then
    ``"simt"`` (the CUDA-core kernel, ``csrc/shapenet_hess.cu``). float32
    (and any other dtype, which the wrapper refuses) runs ``"simt"``, whose
    products stay full f32. Without a chain bfloat16 names ``"tc"``, the
    body that takes every sine chain the tensor cores do. Given a chain
    (``cfg``, ``variant``, ``si``) this asks the bodies' libraries (it needs
    nvcc): the wgmma library only for a chain it has instances for."""
    return _variant("eval", dtype, cfg, variant, si)


def k8_variant(dtype: torch.dtype, cfg: Optional[ShapeNetConfig] = None, variant: str = "siren",
               si: Optional[int] = None) -> str:
    """Which CUDA kernel K8 runs for inputs of ``dtype``: the bodies and the
    order of :func:`k7_variant` (the K8 mode of each library; the wgmma body
    keeps every S plane of both consumers beside every W_m, so width 128
    takes two hidden matrices; the ``mma.sync`` body takes widths whose two
    working planes fit: up to 544 at si = 2, 336 at si = 3, 224 at si = 4
    with two hidden layers)."""
    return _variant("train", dtype, cfg, variant, si)


#: The widths and the si the wgmma K7/K8 body has instances for; its
#: library's workspace entry decides the rest of the chain (so, depth and
#: shared memory).
_WGMMA_WIDTHS = (64, 128)
_WGMMA_SI = 3
# K7's and K8's bf16 bodies, in the order a launch prefers them, and each
# one's suffix of its library's name and of its C entries and launch counters
_ROUTE = ("wgmma", "tc")
_BODY = {"wgmma": ("_wgmma", "_wg"), "tc": ("_tc", "_tc")}


def _variant(mode: str, dtype: torch.dtype, cfg: Optional[ShapeNetConfig], variant: str,
             si: Optional[int]) -> str:
    if dtype != torch.bfloat16:
        return "simt"
    if cfg is None:
        return "tc"
    si = cfg.input_dim if si is None else si
    for body in _ROUTE:
        if _body_status(body, mode, cfg, variant, si, 1, 1)[0] == 0:
            return body
    return "simt"


def _library(kernel: str = "simt") -> ctypes.CDLL:
    c_int, ptr, c_ll, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    if kernel in _BODY:
        # the wgmma body's C entries are the mma.sync body's, under their own names
        lib_sfx, sfx = _BODY[kernel]
        lib = _build.load_library("shapenet_hess" + lib_sfx)
        grads = getattr(lib, "nif_shapenet_hessian_grads" + sfx)
        if grads.argtypes is None:
            for entry in ("nif_shapenet_hess" + sfx + "_workspace",
                          "nif_shapenet_fwd_hess" + sfx + "_workspace"):
                getattr(lib, entry).argtypes = [c_int] * 7 + [ptr] * 7
                getattr(lib, entry).restype = c_int
            grads.argtypes = [ptr] * 13 + [c_int] * 8 + [c_ll] * 3 + [c_f] * 7 + [ptr]
            grads.restype = c_int
            evaluate = getattr(lib, "nif_shapenet_fwd_hess" + sfx)
            evaluate.argtypes = [ptr] * 6 + [c_int] * 8 + [c_ll, c_ll, ptr]
            evaluate.restype = c_int
    else:
        lib = _build.load_library("shapenet_hess")
        if lib.nif_shapenet_fwd_hess.argtypes is None:
            lib.nif_shapenet_hess_workspace.argtypes = [c_int] * 9 + [ptr] * 5
            lib.nif_shapenet_hess_workspace.restype = c_int
            lib.nif_shapenet_fwd_hess.argtypes = (
                [ptr] * 6 + [c_int] * 8 + [c_ll, c_ll, c_int, ptr])
            lib.nif_shapenet_fwd_hess.restype = c_int
            lib.nif_shapenet_hessian_grads.argtypes = (
                [ptr] * 13 + [c_int] * 8 + [c_ll] * 3 + [c_f] * 7 + [c_int, ptr])
            lib.nif_shapenet_hessian_grads.restype = c_int
    if lib.nif_cuda_error_string.argtypes is None:
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _body_status(body: str, mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int,
                 P: int):
    """``(status, geometry)`` of the bf16 K7 ("eval") or K8 ("train") on
    ``body``: the wgmma one (``csrc/shapenet_hess_wgmma.cu``; a chain it has
    no instance for, a width other than 64 or 128, si other than 3 or a
    vanilla chain, is status 3 without asking its library) or the
    ``mma.sync`` one (``csrc/shapenet_hess_tc.cu``)."""
    if body == "wgmma" and (variant != "siren" or cfg.units not in _WGMMA_WIDTHS
                            or si != _WGMMA_SI):
        return 3, {"mode": mode, "kernel": "wgmma"}
    workspace = getattr(_library(body), ("nif_shapenet_fwd_hess" if mode == "eval" else
                                         "nif_shapenet_hess") + _BODY[body][1] + "_workspace")
    return _stack_tc_status(workspace, mode, cfg, variant, si, G, P, kernel=body)


def _geometry_status(mode: str, cfg: ShapeNetConfig, variant: str, si: int, G: int, P: int,
                     dtype: torch.dtype, kernel: Optional[str] = None):
    """K7 ("eval") runs ``kernel`` or the variant :func:`k7_variant` picks,
    K8 ("train") ``kernel`` or the one :func:`k8_variant` picks. A named
    tensor-core body takes bfloat16 only."""
    if kernel not in (None, "wgmma", "tc", "simt"):
        raise ValueError(f"unknown K7/K8 body {kernel!r}")
    if kernel in ("wgmma", "tc") and dtype != torch.bfloat16:
        raise ValueError(f"the {kernel} K7/K8 body takes bfloat16 inputs, not {dtype}")
    pick = k7_variant if mode == "eval" else k8_variant
    body = kernel or pick(dtype, cfg, variant, si)
    if body != "simt":
        return _body_status(body, mode, cfg, variant, si, G, P)
    tile, splits = ctypes.c_int(), ctypes.c_int()
    smem, partial_floats, scratch = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    status = _library("simt").nif_shapenet_hess_workspace(
        _MODES[mode], cfg.units, si, cfg.output_dim, _n_mats(cfg), _chain_code(cfg, variant), G,
        P, _DTYPE_CODES[dtype], ctypes.byref(tile), ctypes.byref(splits), ctypes.byref(smem),
        ctypes.byref(partial_floats), ctypes.byref(scratch))
    geo = {"mode": mode, "kernel": "simt", "tile": tile.value, "splits": splits.value,
           "smem_bytes": smem.value, "residuals": "global" if scratch.value else "shared",
           "weights": "shared", "partial_floats": partial_floats.value,
           "scratch_bytes": scratch.value}
    return status, geo


def _status_reason(status: int, cfg: ShapeNetConfig, si: int, geo: dict) -> Optional[str]:
    if status == 0:
        return None
    if geo["kernel"] == "wgmma":
        what = "evaluation" if geo["mode"] == "eval" else "train"
        if status == 2:
            return (f"units={cfg.units} with {_n_mats(cfg)} hidden matrices needs "
                    f"{geo['smem_bytes']} bytes of shared memory per block in the wgmma Hessian "
                    f"{what} kernel (every W_m and the stacked planes of two consumers), more "
                    f"than a block may have")
        return (f"the wgmma Hessian {what} kernel has no instance for {cfg} with si={si} "
                f"(status {status})")
    if geo["kernel"] == "tc":
        what = "evaluation" if geo["mode"] == "eval" else "train"
        if status == 2:
            return (f"units={cfg.units} with si={si} needs {geo['smem_bytes']} bytes of shared "
                    f"memory per block in the tensor-core Hessian {what} kernel (two stacked "
                    f"planes of 16 points), more than a block may have")
        return (f"the tensor-core Hessian {what} kernel cannot take {cfg} with si={si} "
                f"(status {status})")
    if status == 1:
        return (f"units={cfg.units} is wider than the CUDA-core Hessian kernels take "
                f"(1024 columns, as the port's other CUDA-core kernels)")
    if status == 2:
        return (f"units={cfg.units} needs {geo['smem_bytes']} bytes of shared memory per "
                f"block, more than a block may have")
    return f"the CUDA Hessian kernels cannot take {cfg} with si={si} (status {status})"


def hessian_geometry(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int,
                     dtype: torch.dtype, si: Optional[int] = None,
                     kernel: Optional[str] = None) -> dict:
    """The launch geometry of one body ("eval" for K7, "train" for K8) at
    ``[G, P]`` in ``dtype``, from the library of ``kernel`` ("wgmma", "tc"
    or "simt"; it raises where that body cannot take the shape) or of the
    variant :func:`k7_variant`, :func:`k8_variant` pick (which ask the
    shape; it needs nvcc): the kernel, points per tile, P splits per group,
    shared memory per block, whether a tile's residuals and the staged
    weights sit in shared memory or in global memory, and the workspace
    sizes the wrappers allocate."""
    return _geometry(mode, cfg, variant, G, P, dtype, si, kernel)


def _geometry(mode: str, cfg: ShapeNetConfig, variant: str, G: int, P: int,
              dtype: torch.dtype, si: Optional[int] = None, kernel: Optional[str] = None) -> dict:
    si = cfg.input_dim if si is None else si
    status, geo = _geometry_status(mode, cfg, variant, si, G, P, dtype, kernel)
    if status != 0:
        raise ValueError(_status_reason(status, cfg, si, geo))
    return geo


def _cuda_reason(mode: str, cfg: ShapeNetConfig, variant: str, si: int, dtype: torch.dtype,
                 kernel: Optional[str] = None) -> Optional[str]:
    """The CUDA body's own limits (width, streams, shared memory) in the
    kernel that ``dtype`` runs."""
    if dtype not in _DTYPE_CODES:  # the wrapper refuses other dtypes itself
        return None
    status, geo = _geometry_status(mode, cfg, variant, si, 1, 1, dtype, kernel)
    return _status_reason(status, cfg, si, geo)


def _unsupported(mode: str, not_sine: str, cfg: ShapeNetConfig, variant: str, P: int,
                 si: int, device, dtype: torch.dtype = torch.bfloat16,
                 kernel: Optional[str] = None) -> Optional[str]:
    """The JAX package's gate and its strings (``not_sine`` for a vanilla
    chain; its P-tile rule always passes once P is a multiple of 8, which
    the base gate asks), then the CUDA body's own limits on a CUDA
    ``device``, in the kernel that ``dtype`` (or ``kernel``) runs."""
    if variant != "siren":
        return f"variant {variant!r}: {not_sine}"
    base = fused_unsupported_reason(cfg, variant, P)
    if base is not None:
        return base
    if si > 4:
        return (f"si={si}: {si * (si + 1) // 2} second-order streams exceed the practical "
                f"VMEM budget — XLA path")
    if device is not None and torch.device(device).type == "cuda":
        return _cuda_reason(mode, cfg, variant, si, dtype, kernel)
    return None


_K7_NOT_SINE = ("the fused hessian evaluation runs sine chains only (vanilla f'' stays on "
                "the XLA path)")


def fwd_hess_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                                device=None,
                                dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why K7 can NOT take this config (None = it can): the JAX package's
    reasons, then on a CUDA ``device`` the limits of the kernel that
    ``dtype`` runs (:func:`k7_variant`)."""
    return _unsupported("eval", _K7_NOT_SINE, cfg, variant, P, si, device, dtype)


def fwd_hess_supported(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                       device=None, dtype: torch.dtype = torch.bfloat16) -> bool:
    return fwd_hess_unsupported_reason(cfg, variant, P, si, device, dtype) is None


_K8_NOT_SINE = ("the hessian kernel runs sine chains only (f''' of the vanilla "
                "activations stays on the XLA path)")


def hessian_fused_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                                     device=None,
                                     dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why K8 can NOT take this config (None = it can): the JAX package's
    reasons, then on a CUDA ``device`` the limits of the kernel that
    ``dtype`` runs (:func:`k8_variant`)."""
    return _unsupported("train", _K8_NOT_SINE, cfg, variant, P, si, device, dtype)


def hessian_fused_supported(cfg: ShapeNetConfig, variant: str, P: int, si: int,
                            device=None, dtype: torch.dtype = torch.bfloat16) -> bool:
    return hessian_fused_unsupported_reason(cfg, variant, P, si, device, dtype) is None


# ----------------------------------------------------------- plain versions
def shapenet_fwd_hess_reference(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                                variant: str = "siren"):
    """The plain PyTorch version of K7: ``(y, jac, hess)`` in x's dtype,
    with the kernel's rounding points; ``hess`` mirrored from the unique
    pairs."""
    si = x.shape[-1]
    pairs = _hess_pairs(si)
    out, O, _ = _tangent_forward(_prescale(wb, cfg, variant), x, cfg, variant, save=False,
                                 pairs=pairs)
    jac = O[:, 1:1 + si].permute(0, 2, 3, 1)  # [G, si, P, so] -> [G, P, so, si]
    hp = O[:, 1 + si:].permute(0, 2, 3, 1).to(x.dtype)  # [G, P, so, n_pairs]
    return out.to(x.dtype), jac.to(x.dtype), _mirror(hp, si)


def _hess_scale(G: int, P: int, si: int, so: int, w_hess: float, hess_mask):
    """``(n_h, kh)``: the selected cells of the full si x si grid (an
    off-diagonal pair covers two) and the factor 2 w_hess / n_h."""
    if hess_mask is None:
        n_h = G * P * si * si * so
    else:
        hm = np.asarray(hess_mask, np.float32).reshape(-1, so)
        mult = np.array([1.0 if j == k else 2.0 for j, k in _hess_pairs(si)], np.float32)
        n_h = G * P * int(np.sum(hm * mult[:, None]))
    return n_h, 2.0 * float(w_hess) / n_h


def shapenet_hessian_grads_reference(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                     jac_target: torch.Tensor, hess_target: torch.Tensor,
                                     cfg: ShapeNetConfig, variant: str = "siren",
                                     w_value: float = 1.0, w_jac: float = 1.0,
                                     w_hess: float = 1.0, y_mask=None, jac_mask=None,
                                     hess_mask=None, weight: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K8: ``(value_mse, jac_mse, hess_mse,
    d_wb)`` of ``w_value mean_sel(weight (y - t)^2) + w_jac mean_sel(weight
    (jac - jt)^2) + w_hess mean_sel(weight (hess - ht)^2)``, the Hessian
    term over the full symmetric grid, with the kernel's rounding points.

    ``target [G, P, so]``; ``jac_target [G, P, si*so]`` (column ``k*so + j``
    = d y_j / d x_k); ``hess_target [G, P, n_pairs*so]`` (column ``a*so +
    j`` = d2 y_j / d x_{pair a}, unique pairs in :func:`_hess_pairs` order,
    symmetrized); all zero outside the 0/1 masks ``y_mask [so]``,
    ``jac_mask [si*so]``, ``hess_mask [n_pairs*so]`` (None = every entry)
    and cast to x's dtype. ``weight [G, P]`` (optional, cast to x's dtype)
    multiplies every squared error. The Hessian mean runs over the selected
    cells of the full grid, where an off-diagonal pair counts twice."""
    G, P, si = x.shape
    so = cfg.output_dim
    pairs = _hess_pairs(si)
    npairs = len(pairs)
    lift = _lifter(x.dtype)
    n_y, n_j, ky, kj = _sobolev_scales(G, P, si, so, w_value, w_jac, y_mask, jac_mask)
    n_h, kh = _hess_scale(G, P, si, so, w_hess, hess_mask)
    out, O, saved = _tangent_forward(_prescale(wb, cfg, variant), x, cfg, variant, save=True,
                                     pairs=pairs)
    err_y = out - lift(target)
    jt = lift(jac_target).reshape(G, P, si, so).permute(0, 2, 1, 3)  # [G, si, P, so]
    err_j = O[:, 1:1 + si] - jt
    ht = lift(hess_target).reshape(G, P, npairs, so).permute(0, 2, 1, 3)  # [G, np, P, so]
    err_h = O[:, 1 + si:] - ht
    ym = _mask_tensor(y_mask, so, x)
    if ym is not None:
        err_y = err_y * ym
    jm = _mask_tensor(jac_mask, si * so, x)
    if jm is not None:
        err_j = err_j * jm.reshape(si, 1, so)
    hm = _mask_tensor(hess_mask, npairs * so, x)
    if hm is not None:
        err_h = err_h * hm.reshape(npairs, 1, so)
    # an off-diagonal pair stands for two cells of the grid
    mult = torch.tensor([1.0 if j == k else 2.0 for j, k in pairs], dtype=_acc(x.dtype),
                        device=x.device).reshape(npairs, 1, 1)
    if weight is None:
        w = ws = 1.0
    else:
        w = lift(weight).unsqueeze(-1)  # [G, P, 1]
        ws = w.unsqueeze(1)  # over the streams
    lv = torch.sum(torch.square(err_y) * w)
    lj = torch.sum(torch.square(err_j) * ws)
    lh = torch.sum(mult * torch.square(err_h) * ws)
    D_out = torch.cat([(ky * err_y * w).unsqueeze(1), kj * err_j * ws,
                       (kh * mult) * err_h * ws], dim=1)
    dws, dbs = _sobolev_backward(D_out, x, saved, cfg, variant, pairs=pairs)
    d_wb = _unscale_grads(_flat_grads(dws, dbs, G), cfg, variant)
    return lv / n_y, lj / n_j, lh / n_h, d_wb.to(wb.dtype)


# ----------------------------------------------------------- CUDA wrappers
def _hess_weights(kernel: str, wbp: torch.Tensor) -> torch.Tensor:
    """wb' as the ``kernel``'s library reads it, rows padded so that every
    group's W_m stages with 16-byte copies (cp.async in the ``mma.sync``
    body, TMA in the wgmma one): the tensor-core bodies' in wb's dtype, the
    CUDA-core body's widened to f32 (a bf16 value is exact in f32)."""
    if kernel in ("tc", "wgmma"):
        return torch.nn.functional.pad(wbp, (0, -wbp.shape[1] % 8)).contiguous()
    return _simt_weights(wbp)


def _workspace(mode: str, cfg: ShapeNetConfig, variant: str, x: torch.Tensor,
               kernel: Optional[str] = None):
    geo = _geometry(mode, cfg, variant, x.shape[0], x.shape[1], x.dtype, kernel=kernel)
    partials = torch.empty(max(geo["partial_floats"], 1), dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(geo["scratch_bytes"], 1), dtype=torch.uint8, device=x.device)
    return partials, scratch


def _launch_k7(kernel: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
               variant: str):
    """K7 through the library of ``kernel`` ("wgmma", "tc" or "simt"), after
    the wrapper's checks; counts the launch."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    _check_cuda_inputs("shapenet_fwd_hess_cuda", wb, x, cfg, variant,
                       lambda c, v, P, d: _unsupported("eval", _K7_NOT_SINE, c, v, P, si, d,
                                                       x.dtype, kernel))
    G, P, si = x.shape
    so = cfg.output_dim
    y = torch.empty((G, P, so), dtype=x.dtype, device=x.device)
    jac = torch.empty((G, P, so, si), dtype=x.dtype, device=x.device)
    hp = torch.empty((G, P, so, len(_hess_pairs(si))), dtype=x.dtype, device=x.device)
    if G == 0 or P == 0:
        return y, jac, _mirror(hp, si)
    wbp = _hess_weights(kernel, _prescale(wb, cfg, variant))
    x = x.contiguous()
    lib = _library(kernel)
    with torch.cuda.device(x.device):  # the geometry reads this device's SM count
        _, scratch = _workspace("eval", cfg, variant, x, kernel)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), y.data_ptr(), jac.data_ptr(), hp.data_ptr(),
                scratch.data_ptr(), G, P, si, so, cfg.units, _n_mats(cfg),
                _chain_code(cfg, variant), _act_code(cfg, variant, x.dtype), wb.shape[1],
                wbp.shape[1])
        if kernel in _BODY:
            err = getattr(lib, "nif_shapenet_fwd_hess" + _BODY[kernel][1])(*args, stream)
        else:
            err = lib.nif_shapenet_fwd_hess(*args, _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "shapenet_fwd_hess", err)
    _build.LAUNCHES["shapenet_fwd_hess"] += 1
    if kernel in _BODY:
        _build.LAUNCHES["shapenet_fwd_hess" + _BODY[kernel][1]] += 1
    return y, jac, _mirror(hp, si)


def shapenet_fwd_hess_cuda(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                           variant: str = "siren"):
    """Launch K7 on ``torch.cuda.current_stream()``: ``(y, jac, hess)`` as
    :func:`shapenet_fwd_hess_reference` computes them, through the kernel
    :func:`k7_variant` picks for the dtype and the chain. Raises on anything
    that kernel does not take; never falls back."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    # off the card the wrapper's checks refuse x without asking a library
    kernel = k7_variant(x.dtype, cfg, variant, si) if x.is_cuda else "simt"
    return _launch_k7(kernel, wb, x, cfg, variant)


def _shapenet_fwd_hess_on(kernel: str, wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                          variant: str = "siren"):
    """K7 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape. ``chip_smoke.py``
    and the probes time the bodies side by side on the same inputs."""
    return _launch_k7(kernel, wb, x, cfg, variant)


def _shapenet_fwd_hess_simt(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                            variant: str = "siren"):
    """K7 on the CUDA-core kernel whatever the dtype and width.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k7("simt", wb, x, cfg, variant)


def _launch_k8(kernel: str, wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
               jac_target: torch.Tensor, hess_target: torch.Tensor, cfg: ShapeNetConfig,
               variant: str, w_value: float, w_jac: float, w_hess: float, y_mask, jac_mask,
               hess_mask, weight: Optional[torch.Tensor]):
    """K8 through the library of ``kernel`` ("wgmma", "tc" or "simt"), after
    the wrapper's checks; counts the launch."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    _check_cuda_inputs("shapenet_hessian_grads_cuda", wb, x, cfg, variant,
                       lambda c, v, P, d: _unsupported("train", _K8_NOT_SINE, c, v, P, si, d,
                                                       x.dtype, kernel))
    G, P, si = x.shape
    so = cfg.output_dim
    npairs = len(_hess_pairs(si))
    target = _device_tensor(target, "target", (G, P, so), x, x.dtype)
    jac_target = _device_tensor(jac_target, "jac_target", (G, P, si * so), x, x.dtype)
    hess_target = _device_tensor(hess_target, "hess_target", (G, P, npairs * so), x, x.dtype)
    if weight is not None:
        weight = _device_tensor(weight, "weight", (G, P), x, x.dtype)
    ym = _mask_tensor(y_mask, so, x)
    jm = _mask_tensor(jac_mask, si * so, x)
    hm = _mask_tensor(hess_mask, npairs * so, x)
    d_wb = torch.empty_like(wb, memory_format=torch.contiguous_format)
    losses = torch.empty(3, dtype=torch.float32, device=x.device)
    if G == 0 or P == 0:
        losses.fill_(float("nan"))
        return losses[0], losses[1], losses[2], d_wb.zero_()
    n_y, n_j, ky, kj = _sobolev_scales(G, P, si, so, w_value, w_jac, y_mask, jac_mask)
    n_h, kh = _hess_scale(G, P, si, so, w_hess, hess_mask)
    wbp = _hess_weights(kernel, _prescale(wb, cfg, variant))
    x = x.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library(kernel)
    with torch.cuda.device(x.device):
        partials, scratch = _workspace("train", cfg, variant, x, kernel)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (wbp.data_ptr(), x.data_ptr(), target.data_ptr(), jac_target.data_ptr(),
                hess_target.data_ptr(), ptr(ym), ptr(jm), ptr(hm), ptr(weight),
                losses.data_ptr(), d_wb.data_ptr(), partials.data_ptr(), scratch.data_ptr(), G,
                P, si, so, cfg.units, _n_mats(cfg), _chain_code(cfg, variant),
                _act_code(cfg, variant, x.dtype), wb.shape[1], wbp.shape[1],
                _n_scaled(cfg, variant), float(cfg.omega_0), ky, kj, kh, float(n_y),
                float(n_j), float(n_h))
        if kernel in _BODY:
            err = getattr(lib, "nif_shapenet_hessian_grads" + _BODY[kernel][1])(*args, stream)
        else:
            err = lib.nif_shapenet_hessian_grads(*args, _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "shapenet_hessian_grads", err)
    _build.LAUNCHES["shapenet_hessian_grads"] += 1
    if kernel in _BODY:
        _build.LAUNCHES["shapenet_hessian_grads" + _BODY[kernel][1]] += 1
    return losses[0], losses[1], losses[2], d_wb


def shapenet_hessian_grads_cuda(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                jac_target: torch.Tensor, hess_target: torch.Tensor,
                                cfg: ShapeNetConfig, variant: str = "siren",
                                w_value: float = 1.0, w_jac: float = 1.0, w_hess: float = 1.0,
                                y_mask=None, jac_mask=None, hess_mask=None,
                                weight: Optional[torch.Tensor] = None):
    """Launch K8 on ``torch.cuda.current_stream()``: ``(value_mse, jac_mse,
    hess_mse, d_wb)`` as :func:`shapenet_hessian_grads_reference` computes
    them, through the kernel :func:`k8_variant` picks for the dtype and the
    chain. Raises on anything that kernel does not take; never falls
    back."""
    si = x.shape[-1] if x.dim() == 3 else cfg.input_dim
    # off the card the wrapper's checks refuse x without asking a library
    kernel = k8_variant(x.dtype, cfg, variant, si) if x.is_cuda else "simt"
    return _launch_k8(kernel, wb, x, target, jac_target, hess_target, cfg, variant, w_value,
                      w_jac, w_hess, y_mask, jac_mask, hess_mask, weight)


def _shapenet_hessian_grads_on(kernel: str, wb: torch.Tensor, x: torch.Tensor,
                               target: torch.Tensor, jac_target: torch.Tensor,
                               hess_target: torch.Tensor, cfg: ShapeNetConfig,
                               variant: str = "siren", w_value: float = 1.0, w_jac: float = 1.0,
                               w_hess: float = 1.0, y_mask=None, jac_mask=None, hess_mask=None,
                               weight: Optional[torch.Tensor] = None):
    """K8 on one body ("wgmma", "tc" or "simt") whatever the routing
    prefers; raises where that body cannot take the shape. ``chip_smoke.py``
    and the probes time the bodies side by side on the same inputs."""
    return _launch_k8(kernel, wb, x, target, jac_target, hess_target, cfg, variant, w_value,
                      w_jac, w_hess, y_mask, jac_mask, hess_mask, weight)


def _shapenet_hessian_grads_simt(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                                 jac_target: torch.Tensor, hess_target: torch.Tensor,
                                 cfg: ShapeNetConfig, variant: str = "siren",
                                 w_value: float = 1.0, w_jac: float = 1.0, w_hess: float = 1.0,
                                 y_mask=None, jac_mask=None, hess_mask=None,
                                 weight: Optional[torch.Tensor] = None):
    """K8 on the CUDA-core kernel whatever the dtype and width.
    ``chip_smoke.py`` times its bf16 instance beside the tensor-core kernel
    on the same inputs."""
    return _launch_k8("simt", wb, x, target, jac_target, hess_target, cfg, variant, w_value,
                      w_jac, w_hess, y_mask, jac_mask, hess_mask, weight)


# ---------------------------------------------------------------- entries
def shapenet_fwd_hess(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                      variant: str = "siren"):
    """Fused ``(y, dy/dx, d2y/dx2)`` of the grouped chain: ``wb [G, po]``,
    ``x [G, P, si]`` -> ``y [G, P, so]``, ``jac [G, P, so, si]``, ``hess
    [G, P, so, si, si]`` (exactly symmetric) in x's dtype. Not
    differentiable (an evaluation kernel, as in the JAX package). A CUDA
    tensor launches K7, a CPU tensor runs plain K7; callers check
    :func:`fwd_hess_supported` first."""
    wb, x = wb.detach(), x.detach()
    if x.device.type == "cpu":
        return shapenet_fwd_hess_reference(wb, x, cfg, variant)
    return shapenet_fwd_hess_cuda(wb, x, cfg, variant)


def shapenet_hessian_grads(wb: torch.Tensor, x: torch.Tensor, target: torch.Tensor,
                           jac_target: torch.Tensor, hess_target: torch.Tensor,
                           cfg: ShapeNetConfig, variant: str = "siren", w_value: float = 1.0,
                           w_jac: float = 1.0, w_hess: float = 1.0, y_mask=None,
                           jac_mask=None, hess_mask=None,
                           weight: Optional[torch.Tensor] = None):
    """Fused second-order Sobolev train-step core: ``(value_mse, jac_mse,
    hess_mse, d_wb)`` (see :func:`shapenet_hessian_grads_reference` for the
    arguments). The caller combines the weighted terms and sends ``d_wb`` on
    through the ParameterNet. A CUDA tensor launches K8, a CPU tensor runs
    plain K8; callers check :func:`hessian_fused_supported` first."""
    wb, x = wb.detach(), x.detach()
    args = (wb, x, target, jac_target, hess_target, cfg, variant, w_value, w_jac, w_hess,
            y_mask, jac_mask, hess_mask, weight)
    if x.device.type == "cpu":
        return shapenet_hessian_grads_reference(*args)
    return shapenet_hessian_grads_cuda(*args)
