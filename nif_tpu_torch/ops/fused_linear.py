"""The fused NIF-linear train kernel (counterpart of
``nif_tpu/ops/pallas_shapenet.py``'s ``niflinear_mse_grads``):

* **K4**, :func:`niflinear_mse_grads`: NIF-linear's ``u = phi(x) . a(t) +
  bias`` with a shared-weight SIREN trunk ``x -> phi(x)`` whose last (linear)
  layer, the bottleneck, has width ``so * K``. One pass runs the trunk
  forward, the contraction with the per-group latent ``a [G, K]``, the
  weighted MSE and the whole backward, and returns ``(loss, d_ws, d_bs,
  d_a, d_bias)``, all f32 sums divided by ``G * P * so`` (the Pallas
  ``_linear_train_kernel``).

Rounding points, beyond those of K2 (``fused_shapenet``): the bottleneck
output ``phi`` stays f32 and is not rounded before the contraction; ``a`` and
``bias`` enter at the compute dtype and are taken in f32; the target and the
weight are rounded to x's dtype; ``d_phi = go_o * a`` is f32 and the backward
starts from its rounding to the compute dtype.

On a CUDA tensor :func:`niflinear_mse_grads` launches a hand-written kernel,
or raises: bfloat16 goes to the tensor-core kernel
(``nif_tpu_torch/csrc/shapenet_linear_tc.cu``, variant ``"tc"``) where its
geometry takes the trunk, float32 and the bfloat16 trunks it refuses to the
CUDA-core one (``csrc/shapenet_linear.cu``, variant ``"simt"``), whose f32
products never round to TF32; :func:`k4_variant` names the variant. On a CPU
tensor it runs the plain PyTorch version (:func:`niflinear_mse_grads_reference`),
which the CPU tests hold against the JAX package's interpret-mode kernel and
``chip_smoke.py`` holds both CUDA kernels against. Nothing here falls back to
another path: the model routes with :func:`linear_fused_supported`.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..config import ShapeNetConfig
from . import _build
from .fused_shapenet import (
    _DTYPE_CODES,
    _chain_code,
    _forward_saved,
    _n_mats,
    _n_scaled,
    _prescale,
    _raise_on_error,
    _train_act_code,
    _unscale_grads,
    backward_chain_reference,
)

__all__ = [
    "niflinear_mse_grads",
    "niflinear_mse_grads_reference",
    "niflinear_mse_grads_cuda",
    "k4_variant",
    "linear_fused_supported",
    "linear_fused_unsupported_reason",
    "linear_geometry",
]


# --------------------------------------------------------------- geometry
def k4_variant(dtype: torch.dtype, trunk_cfg: Optional[ShapeNetConfig] = None,
               so: Optional[int] = None) -> str:
    """Which CUDA kernel K4 runs for inputs of ``dtype``: ``"tc"`` (the
    tensor-core kernel, ``csrc/shapenet_linear_tc.cu``) for bfloat16,
    ``"simt"`` (the CUDA-core kernel, ``csrc/shapenet_linear.cu``) for
    float32, whose products stay full f32 (and for any other dtype, which
    the wrapper refuses). Given a trunk (``trunk_cfg``, ``so``; this asks the
    tensor-core kernel's library, so it needs nvcc), bfloat16 runs the
    CUDA-core kernel where the tensor-core one does not take the trunk (a
    width whose planes exceed a block's shared memory or its registers)."""
    if dtype != torch.bfloat16:
        return "simt"
    if trunk_cfg is None:
        return "tc"
    return "tc" if _tc_status(trunk_cfg, so, 1, 1)[0] == 0 else "simt"


def _library(variant: str = "simt") -> ctypes.CDLL:
    c_int, ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    if variant == "tc":
        lib = _build.load_library("shapenet_linear_tc")
        if lib.nif_linear_mse_grads_tc.argtypes is None:
            lib.nif_linear_tc_workspace.argtypes = [c_int] * 7 + [ptr] * 4
            lib.nif_linear_tc_workspace.restype = c_int
            lib.nif_linear_mse_grads_tc.argtypes = (
                [ptr] * 11 + [c_int] * 9 + [c_ll, ctypes.c_float, ptr])
            lib.nif_linear_mse_grads_tc.restype = c_int
    else:
        lib = _build.load_library("shapenet_linear")
        if lib.nif_linear_mse_grads.argtypes is None:
            lib.nif_linear_workspace.argtypes = [c_int] * 8 + [ptr] * 5
            lib.nif_linear_workspace.restype = c_int
            lib.nif_linear_mse_grads.argtypes = (
                [ptr] * 12 + [c_int] * 9 + [c_ll, ctypes.c_float, c_int, ptr])
            lib.nif_linear_mse_grads.restype = c_int
    if lib.nif_cuda_error_string.argtypes is None:
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _dims(trunk_cfg: ShapeNetConfig, so: int, G: int, P: int):
    return (trunk_cfg.units, trunk_cfg.input_dim, so, trunk_cfg.output_dim // so,
            _n_mats(trunk_cfg), G, P)


def _tc_status(trunk_cfg: ShapeNetConfig, so: int, G: int, P: int):
    """``(status, geometry)`` of the tensor-core K4 (``csrc/shapenet_linear_tc.cu``)."""
    tile, splits = ctypes.c_int(), ctypes.c_int()
    smem, partial_floats = ctypes.c_longlong(), ctypes.c_longlong()
    status = _library("tc").nif_linear_tc_workspace(
        *_dims(trunk_cfg, so, G, P), ctypes.byref(tile), ctypes.byref(splits),
        ctypes.byref(smem), ctypes.byref(partial_floats))
    return status, {"variant": "tc", "tile": tile.value, "splits": splits.value,
                    "smem_bytes": smem.value, "residuals": "shared",
                    "partial_floats": partial_floats.value, "scratch_bytes": 0}


def _geometry_status(trunk_cfg: ShapeNetConfig, so: int, G: int, P: int, dtype: torch.dtype):
    if k4_variant(dtype, trunk_cfg, so) == "tc":
        return _tc_status(trunk_cfg, so, G, P)
    tile, blocks = ctypes.c_int(), ctypes.c_int()
    smem, partial_floats, scratch = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    status = _library("simt").nif_linear_workspace(
        *_dims(trunk_cfg, so, G, P), _DTYPE_CODES[dtype], ctypes.byref(tile),
        ctypes.byref(blocks), ctypes.byref(smem), ctypes.byref(partial_floats),
        ctypes.byref(scratch))
    # the CUDA-core kernel is one wave of blocks over all G x P / tile tiles
    geo = {"variant": "simt", "tile": tile.value, "blocks": blocks.value,
           "smem_bytes": smem.value, "residuals": "global" if scratch.value else "shared",
           "partial_floats": partial_floats.value, "scratch_bytes": scratch.value}
    return status, geo


def _status_reason(status: int, trunk_cfg: ShapeNetConfig, geo: dict) -> Optional[str]:
    if status == 0:
        return None
    width = max(trunk_cfg.units, trunk_cfg.output_dim)
    kernel = ("tensor-core NIF-linear kernel" if geo["variant"] == "tc"
              else "CUDA NIF-linear kernel")
    if status == 1:
        return (f"trunk width {width} (units or so*latent_dim) is wider than the {kernel} "
                f"takes (a {'warp' if geo['variant'] == 'tc' else 'thread'} keeps its "
                f"columns of a layer in registers)")
    if status == 2:
        return (f"trunk width {width} needs {geo['smem_bytes']} bytes of shared memory per "
                f"block in the {kernel}, more than a block may have")
    return f"the {kernel} cannot take {trunk_cfg} (status {status})"


def linear_geometry(trunk_cfg: ShapeNetConfig, so: int, G: int, P: int,
                    dtype: torch.dtype) -> dict:
    """The launch geometry K4 takes for ``[G, P]`` in ``dtype``, from the
    library of the variant :func:`k4_variant` picks (it needs nvcc): the
    variant, points per tile, the tensor-core kernel's ``splits`` (P splits
    per group) or the CUDA-core kernel's ``blocks`` (one wave over all G x
    P / tile tiles), shared memory per block, whether a tile's residuals sit
    in shared memory or in a per-block global scratch, and the workspace
    sizes the wrapper allocates."""
    status, geo = _geometry_status(trunk_cfg, so, G, P, dtype)
    if status != 0:
        raise ValueError(_status_reason(status, trunk_cfg, geo))
    return geo


def linear_fused_unsupported_reason(trunk_cfg: ShapeNetConfig, so: int, P: int,
                                    device=None,
                                    dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why K4 can NOT take this config (None = it can). ``trunk_cfg`` is the
    phi trunk viewed as a full-connectivity chain (output_dim = so * K). The
    reasons and their strings are the JAX package's, in its order (the P
    rule kept for routing parity: its kernel tiles P in multiples of 8, this
    one masks a ragged tile); on a CUDA ``device`` the width and
    shared-memory limits of the kernel that ``dtype`` runs
    (:func:`k4_variant`) apply too."""
    if so > 8:
        return f"output_dim={so} > 8 (per-output contraction loop is static)"
    if trunk_cfg.output_dim % so != 0:
        return "trunk output width is not a multiple of output_dim"
    if trunk_cfg.units < 8:
        return f"units={trunk_cfg.units} < 8 (tiny widths gain nothing from the kernel)"
    if (device is not None and torch.device(device).type == "cuda"
            and dtype in _DTYPE_CODES):  # the wrapper refuses other dtypes itself
        status, geo = _geometry_status(trunk_cfg, so, 1, 1, dtype)
        reason = _status_reason(status, trunk_cfg, geo)
        if reason is not None:
            return reason
    if P % 8:
        return (f"points-per-group P={P} is not divisible by any supported "
                f"point tile — pad P to a multiple of 256")
    if trunk_cfg.connectivity != "full":
        return f"trunk connectivity={trunk_cfg.connectivity!r}"
    return None


def linear_fused_supported(trunk_cfg: ShapeNetConfig, so: int, P: int, device=None,
                           dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether K4 takes this config (else the model's eager path)."""
    return linear_fused_unsupported_reason(trunk_cfg, so, P, device, dtype) is None


# ----------------------------------------------------------- plain version
def _flat_trunk(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-layer weights and biases in chain order -> ``[po]`` in the chain
    layout ``[W_first | W_hidden... | W_bot | b_first | ... | b_bot]``."""
    return torch.cat([w.reshape(-1) for w in ws] + [b.reshape(-1) for b in bs])


def _split_trunk(flat: torch.Tensor, ws, bs):
    """The inverse of :func:`_flat_trunk`: ``(d_ws, d_bs)`` shaped as ws, bs."""
    sizes = [w.numel() for w in ws] + [b.numel() for b in bs]
    parts = torch.split(flat, sizes)
    n = len(ws)
    return ([p.reshape(w.shape) for p, w in zip(parts[:n], ws)],
            [p.reshape(b.shape) for p, b in zip(parts[n:], bs)])


def _check_shapes(ws, bs, a, bias, x, target, trunk_cfg: ShapeNetConfig, so: int, weight):
    G, P, si = x.shape
    K = a.shape[-1]
    if trunk_cfg.output_dim != so * K:
        raise ValueError(f"trunk output width {trunk_cfg.output_dim} != so * K = {so} * {K}")
    if len(ws) != len(bs) or len(ws) != _n_mats(trunk_cfg) + 2:
        raise ValueError(f"expected {_n_mats(trunk_cfg) + 2} trunk weights and biases, got "
                         f"{len(ws)} and {len(bs)}")
    if (si != trunk_cfg.input_dim or tuple(a.shape) != (G, K) or tuple(bias.shape) != (so,)
            or tuple(target.shape) != (G, P, so)
            or (weight is not None and tuple(weight.shape) != (G, P))):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, a {tuple(a.shape)}, bias "
                         f"{tuple(bias.shape)}, target {tuple(target.shape)}, weight "
                         f"{None if weight is None else tuple(weight.shape)} for {trunk_cfg} "
                         f"with so={so}")


def niflinear_mse_grads_reference(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                                  a: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                                  target: torch.Tensor, trunk_cfg: ShapeNetConfig, so: int,
                                  weight: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K4, with its rounding points:
    ``(loss, d_ws, d_bs, d_a [G, K], d_bias [so])`` of ``mean(weight * (phi(x)
    . a + bias - target)^2)`` over the G*P*so outputs, every output f32.

    ``ws``/``bs`` are the trunk's weight matrices and biases in chain order
    (shared by every group; the bottleneck ``[n, so*K]`` last), in x's dtype,
    as are ``a [G, K]`` and ``bias [so]``; ``x [G, P, si]``, ``target [G, P,
    so]`` and ``weight [G, P]`` (optional, both cast to x's dtype)."""
    _check_shapes(ws, bs, a, bias, x, target, trunk_cfg, so, weight)
    G, P, _ = x.shape
    K = a.shape[-1]
    cdt = x.dtype
    acc = torch.promote_types(cdt, torch.float32)
    flat = _flat_trunk([w.to(cdt) for w in ws], [b.to(cdt) for b in bs])
    phi, ins, dacts, wl = _forward_saved(_prescale(flat[None], trunk_cfg, "siren"), x, trunk_cfg,
                                         "siren")
    phi = phi.reshape(G, P, so, K)
    a_f = a.to(cdt).to(acc)
    u = torch.einsum("gpok,gk->gpo", phi, a_f) + bias.to(cdt).to(acc)
    err = u - target.to(cdt).to(acc)
    if weight is None:
        loss = torch.sum(torch.square(err))
        go = 2.0 * err
    else:
        w = weight.to(cdt).to(acc).unsqueeze(-1)
        loss = torch.sum(torch.square(err) * w)
        go = 2.0 * err * w
    d_bias = go.sum(dim=(0, 1))
    d_a = torch.einsum("gpok,gpo->gk", phi, go)
    d_phi = (go.unsqueeze(-1) * a_f[:, None, None, :]).reshape(G, P, so * K)
    dws, dbs, _ = backward_chain_reference(d_phi, wl, ins, dacts, trunk_cfg, "siren",
                                           need_dx=False)
    d_flat = torch.cat([d.sum(dim=0).reshape(-1) for d in dws]
                       + [d.sum(dim=0).reshape(-1) for d in dbs])
    n_elem = G * P * so
    d_ws, d_bs = _split_trunk(_unscale_grads(d_flat, trunk_cfg, "siren") / n_elem, ws, bs)
    return loss / n_elem, d_ws, d_bs, d_a / n_elem, d_bias / n_elem


# ----------------------------------------------------------------- kernel
def niflinear_mse_grads_cuda(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                             a: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                             target: torch.Tensor, trunk_cfg: ShapeNetConfig, so: int,
                             weight: Optional[torch.Tensor] = None):
    """Launch K4 on ``torch.cuda.current_stream()``: what
    :func:`niflinear_mse_grads_reference` computes, from the same arguments,
    through the kernel :func:`k4_variant` picks for the dtype and the trunk
    (the tensor-core kernel for bfloat16 where it takes the trunk, the
    CUDA-core kernel otherwise). Raises on anything the kernel does not
    take (tensors off one CUDA
    device, a dtype other than float32/bfloat16 shared by x, the trunk, a
    and bias, inputs that require grad, mismatched shapes, a config the gate
    refuses); a build or launch failure raises too. Never falls back."""
    _check_shapes(ws, bs, a, bias, x, target, trunk_cfg, so, weight)
    params = [*ws, *bs, a, bias]
    tensors = params + [target] + ([] if weight is None else [weight])
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("niflinear_mse_grads_cuda needs every tensor on x's CUDA device, "
                         f"x is on {x.device}")
    if x.dtype not in _DTYPE_CODES or any(p.dtype != x.dtype for p in params):
        raise TypeError("niflinear_mse_grads_cuda takes float32 or bfloat16 x, trunk, a and "
                        f"bias of one dtype, got x {x.dtype} and "
                        f"{sorted({str(p.dtype) for p in params})}")
    if x.requires_grad or any(p.requires_grad for p in params):
        raise RuntimeError("niflinear_mse_grads_cuda has no backward of its own: call it on "
                           "detached tensors")
    G, P, si = x.shape
    K = a.shape[-1]
    dev = x.device
    with torch.cuda.device(dev):  # the geometry reads this device's SM count
        status, geo = _geometry_status(trunk_cfg, so, max(G, 1), max(P, 1), x.dtype)
    reason = (linear_fused_unsupported_reason(trunk_cfg, so, P)
              or _status_reason(status, trunk_cfg, geo))
    if reason is not None:
        raise ValueError(f"niflinear_mse_grads_cuda cannot take this config: {reason}")
    kernel = geo["variant"]
    loss = torch.empty((), dtype=torch.float32, device=dev)
    d_a = torch.empty((G, K), dtype=torch.float32, device=dev)
    d_bias = torch.empty((so,), dtype=torch.float32, device=dev)
    flat = _flat_trunk(ws, bs)
    d_flat = torch.empty(flat.shape, dtype=torch.float32, device=dev)
    if G == 0 or P == 0:
        d_ws, d_bs = _split_trunk(d_flat.zero_(), ws, bs)
        return loss.fill_(float("nan")), d_ws, d_bs, d_a.zero_(), d_bias.zero_()
    wbp = _prescale(flat, trunk_cfg, "siren")
    # the CUDA-core kernel reads the trunk widened to f32 (a bf16 value is exact in f32)
    wbp = (wbp if kernel == "tc" else wbp.float()).contiguous()
    a, bias, x = a.contiguous(), bias.contiguous(), x.contiguous()
    target = target.to(x.dtype).contiguous()
    weight = None if weight is None else weight.to(x.dtype).contiguous()
    lib = _library(kernel)
    ptrs = (wbp.data_ptr(), a.data_ptr(), bias.data_ptr(), x.data_ptr(), target.data_ptr(),
            None if weight is None else weight.data_ptr(), loss.data_ptr(), d_flat.data_ptr(),
            d_a.data_ptr(), d_bias.data_ptr())
    dims = (G, P, si, so, K, trunk_cfg.units, _n_mats(trunk_cfg),
            _chain_code(trunk_cfg, "siren"), _train_act_code(trunk_cfg, "siren", x.dtype),
            _n_scaled(trunk_cfg, "siren"), float(trunk_cfg.omega_0))
    with torch.cuda.device(dev):
        partials = torch.empty(geo["partial_floats"], dtype=torch.float32, device=dev)
        ptrs = ptrs + (partials.data_ptr(),)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "tc":
            err = lib.nif_linear_mse_grads_tc(*ptrs, *dims, stream)
        else:
            scratch = torch.empty(max(geo["scratch_bytes"], 1), dtype=torch.uint8, device=dev)
            err = lib.nif_linear_mse_grads(*ptrs, scratch.data_ptr(), *dims,
                                           _DTYPE_CODES[x.dtype], stream)
    _raise_on_error(lib, "niflinear_mse_grads", err)
    _build.LAUNCHES["niflinear_mse_grads"] += 1
    if kernel == "tc":
        _build.LAUNCHES["niflinear_mse_grads_tc"] += 1
    d_ws, d_bs = _split_trunk(d_flat, ws, bs)
    return loss, d_ws, d_bs, d_a, d_bias


def niflinear_mse_grads(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                        a: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                        target: torch.Tensor, trunk_cfg: ShapeNetConfig, so: int,
                        weight: Optional[torch.Tensor] = None):
    """Fused NIF-linear train-step core: ``(loss, d_ws, d_bs, d_a, d_bias)``
    of the weighted MSE ``mean(weight * (phi(x) . a + bias - target)^2)``,
    every output an f32 sum divided by ``G * P * so``. ``ws``/``bs``: the
    trunk's weight matrices and biases in chain order, shared by every group
    (the bottleneck of width ``so * K`` last); ``a [G, K]``, ``bias [so]``,
    ``x [G, P, si]``, ``target [G, P, so]``, ``weight [G, P]`` (optional).
    Not differentiable: the caller sends ``d_a`` on through the ParameterNet.

    A CUDA tensor launches K4; a CPU tensor runs plain K4."""
    detach: List[torch.Tensor] = [t.detach() for t in (*ws, *bs, a, bias, x)]
    n = len(ws)
    ws, bs = detach[:n], detach[n:2 * n]
    a, bias, x = detach[2 * n:]
    if x.device.type == "cpu":
        return niflinear_mse_grads_reference(ws, bs, a, bias, x, target, trunk_cfg, so, weight)
    return niflinear_mse_grads_cuda(ws, bs, a, bias, x, target, trunk_cfg, so, weight)
