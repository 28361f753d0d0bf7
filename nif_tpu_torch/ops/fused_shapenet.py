"""K1: the fused forward of the grouped ShapeNet chain (counterpart of
``nif_tpu/ops/pallas_shapenet.py::shapenet_grouped_fused``'s forward).

:func:`shapenet_grouped_fused` takes ``wb [G, po]`` and ``x [G, P, si]`` to
``[G, P, so]`` in x's dtype (float32 or bfloat16) and computes what the
Pallas kernel's ``_forward_layers(save=False)`` computes:

* omega_0 is folded into every sine-fed weight matrix (all but the last
  layer) at the compute dtype before the kernel (:func:`_prescale`);
* every product is summed in f32 and every bias added in f32; activations
  are rounded to the compute dtype before each matmul;
* resblock and shortcut sums are taken in f32;
* the sine is the degree-7 polynomial of :func:`fast_sin` for bf16 compute
  (degree 9 under ``NIF_SIN_DEGREE=9``) and exact for f32 compute;
* the output is cast to x's dtype.

On a CUDA tensor it launches the hand-written kernel in
``nif_tpu_torch/csrc/shapenet_fwd.cu`` (:func:`shapenet_fwd_cuda`), or raises.
On a CPU tensor it runs :func:`shapenet_grouped_fused_reference`, the plain
PyTorch version of the same function, which the CPU tests hold against the
JAX package's interpret-mode kernel and ``chip_smoke.py`` holds the CUDA
kernel against. A config the kernel cannot take goes to the eager
:func:`~nif_tpu_torch.ops.shapenet.shapenet_grouped`, as in the JAX package.
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
    "fused_supported",
    "fused_unsupported_reason",
    "fast_sin",
    "kernel_geometry",
]

# sin(2*pi*t) ~ t*(c1 + c3 t^2 + c5 t^4 + c7 t^6 [+ c9 t^8]), t in [-0.5, 0.5]
_INV2PI = float(1.0 / (2.0 * np.pi))
_SIN_C = (6.28308846, -41.33324754, 81.40008977, -74.67588387, 33.16809461)
_SIN_C7 = (6.27863546, -41.09373072, 77.93034984, -56.08639487)


def _sin_degree() -> int:
    return 9 if os.environ.get("NIF_SIN_DEGREE") == "9" else 7


def fast_sin(y: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' sine: range-reduce to t = y/2pi - round(y/2pi)
    (half to even), then an odd minimax polynomial in t. Degree 7 (max error
    2.5e-4) by default, degree 9 (1.7e-5) under ``NIF_SIN_DEGREE=9``."""
    t = y * _INV2PI
    t = t - torch.round(t)
    s = t * t
    if _sin_degree() == 7:
        c1, c3, c5, c7 = _SIN_C7
        return t * (c1 + s * (c3 + s * (c5 + s * c7)))
    c1, c3, c5, c7, c9 = _SIN_C
    return t * (c1 + s * (c3 + s * (c5 + s * (c7 + s * c9))))


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

# Codes shared with csrc/shapenet_fwd.cu (enum Act, enum Chain).
_ACT_CODES = {"poly7": 0, "poly9": 1, "sine": 2, "tanh": 3, "relu": 4,
              "swish": 5, "silu": 5, "sigmoid": 6, "linear": 7}
_CHAIN_CODES = {"siren": 0, "siren_resblock": 1, "vanilla": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_geometry(cfg: ShapeNetConfig) -> Tuple[Optional[int], Optional[str]]:
    """``(points per block, None)`` of the CUDA kernel at this width, or
    ``(None, reason)`` when the kernel cannot take it. The kernel's library
    owns the geometry, so this builds it on first use (it needs nvcc)."""
    tile, smem = ctypes.c_int(), ctypes.c_longlong()
    status = _library().nif_shapenet_fwd_geometry(
        cfg.units, cfg.input_dim, ctypes.byref(tile), ctypes.byref(smem))
    if status == 0:
        return tile.value, None
    if status == 1:
        return None, (f"units={cfg.units} is wider than the CUDA kernel takes (it "
                      f"keeps a thread's columns of a layer in registers)")
    if status == 2:
        return None, (f"input_dim={cfg.input_dim} needs {smem.value} bytes of shared "
                      f"memory per block, more than a block may have")
    raise ValueError(f"the CUDA kernel cannot take {cfg} (geometry status {status})")


def fused_unsupported_reason(cfg: ShapeNetConfig, variant: str, P: int,
                             device=None) -> Optional[str]:
    """Why the fused kernel can NOT handle this config (None = it can).

    The reasons and their strings are the JAX package's; the P rule is kept
    for routing parity with it (its kernel tiles P in multiples of 8), though
    this kernel masks a ragged edge. On a CUDA ``device`` the CUDA kernel's
    own width limits (:func:`kernel_geometry`) apply too; the plain version
    that runs elsewhere takes any width."""
    if cfg.connectivity != "full":
        return f"connectivity={cfg.connectivity!r} (fused kernel runs the full generated chain)"
    if variant == "vanilla" and cfg.activation not in _VANILLA_ACTS:
        return f"activation {cfg.activation!r} has no fused kernel implementation"
    if cfg.units < 8:
        return f"units={cfg.units} < 8 (tiny widths gain nothing from the kernel)"
    if device is not None and torch.device(device).type == "cuda":
        reason = kernel_geometry(cfg)[1]
        if reason is not None:
            return reason
    if P % 8:
        return (f"points-per-group P={P} is not divisible by any supported "
                f"point tile — pad P to a multiple of 256")
    return None


def fused_supported(cfg: ShapeNetConfig, variant: str, P: int, device=None) -> bool:
    """Whether the fused kernel handles this config (else the eager path)."""
    return fused_unsupported_reason(cfg, variant, P, device) is None


def _n_mats(cfg: ShapeNetConfig) -> int:
    return 2 * cfg.nlayers if cfg.use_resblock else cfg.nlayers


def _prescale(wb: torch.Tensor, cfg: ShapeNetConfig, variant: str) -> torch.Tensor:
    """Fold omega_0 into the sine-fed weight matrices (all but the linear
    last layer) at wb's dtype: for bf16, ``bf16(w) * bf16(omega_0)`` rounds
    to bf16 as the JAX package's ``_prescale`` does. The weights lie first
    in the flat order, so this scales one leading slice of each row."""
    if variant != "siren":
        return wb
    k = cfg.input_dim * cfg.units + _n_mats(cfg) * cfg.units ** 2
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
    lib = _build.load_library("shapenet_fwd")
    fn = lib.nif_shapenet_fwd
    if fn.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr] + [c_int] * 9 + [ctypes.c_longlong, c_int, ptr]
        fn.restype = c_int
        lib.nif_shapenet_fwd_geometry.argtypes = [c_int, c_int, ptr, ptr]
        lib.nif_shapenet_fwd_geometry.restype = c_int
        lib.nif_cuda_error_string.argtypes = [c_int]
        lib.nif_cuda_error_string.restype = ctypes.c_char_p
    return lib


def shapenet_fwd_cuda(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                      variant: str = "siren") -> torch.Tensor:
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on anything the kernel does not take: a tensor not on CUDA, a
    dtype other than float32/bfloat16 (wb and x must share it), a shape that
    does not match ``cfg``, an unsupported config, or an input that requires
    grad (the fused backward is not ported yet). A build or launch failure
    raises too; nothing here falls back to another path."""
    if variant not in ("siren", "vanilla"):
        raise ValueError(f"unknown shapenet variant {variant!r}")
    if not (x.is_cuda and wb.is_cuda and wb.device == x.device):
        raise ValueError(f"shapenet_fwd_cuda needs wb and x on one CUDA device, "
                         f"got {wb.device} and {x.device}")
    if x.dtype not in _DTYPE_CODES or wb.dtype != x.dtype:
        raise TypeError(f"shapenet_fwd_cuda takes float32 or bfloat16 wb and x of "
                        f"one dtype, got {wb.dtype} and {x.dtype}")
    if wb.requires_grad or x.requires_grad:
        raise RuntimeError("shapenet_fwd_cuda has no backward yet: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.dim() != 3 or wb.dim() != 2 or wb.shape[0] != x.shape[0]:
        raise ValueError(f"expected wb [G, po] and x [G, P, si], got "
                         f"{tuple(wb.shape)} and {tuple(x.shape)}")
    G, P, si = x.shape
    po = wb.shape[1]
    reason = fused_unsupported_reason(cfg, variant, P, x.device)
    if reason is not None:
        raise ValueError(f"shapenet_fwd_cuda cannot take this config: {reason}")
    if si != cfg.input_dim or po != shapenet_param_count(cfg, 0):
        raise ValueError(f"wb {tuple(wb.shape)} / x {tuple(x.shape)} do not match {cfg}")
    out = torch.empty((G, P, cfg.output_dim), dtype=x.dtype, device=x.device)
    if G == 0 or P == 0:
        return out
    wbp = _prescale(wb, cfg, variant).contiguous()
    x = x.contiguous()
    chain = ("siren_resblock" if cfg.use_resblock else "siren") if variant == "siren" else "vanilla"
    n_steps = cfg.nlayers * (2 if chain == "siren_resblock" else 1)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nif_shapenet_fwd(
            wbp.data_ptr(), x.data_ptr(), out.data_ptr(), G, P, si, cfg.output_dim,
            cfg.units, _n_mats(cfg), n_steps, _CHAIN_CODES[chain],
            _act_code(cfg, variant, x.dtype), po, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        msg = lib.nif_cuda_error_string(err).decode()
        raise RuntimeError(f"shapenet_fwd kernel launch failed: CUDA error {err} ({msg})")
    _build.LAUNCHES["shapenet_fwd"] += 1
    return out


def shapenet_grouped_fused(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                           variant: str = "siren") -> torch.Tensor:
    """Fused replacement for :func:`shapenet_grouped`: ``wb [G, po]``,
    ``x [G, P, si]`` -> ``[G, P, so]``.

    A config the kernel cannot take (:func:`fused_unsupported_reason`) runs
    the eager path, as the JAX package's does. Otherwise a CUDA tensor
    launches the kernel and a CPU tensor runs the plain version."""
    if not fused_supported(cfg, variant, x.shape[1], x.device):
        return shapenet_grouped(wb, x, cfg, variant)
    if x.device.type == "cpu":
        return shapenet_grouped_fused_reference(wb, x, cfg, variant)
    return shapenet_fwd_cuda(wb, x, cfg, variant)
