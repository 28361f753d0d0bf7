"""Post-training quantization (counterpart of
``nif_tpu/compression/quantization.py``).

Tutorial 7 of the reference quantizes the ParameterNet with tfmot
(reference README.md:228-230). Here:

* storage PTQ: symmetric int8 of the kernel tensors (rank >= 2), one f32
  scale per output channel (the last axis) or per tensor; biases stay as
  they are. :func:`dequantize_params` rebuilds a float params tree.
* executed int8 inference for NIF-linear's ROM decode ``u = phi(x) . a(t)
  + b``: :func:`quantize_shared_mesh` quantizes ``phi(x)`` of one fixed mesh
  per row, and :func:`rom_decode_int8` quantizes ``a(t)`` per snapshot and
  contracts int8 x int8 -> int32 with ``torch._int_mm``, then applies one
  float32 rescale and adds the bias.

The JAX package runs that contraction as a plain ``lax.dot_general``
outside any Pallas kernel, so ``torch._int_mm`` (cuBLASLt's int8 product
on the card) is its counterpart here. On CUDA ``torch._int_mm`` takes more
than 16 rows, inner and outer sizes that are multiples of 8 and a
column-major second operand; the decode zero-pads to those rules (zero rows
of ``q_a`` and zero columns of K add nothing to an integer sum, so the
padding is exact) and strips every pad from the result. It never falls back
to a float product.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.parameter_net import parameter_net_apply
from .pruning import _leaf, _tree_map

__all__ = [
    "quantize_params",
    "dequantize_params",
    "quantized_size_bytes",
    "quantize_shared_mesh",
    "rom_decode_int8",
]


def _quantizable(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.is_floating_point()


def quantize_params(params: Any, per_channel: bool = True) -> Any:
    """Quantize kernels to int8: each leaf of a params tree (a nested dict of
    tensors, or ``model.param_tree()``) becomes either the tensor itself
    (biases, integer tensors) or ``{"q": int8, "scale": f32}``, with
    ``p ~ q * scale``.

    ``per_channel=True`` (the default, tfmot's) gives each OUTPUT channel
    (last axis) its own symmetric scale ``max|p| / 127`` over the other
    axes; ``per_channel=False`` one scale per tensor. A zero scale becomes
    1, and ``round`` is half to even, as in the JAX package."""

    def q(p):
        if not _quantizable(p):
            return p
        if per_channel:
            scale = torch.amax(p.abs(), dim=tuple(range(p.dim() - 1)), keepdim=True) / 127.0
        else:
            scale = torch.amax(p.abs()) / 127.0
        scale = torch.where(scale == 0, 1.0, scale)
        return {"q": torch.clamp(torch.round(p / scale), -127, 127).to(torch.int8),
                "scale": scale.to(torch.float32)}

    return _tree_map(q, params)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def dequantize_params(qparams: Any, dtype=torch.float32) -> Any:
    """The float params tree of :func:`quantize_params`' output:
    ``q * scale`` in ``dtype``; other leaves as they are."""

    def dq(x):
        if _is_qleaf(x):
            return x["q"].to(dtype) * x["scale"].to(dtype)
        return x

    return _tree_map(dq, qparams, is_leaf=_is_qleaf)


def quantized_size_bytes(qparams: Any) -> Tuple[int, int]:
    """(quantized_bytes, float_equivalent_bytes) for compression reporting."""
    qbytes = 0
    fbytes = 0

    def visit(x):
        nonlocal qbytes, fbytes
        if _is_qleaf(x):
            qbytes += x["q"].numel() + 4 * x["scale"].numel()
            fbytes += x["q"].numel() * 4
        else:
            qbytes += x.numel() * x.element_size()
            fbytes += x.numel() * 4

    _tree_map(visit, qparams, is_leaf=_is_qleaf)
    return qbytes, fbytes


# ---------------------------------------------------------------------------
# Executed int8: the ROM decode as an int8 x int8 -> int32 product.
# ---------------------------------------------------------------------------
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm_operand(q_phi: torch.Tensor) -> torch.Tensor:
    """``q_phi [N, K]`` zero-padded to ``[round8(N), round8(K)]``: its
    transpose is ``torch._int_mm``'s column-major second operand. The same
    tensor where no pad is needed."""
    n, k = q_phi.shape
    pad_n, pad_k = _round_up(n, 8) - n, _round_up(k, 8) - k
    return F.pad(q_phi, (0, pad_k, 0, pad_n)) if pad_n or pad_k else q_phi


def _quantize_rows(rows: torch.Tensor):
    """Symmetric absmax int8 of each row of a float32 ``[n, K]``: ``(q
    int8, scale [n] f32)``, ``rows ~ q * scale[:, None]``, a zero scale
    replaced by 1."""
    scale = torch.amax(rows.abs(), dim=1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    return torch.clamp(torch.round(rows / scale[:, None]), -127, 127).to(torch.int8), scale


def quantize_shared_mesh(model, x) -> Dict[str, Any]:
    """Precompute the int8 decode pack for one fixed coordinate mesh ``x [P,
    si]`` of a NIF-linear ``model``.

    ``phi(x) [P, so, K]`` (the model's eager ``x_to_phi``, at its compute
    dtype, then float32) quantizes symmetrically per output channel: each
    ``(p, o)`` row of K latent coefficients gets its own scale, the row
    being what one int8 dot contracts. The pack holds the JAX package's
    keys, as tensors on the model's device: ``q_phi [P*so, K]`` int8,
    ``s_phi [P*so]`` f32, ``bias [so]`` f32 and ``shape (P, so, K)``; and
    the port's ``q_phi_padded``, ``q_phi`` zero-padded to multiples of 8 for
    ``torch._int_mm`` (``q_phi`` itself where no pad is needed).

    int32 accumulation is exact: ``|q_phi . q_a| <= 127 * 127 * K < 2^31``
    for K up to ~130k latent dims.
    """
    with torch.no_grad():
        phi = model.x_to_phi(x).to(torch.float32)  # [P, so, K]
        P, so, K = phi.shape
        q_phi, s_phi = _quantize_rows(phi.reshape(P * so, K))
        bias = model.snet.bias.detach().to(torch.float32).clone()
    return {"q_phi": q_phi, "s_phi": s_phi, "bias": bias, "shape": (P, so, K),
            "q_phi_padded": _mm_operand(q_phi)}


def _device_pack(model, pack: Dict[str, Any]) -> Dict[str, Any]:
    """``pack`` as tensors on the model's device, with ``q_phi_padded``
    (a pack from the JAX package, crossed as numpy arrays, has only the JAX
    keys). A pack of :func:`quantize_shared_mesh` on that device comes back
    as it is."""
    def on_device(v):
        return _leaf(v).to(model.device)

    out = {k: on_device(pack[k]) for k in ("s_phi", "bias")}
    padded = pack.get("q_phi_padded")
    out["q_phi_padded"] = (on_device(padded) if padded is not None
                           else _mm_operand(on_device(pack["q_phi"])))
    out["shape"] = tuple(int(d) for d in pack["shape"])
    return out


def _int8_product(q_a: torch.Tensor, q_phi_padded: torch.Tensor, n: int) -> torch.Tensor:
    """``q_a [G, K] @ q_phi[:n].T`` as int8 x int8 -> int32 through
    ``torch._int_mm``: ``q_a`` zero-padded to more than 16 rows and to the
    padded K, the pads stripped from the ``[G, n]`` result."""
    G, K = q_a.shape
    rows = max(G, 17)
    q_a = F.pad(q_a, (0, q_phi_padded.shape[1] - K, 0, rows - G))
    return torch._int_mm(q_a, q_phi_padded.t())[:G, :n]


def rom_decode_int8(model, pack: Dict[str, Any], t) -> torch.Tensor:
    """Decode snapshots ``t [G, pi]`` on the pre-quantized mesh ``pack``
    (:func:`quantize_shared_mesh`, or the JAX package's crossed as numpy
    arrays) -> ``u [G, P, so]`` float32.

    ``a(t)`` runs through the ParameterNet in float32 (the param dtype under
    the mixed policies, as the JAX package's) and quantizes per snapshot
    (symmetric absmax a row); the contraction runs int8 x int8 -> int32
    (:func:`_int8_product`) and one f32 rescale and the bias recover the
    field. An inference path: it records no autograd graph."""
    pack = _device_pack(model, pack)
    P, so, K = pack["shape"]
    with torch.no_grad():
        t = torch.as_tensor(t, device=model.device).to(torch.float32)
        a, _ = parameter_net_apply(model.pnet.params, t.to(model.policy.param_dtype),
                                   model.cfg_parameter_net, model.pnet_kind)  # [G, K]
        q_a, s_a = _quantize_rows(a.to(torch.float32))
        acc = _int8_product(q_a, pack["q_phi_padded"], P * so)  # [G, P*so] int32
        u = acc.to(torch.float32) * (s_a[:, None] * pack["s_phi"][None, :])
        return u.reshape(-1, P, so) + pack["bias"][None, None, :]
