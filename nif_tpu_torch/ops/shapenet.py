"""ShapeNet evaluation, eager path (counterpart of ``nif_tpu/ops/shapenet.py``).

The ShapeNet is an MLP whose weights are *data*, generated per sample by the
ParameterNet. Two layouts:

* **point-wise** — ``x: [B, si]``, ``wb: [B, po]``: every point carries its
  own generated weight vector; each layer is a per-sample matvec.
* **grouped** — ``x: [G, P, si]``, ``wb: [G, po]``: P points share one
  generated weight set, so each layer is a batched matmul.

The flattened weight-vector layout is the reference's slicing order:
[W_first | W_hidden... | W_last | b_first | b_hidden... | b_last].

Dtype rules follow the JAX path: every matmul returns the compute dtype
(for bf16, a bf16 product of an f32-accumulated sum), omega_0 is cast to the
compute dtype, and the sine is exact. This path is the kernels' fallback for
configs they cannot take and the f64 path.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..config import ShapeNetConfig, shapenet_param_count
from ..layers.mlp import get_activation
from ..layers.siren import omega_in

__all__ = [
    "unpack_shapenet_weights",
    "shapenet_pointwise",
    "shapenet_grouped",
]


def unpack_shapenet_weights(wb: torch.Tensor, cfg: ShapeNetConfig) -> Dict[str, Any]:
    """Slice the flattened weight+bias vector into per-layer tensors.

    ``wb`` has shape ``[*batch, po_dim]``; returned tensors keep the leading
    batch dims (as views of ``wb``).
    """
    si, so, n, l = cfg.input_dim, cfg.output_dim, cfg.units, cfg.nlayers
    batch = wb.shape[:-1]
    n_hidden_mats = 2 * l if cfg.use_resblock else l

    expected = shapenet_param_count(cfg, latent_dim=0)
    if cfg.connectivity != "full":
        raise ValueError("unpack_shapenet_weights requires connectivity='full'")
    if wb.shape[-1] != expected:
        raise ValueError(
            f"weight vector has {wb.shape[-1]} entries, expected {expected} "
            f"for cfg {cfg}"
        )

    # one split (its backward is one concatenation, where slices would each
    # scatter into a zero-filled [*batch, po] gradient)
    sizes = ([si * n] + [n * n] * n_hidden_mats + [n * so] + [n] * (1 + n_hidden_mats) + [so])
    segs = list(torch.split(wb, sizes, dim=-1))
    w_first = segs.pop(0).reshape(*batch, si, n)
    w_hidden: List[torch.Tensor] = [
        segs.pop(0).reshape(*batch, n, n) for _ in range(n_hidden_mats)
    ]
    w_last = segs.pop(0).reshape(*batch, n, so)
    b_first = segs.pop(0)
    b_hidden: List[torch.Tensor] = [segs.pop(0) for _ in range(n_hidden_mats)]
    b_last = segs.pop(0)
    return {
        "w_first": w_first,
        "w_hidden": w_hidden,
        "w_last": w_last,
        "b_first": b_first,
        "b_hidden": b_hidden,
        "b_last": b_last,
    }


def _matvec_pointwise(u, w):
    # [B, i] x [B, i, j] -> [B, j]: per-sample matvec.
    return torch.bmm(u.unsqueeze(1), w.to(u.dtype)).squeeze(1)


def _matvec_grouped(u, w):
    # [G, P, i] x [G, i, j] -> [G, P, j]: batched matmul in u's dtype.
    return torch.bmm(u, w.to(u.dtype))


def _bias_pointwise(b):
    return b


def _bias_grouped(b):
    return b.unsqueeze(-2)


def _shapenet_chain(x, parts, cfg: ShapeNetConfig, matvec, liftb, variant: str):
    """Run the layer chain, shared by the point-wise and grouped layouts.

    ``variant``: 'siren' (the NIFMultiScale chain, sine activations scaled by
    omega_0, optional resblocks) or 'vanilla' (the plain NIF chain,
    cfg.activation with additive shortcuts on hidden layers).
    """
    if variant == "siren":
        om = omega_in(x.dtype, cfg.omega_0)
        u = torch.sin(om * matvec(x, parts["w_first"]) + liftb(parts["b_first"]))
        if cfg.use_resblock:
            for i in range(cfg.nlayers):
                w1, w2 = parts["w_hidden"][2 * i], parts["w_hidden"][2 * i + 1]
                b1, b2 = parts["b_hidden"][2 * i], parts["b_hidden"][2 * i + 1]
                h = torch.sin(om * matvec(u, w1) + liftb(b1))
                u = 0.5 * (u + torch.sin(om * matvec(h, w2) + liftb(b2)))
        else:
            for i in range(cfg.nlayers):
                u = torch.sin(
                    om * matvec(u, parts["w_hidden"][i]) + liftb(parts["b_hidden"][i])
                )
    elif variant == "vanilla":
        act = get_activation(cfg.activation)
        u = act(matvec(x, parts["w_first"]) + liftb(parts["b_first"]))
        for i in range(cfg.nlayers):
            u = act(matvec(u, parts["w_hidden"][i]) + liftb(parts["b_hidden"][i])) + u
    else:
        raise ValueError(f"unknown shapenet variant {variant!r}")
    return matvec(u, parts["w_last"]) + liftb(parts["b_last"])


def shapenet_pointwise(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                       variant: str = "vanilla"):
    """Evaluate the ShapeNet point-wise: ``wb [B, po]``, ``x [B, si]`` ->
    ``[B, so]``."""
    parts = unpack_shapenet_weights(wb, cfg)
    return _shapenet_chain(x, parts, cfg, _matvec_pointwise, _bias_pointwise, variant)


def shapenet_grouped(wb: torch.Tensor, x: torch.Tensor, cfg: ShapeNetConfig,
                     variant: str = "vanilla"):
    """Evaluate the ShapeNet with shared weights per group: ``wb [G, po]``,
    ``x [G, P, si]`` -> ``[G, P, so]``."""
    parts = unpack_shapenet_weights(wb, cfg)
    return _shapenet_chain(x, parts, cfg, _matvec_grouped, _bias_grouped, variant)
