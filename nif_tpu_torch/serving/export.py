"""Inference serving (counterpart of ``nif_tpu/serving/export.py``).

* ``predict``         — point-wise inference over any number of points, in
  fixed-size padded batches.
* ``predict_grouped`` — the fast serving path: routes through
  ``model.apply_grouped`` (the fused CUDA forward kernel on the card) with
  snapshot-batch chunking and exact point padding.
* ``predict_shared_mesh`` — ROM decode for NIF-linear: many snapshots onto
  one shared mesh, ``phi(x)`` evaluated once per chunk of snapshots.

Both run under ``torch.inference_mode()``, take numpy arrays (or anything
``np.asarray`` takes) and return numpy arrays in the model's param dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["predict", "predict_grouped", "predict_shared_mesh"]


def _pad_axis(a: np.ndarray, axis: int, multiple: int):
    """Pad ``axis`` up to a multiple with copies of the last slice."""
    n = a.shape[axis]
    pad = (-n) % multiple
    if not pad:
        return a, n
    last = np.take(a, [-1], axis=axis)
    reps = [1] * a.ndim
    reps[axis] = pad
    return np.concatenate([a, np.tile(last, reps)], axis=axis), n


def _param_np_dtype(model) -> np.dtype:
    return torch.empty((), dtype=model.policy.param_dtype).numpy().dtype


def predict(model, inputs: np.ndarray, batch_size: int = 65536) -> np.ndarray:
    """Run point-wise inference over any number of points, in batches of
    ``batch_size`` rows (the last one padded with copies of its last row)."""
    inputs = np.asarray(inputs)
    n = inputs.shape[0]
    batch_size = min(batch_size, max(n, 1))
    outs = []
    with torch.inference_mode():
        for s in range(0, n, batch_size):
            chunk = inputs[s: s + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[-1:], (pad,) + chunk.shape[1:])]
                )
            out = model.apply(chunk).cpu().numpy()
            outs.append(out[: batch_size - pad])
    if outs:
        return np.concatenate(outs)
    # Empty input keeps the (0, so_dim) shape/dtype every non-empty call
    # returns, so callers never need an empty-shard special case.
    return np.zeros((0, model.so_dim), _param_np_dtype(model))


def predict_grouped(
    model,
    t: np.ndarray,
    x: np.ndarray,
    group_batch: int = 32,
    point_pad: int = 256,
) -> np.ndarray:
    """Grouped-layout inference: ``t [G, p]``, ``x [G, P, si]`` ->
    ``u [G, P, so]`` through the fused forward kernel.

    ``P`` pads to a multiple of ``point_pad`` with copies of the last point,
    and ``G`` runs in chunks of ``group_batch`` snapshots, the last chunk
    padded with copies of its last snapshot. Pads are stripped from the
    result. Each chunk is one ``apply_grouped`` call (one kernel launch).
    """
    t = np.asarray(t, np.float32)
    x = np.asarray(x, np.float32)
    G, P = x.shape[0], x.shape[1]
    if t.shape[0] != G:
        raise ValueError(f"t has {t.shape[0]} groups but x has {G}")
    xp, _ = _pad_axis(x, 1, point_pad)
    group_batch = min(group_batch, max(G, 1))
    outs = []
    with torch.inference_mode():
        for s in range(0, G, group_batch):
            tc, xc = t[s:s + group_batch], xp[s:s + group_batch]
            g = tc.shape[0]
            if g < group_batch:
                tc, _ = _pad_axis(tc, 0, group_batch)
                xc, _ = _pad_axis(xc, 0, group_batch)
            out = model.apply_grouped(torch.from_numpy(tc), torch.from_numpy(xc))
            outs.append(out[:g, :P].cpu().numpy())
    if outs:
        return np.concatenate(outs)
    return np.zeros((0, P, model.so_dim), _param_np_dtype(model))


def predict_shared_mesh(model, t: np.ndarray, x: np.ndarray = None, group_batch: int = 256,
                        point_pad: int = 256, int8_pack=None) -> np.ndarray:
    """ROM-decode serving: many parameter snapshots ``t [G, p]`` onto ONE
    shared coordinate mesh ``x [P, si]`` -> ``u [G, P, so]``.

    NIF-linear only (``model.apply_shared_mesh``): ``phi(x)`` is evaluated
    once per chunk of ``group_batch`` snapshots and the reconstruction is one
    product. ``P`` pads to a multiple of ``point_pad`` and the last chunk of
    snapshots with copies of its last row; the pads are stripped.
    ``int8_pack`` (the JAX package's int8 decode) is not ported yet."""
    if int8_pack is not None:
        raise NotImplementedError("predict_shared_mesh(int8_pack=...) is not ported to "
                                  "nif_tpu_torch yet (ROADMAP Slice F: compression)")
    if not hasattr(model, "apply_shared_mesh"):
        raise TypeError("predict_shared_mesh needs a model with apply_shared_mesh "
                        "(NIFMultiScaleLastLayerParameterized); use predict_grouped "
                        "for hypernetwork-generated ShapeNets")
    if x is None:
        raise ValueError("predict_shared_mesh needs x")
    t = np.asarray(t, np.float32)
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be [P, si] (one shared mesh), got {x.shape}")
    G, P = t.shape[0], x.shape[0]
    xd = model.policy.cast_to_compute(_pad_axis(x, 0, point_pad)[0], device=model.device)
    group_batch = min(group_batch, max(G, 1))
    outs = []
    with torch.inference_mode():
        for s in range(0, G, group_batch):
            tc = t[s:s + group_batch]
            g = tc.shape[0]
            if g < group_batch:
                tc, _ = _pad_axis(tc, 0, group_batch)
            out = model.apply_shared_mesh(torch.from_numpy(tc), xd)
            outs.append(out[:g, :P].cpu().numpy())
    if outs:
        return np.concatenate(outs)
    return np.zeros((0, P, model.so_dim), _param_np_dtype(model))
