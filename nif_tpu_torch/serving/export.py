"""Inference serving (counterpart of ``nif_tpu/serving/export.py``).

* ``predict``         — point-wise inference over any number of points, in
  fixed-size padded batches.
* ``predict_grouped`` — the fast serving path: routes through
  ``model.apply_grouped`` (the fused CUDA forward kernel on the card) with
  snapshot-batch chunking and exact point padding.
* ``predict_shared_mesh`` — ROM decode for NIF-linear: many snapshots onto
  one shared mesh, ``phi(x)`` evaluated once per chunk of snapshots, or with
  ``int8_pack=`` the int8 decode of ``compression``.
* ``export_apply``    — serialize one layout's serving function, parameters
  (and an int8 pack) baked in, with ``torch.export``.
* ``load_exported``   — reload an artifact and call it.

The ``predict*`` functions run under ``torch.inference_mode()``, take numpy
arrays (or anything ``np.asarray`` takes) and return numpy arrays in the
model's param dtype (float32 for the int8 decode).
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..compression.quantization import _device_pack, rom_decode_int8

__all__ = ["predict", "predict_grouped", "predict_shared_mesh", "export_apply", "load_exported"]


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

    ``int8_pack`` (from :func:`~nif_tpu_torch.compression.quantize_shared_mesh`):
    run the decode as an int8 x int8 -> int32 product instead
    (:func:`~nif_tpu_torch.compression.rom_decode_int8`), float32 out. The
    pack bakes ``phi(x)``, so ``x`` may be omitted; when both are given, the
    pack must have been built on a mesh of as many points."""
    if not hasattr(model, "apply_shared_mesh"):
        raise TypeError("predict_shared_mesh needs a model with apply_shared_mesh "
                        "(NIFMultiScaleLastLayerParameterized); use predict_grouped "
                        "for hypernetwork-generated ShapeNets")
    t = np.asarray(t, np.float32)
    G = t.shape[0]
    group_batch = min(group_batch, max(G, 1))
    if int8_pack is not None:
        P = int(int8_pack["shape"][0])
        if x is not None and np.asarray(x).shape[0] != P:
            raise ValueError(
                f"int8_pack was built for a {P}-point mesh but x has "
                f"{np.asarray(x).shape[0]} points: rebuild the pack with "
                f"quantize_shared_mesh(model, x)")
        pack = _device_pack(model, int8_pack)
        outs = []
        with torch.inference_mode():
            for s in range(0, G, group_batch):
                tc = t[s:s + group_batch]
                g = tc.shape[0]
                if g < group_batch:
                    tc, _ = _pad_axis(tc, 0, group_batch)
                outs.append(rom_decode_int8(model, pack, torch.from_numpy(tc))[:g].cpu().numpy())
        if outs:
            return np.concatenate(outs)
        return np.zeros((0, P, model.so_dim), np.float32)
    if x is None:
        raise ValueError("predict_shared_mesh needs x (or an int8_pack)")
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be [P, si] (one shared mesh), got {x.shape}")
    P = x.shape[0]
    xd = model.policy.cast_to_compute(_pad_axis(x, 0, point_pad)[0], device=model.device)
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


class _Serving(nn.Module):
    """One layout's serving function over ``model`` (a submodule, so its
    parameters are the exported program's) and the int8 pack's tensors (its
    buffers)."""

    def __init__(self, model, layout: str, int8_pack=None):
        super().__init__()
        self.model, self.layout = model, layout
        if int8_pack is not None:
            pack = _device_pack(model, int8_pack)
            self.shape = pack["shape"]
            for k in ("q_phi_padded", "s_phi", "bias"):
                self.register_buffer(k, pack[k])

    def forward(self, *inputs):
        m = self.model
        if self.layout == "pointwise":
            return m.apply(*inputs)
        if self.layout == "grouped":
            return m.apply_grouped(*inputs)
        if self.layout == "shared_mesh":
            return m.apply_shared_mesh(*inputs)
        pack = {"q_phi_padded": self.q_phi_padded, "s_phi": self.s_phi, "bias": self.bias,
                "shape": self.shape}
        return rom_decode_int8(m, pack, *inputs)


def export_apply(model, batch_size: int, path: Optional[str] = None, layout: str = "pointwise",
                 group_batch: int = 1, int8_pack=None) -> bytes:
    """Serialize the model's serving function, parameters baked in, with
    ``torch.export``: the bytes of ``torch.export.save`` (also written to
    ``path`` when given), which :func:`load_exported` runs without the
    model-building code. Shapes are static (float32 inputs); ``batch_size``
    fixes the point count, to pair with :func:`predict`-style padding.

    ``layout`` picks the signature:

    * ``"pointwise"``   — ``f(inputs [batch_size, pi+si]) -> [batch_size, so]``
    * ``"grouped"``     — ``f(t [group_batch, pi], x [group_batch,
      batch_size, si]) -> [group_batch, batch_size, so]`` via
      ``apply_grouped``: on the card one call of the registered op
      ``torch.ops.nif_tpu_torch.shapenet_fwd``, which launches K1
    * ``"shared_mesh"`` — ``f(t [group_batch, pi], x [batch_size, si])``
      via ``apply_shared_mesh`` (NIF-linear ROM decode)
    * ``"shared_mesh_int8"`` — ``f(t [group_batch, pi])`` with the int8 pack
      (``int8_pack=`` from
      :func:`~nif_tpu_torch.compression.quantize_shared_mesh`) baked in: the
      decode runs int8 x int8 -> int32 (``batch_size`` is ignored; the pack
      fixes the mesh)

    Two differences from the JAX package's StableHLO artifact: an artifact
    runs on the device of the model it came from (JAX's ``platforms=`` has
    no counterpart), and loading one that holds K1's op needs ``import
    nif_tpu_torch``, which registers the op (JAX's needs only JAX)."""
    dev = model.device
    if layout == "pointwise":
        args = (torch.zeros((batch_size, model.pi_dim + model.si_dim), device=dev),)
    elif layout == "grouped":
        args = (torch.zeros((group_batch, model.pi_dim), device=dev),
                torch.zeros((group_batch, batch_size, model.si_dim), device=dev))
    elif layout == "shared_mesh":
        if not hasattr(model, "apply_shared_mesh"):
            raise TypeError("layout='shared_mesh' needs apply_shared_mesh (NIF-linear)")
        args = (torch.zeros((group_batch, model.pi_dim), device=dev),
                torch.zeros((batch_size, model.si_dim), device=dev))
    elif layout == "shared_mesh_int8":
        if int8_pack is None:
            raise ValueError("layout='shared_mesh_int8' needs int8_pack= (build it with "
                             "nif_tpu_torch.compression.quantize_shared_mesh on the serving "
                             "mesh)")
        args = (torch.zeros((group_batch, model.pi_dim), device=dev),)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    with torch.no_grad():
        program = torch.export.export(_Serving(model, layout, int8_pack), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class _LoadedModel:
    """A loaded artifact: called on numpy arrays or tensors (cast to float32
    and moved to the artifact's device), it returns a tensor there."""

    def __init__(self, program):
        self.program = program
        self._call = program.module()
        names = set(program.graph_signature.user_inputs)
        self._inputs = [n.meta["val"] for n in program.graph.nodes
                        if n.op == "placeholder" and n.name in names]

    def __call__(self, *inputs) -> torch.Tensor:
        # 1 arg for the point-wise and int8 layouts, (t, x) for grouped/shared-mesh
        args = [torch.as_tensor(a, dtype=torch.float32, device=spec.device)
                for a, spec in zip(inputs, self._inputs)]
        with torch.inference_mode():
            return self._call(*args)

    @property
    def in_avals(self) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
        """``(shape, dtype)`` of each input."""
        return tuple((tuple(v.shape), v.dtype) for v in self._inputs)


def load_exported(path_or_bytes) -> _LoadedModel:
    """Reload an artifact of :func:`export_apply` (a path or its bytes)."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    else:
        blob = path_or_bytes
    return _LoadedModel(torch.export.load(io.BytesIO(blob)))
