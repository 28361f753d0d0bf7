"""Grouped-layout training (counterpart of ``nif_tpu/training/grouped.py``).

When the data is snapshot-structured — P coordinate points share each
(t, mu) — ``GroupedTrainer`` trains on the ``[G, P, ...]`` layout, where the
ShapeNet's forward, weighted MSE and backward run as one fused kernel on the
card (K2, through ``model.mse_value_and_grad``).

Batching: each step takes a batch of whole groups and a fresh random subset
of points within them, drawn from a numpy generator in the same calls and
order as the JAX package's loop, so one seed feeds both packages the same
batches.

Not ported yet, and refused with ``NotImplementedError``: Sobolev targets
(``target_jac``/``target_hess``, ROADMAP Slice D), residual point sampling
and the device-resident ``fit_resident`` loop (ROADMAP Slice A2), and
``mesh``/``shard_model_axis`` (ROADMAP Slice G).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .evaluation import global_sums, metrics_from_sums
from .trainer import TrainState, pad_batch, reg_row_weights

__all__ = ["GroupedTrainer"]


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to nif_tpu_torch yet (ROADMAP {where})")


def _refuse_targets(target_jac, target_hess) -> None:
    if target_jac is not None or target_hess is not None:
        raise _not_ported("Sobolev training (target_jac / target_hess)",
                          "Slice D: derivatives and Sobolev training")


class GroupedTrainer:
    """Trainer over the grouped layout (t: [G, pi], x: [G, P, si], u: [G, P, so]).

    Usage::

        trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-3))
        state = trainer.init(0)
        state = trainer.fit(state, t, x, u, epochs=100,
                            group_batch=16, point_batch=4096)

    ``optimizer`` is a factory, ``parameters -> torch.optim.Optimizer`` (the
    counterpart of an optax transformation), so :meth:`init` can draw fresh
    parameters and build a fresh optimizer over them. ``fused=None`` (auto)
    takes the fused train kernel where ``model.fast_path_info`` says so.
    """

    def __init__(self, model, optimizer: Callable, mesh=None, use_reg: bool = True,
                 seed: int = 0, fused: Optional[bool] = None,
                 shard_model_axis: bool = False):
        if mesh is not None or shard_model_axis:
            raise _not_ported("GroupedTrainer over a mesh (mesh / shard_model_axis)",
                              "Slice G: multi-GPU")
        self.model = model
        self.make_optimizer = optimizer
        self.use_reg = use_reg
        self.fused = fused
        self._rng = np.random.default_rng(seed)
        self.history: Dict[str, List] = {"epoch": [], "loss": []}

    def init(self, seed: int = 0) -> TrainState:
        """Redraw the model's parameters from ``seed`` and build the
        optimizer over them: step 0."""
        self.model.init(seed)
        optimizer = self.make_optimizer([p for _, p in self.model.param_items()])
        return TrainState(self.model.pnet.params, optimizer, 0)

    def _record_path(self, P: int) -> None:
        """Record once which path P-point group batches take
        (``history["path"]``, and ``history["path_reason"]`` for an eager
        fallback), and let the model log its one-time path message."""
        if "path" in self.history:
            return
        info = self.model.fast_path_info(P)
        self.model._announce_path(P)
        self.history["path"] = info["path"]
        if info["reason"]:
            self.history["path_reason"] = info["reason"]

    def step(self, state: TrainState, t, x, u, w=None, rw=None,
             target_jac=None, target_hess=None):
        """One training step on a ``(t, x, u[, w])`` group batch (arrays or
        tensors; tensors already on the model's device are used as they
        are). ``w [Gb, Pb]`` weights the points, ``rw [Gb]`` the rows of the
        batch-mean regularization terms. Returns ``(state, loss)`` with the
        loss as a 0-dim device tensor: no host sync."""
        _refuse_targets(target_jac, target_hess)
        self._record_path(x.shape[1])
        loss, grads = self.model.mse_value_and_grad(
            t, x, u, weight=w, fused=self.fused, use_reg=self.use_reg, reg_weight=rw)
        for path, p in self.model.param_items():
            g = grads
            for key in path:
                g = g[key]
            p.grad = g
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    def fit(
        self,
        state: TrainState,
        t: np.ndarray,
        x: np.ndarray,
        u: np.ndarray,
        sample_weight: Optional[np.ndarray] = None,
        target_jac: Optional[np.ndarray] = None,
        target_hess: Optional[np.ndarray] = None,
        epochs: int = 1,
        group_batch: Optional[int] = None,
        point_batch: Optional[int] = None,
        callbacks: Sequence = (),
        verbose_every: int = 0,
        point_sampling: str = "uniform",
        validation_data=None,
        validation_every: int = 1,
    ) -> TrainState:
        """Train for ``epochs`` passes over the groups. Each epoch permutes
        the groups and takes ``group_batch`` of them per step with
        ``point_batch`` points drawn without replacement; a short tail batch
        (or any batch, when ``sample_weight [G, P]`` is given) is padded with
        zero-weight filler groups (:func:`pad_batch`) so every step has one
        shape and the loss and gradient stay the exact means. The epoch loss
        is the group-weighted mean of the step losses, read from the device
        once per epoch."""
        _refuse_targets(target_jac, target_hess)
        if point_sampling == "residual":
            raise _not_ported("point_sampling='residual'", "Slice A2, after the step")
        if point_sampling != "uniform":
            raise ValueError(f"unknown point_sampling {point_sampling!r}")
        t, x, u = np.asarray(t), np.asarray(x), np.asarray(u)
        G, P = x.shape[0], x.shape[1]
        group_batch = min(group_batch or G, G)
        point_batch = min(point_batch or P, P)
        needs_pad = (G % group_batch != 0) or sample_weight is not None
        self._record_path(point_batch)

        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            g_order = self._rng.permutation(G)
            losses, sizes = [], []
            for s in range(0, G, group_batch):
                gsel = g_order[s: s + group_batch]
                b = len(gsel)
                psel = self._rng.choice(P, size=point_batch, replace=False)
                w = None if sample_weight is None else sample_weight[gsel][:, psel]
                bt, bx, bu = t[gsel], x[gsel][:, psel], u[gsel][:, psel]
                rw = None
                if needs_pad:
                    (bt, bx, bu), w_rows = pad_batch((bt, bx, bu), None, b, group_batch)
                    w_full = (
                        np.broadcast_to(w_rows[:, None], (group_batch, point_batch))
                        if w is None
                        else np.concatenate(
                            [w, np.zeros((group_batch - b, point_batch), w.dtype)]
                        ) * w_rows[:, None]
                    )
                    w = np.ascontiguousarray(w_full, dtype=np.float32)
                    if self.use_reg:
                        rw = reg_row_weights(b, group_batch)
                state, loss = self.step(state, *self._put(bt, bx, bu, w, rw))
                losses.append(loss)
                sizes.append(b)
            epoch_loss = (
                float(np.average(torch.stack(losses).double().cpu().numpy(), weights=sizes))
                if losses else float("nan")
            )
            self.history["epoch"].append(epoch)
            self.history["loss"].append(epoch_loss)
            logs = {"loss": epoch_loss, "epoch": epoch, "time": time.perf_counter() - t0}
            if validation_data is not None and epoch % validation_every == 0:
                vt, vx, vu = validation_data
                logs["val_loss"] = self.evaluate(state, vt, vx, vu)
                self.history.setdefault("val_loss", []).append(logs["val_loss"])
                self.history.setdefault("val_epoch", []).append(epoch)
            if verbose_every and epoch % verbose_every == 0:
                print(f"epoch {epoch:5d}  loss {epoch_loss:.6e}  ({logs['time']:.3f}s)")
            for cb in callbacks:
                cb.on_epoch_end(self, state, epoch, logs)
        for cb in callbacks:
            cb.on_train_end(self, state)
        return state

    def fit_resident(self, *args, **kwargs):
        raise _not_ported("GroupedTrainer.fit_resident (the device-resident loop)",
                          "Slice A2, after the step")

    def _put(self, *arrays):
        """Host arrays to the model's device (None passes through)."""
        return tuple(None if a is None else torch.as_tensor(a, device=self.model.device)
                     for a in arrays)

    def _eval_sums(self, state: TrainState, t, x, u, sample_weight=None,
                   group_batch: Optional[int] = None):
        """LOCAL ``(sse, sst, n_el)`` over the grouped dataset, in chunks of
        ``group_batch`` groups (default: about 4M points per chunk), through
        ``apply_grouped`` (K1 on the card) under ``torch.inference_mode``."""
        t, x, u = np.asarray(t), np.asarray(x), np.asarray(u)
        G, P = x.shape[0], x.shape[1]
        gb = min(group_batch or max(1, 4_000_000 // max(P, 1)), G)
        sse = sst = 0.0
        with torch.inference_mode():
            for s in range(0, G, gb):
                sl = slice(s, min(s + gb, G))
                bt, bx, bu = self._put(t[sl], x[sl], u[sl])
                pred = self.model.apply_grouped(bt, bx)
                uc = bu.to(pred.dtype)
                err = torch.square(pred - uc)
                if sample_weight is not None:
                    w = torch.as_tensor(np.asarray(sample_weight[sl], np.float32),
                                        device=pred.device)
                    err = err * w.unsqueeze(-1).to(pred.dtype)
                sse += float(torch.sum(err.to(torch.float32)))
                sst += float(torch.sum(torch.square(uc).to(torch.float32)))
        return sse, sst, float(G * P * u.shape[-1])

    def evaluate(self, state: TrainState, t, x, u, sample_weight=None,
                 group_batch: Optional[int] = None) -> float:
        """Mean (weighted) MSE over the full grouped dataset."""
        sse, _sst, n_el = self._eval_sums(state, t, x, u, sample_weight, group_batch)
        sse, n_el = global_sums(sse, n_el)
        return sse / max(n_el, 1.0)

    def evaluate_metrics(self, state: TrainState, t, x, u, sample_weight=None,
                         group_batch: Optional[int] = None) -> Dict[str, float]:
        """``{"mse", "rel_l2"}`` over the full grouped dataset."""
        sse, sst, n_el = self._eval_sums(state, t, x, u, sample_weight, group_batch)
        sse, sst, n_el = global_sums(sse, sst, n_el)
        return metrics_from_sums(sse, sst, n_el)
