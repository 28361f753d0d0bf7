"""Grouped-layout training (counterpart of ``nif_tpu/training/grouped.py``).

When the data is snapshot-structured — P coordinate points share each
(t, mu) — ``GroupedTrainer`` trains on the ``[G, P, ...]`` layout, where the
ShapeNet's forward, weighted MSE and backward run as one fused kernel on the
card (K2, through ``model.mse_value_and_grad``).

Batching: each step takes a batch of whole groups and a fresh random subset
of points within them, drawn from a numpy generator in the same calls and
order as the JAX package's loop, so one seed feeds both packages the same
batches.

Sobolev training: ``target_jac [G, P, so, si]`` switches a step to
``w_value * value_mse + w_jac * jacobian_mse`` through
``model.sobolev_value_and_grad`` (one K6 launch per step on the card), and
``evaluate_sobolev`` evaluates both terms through K5. ``target_hess [G, P,
so, si, si]`` adds ``w_hess * hessian_mse`` (one K8 launch per step on the
card), and ``evaluate_sobolev(..., target_hess=...)`` evaluates the three
terms through K7.

Residual point sampling (``fit(point_sampling="residual")``) draws each
group's points in proportion to the current squared residual, scored through
``apply_grouped`` (K1 on the card) every ``resample_every`` epochs.

``fit_resident`` stages the dataset on the device once and draws every
batch there (``training/resident.py``); on the card its steps replay as a
captured CUDA graph, the port's counterpart of the JAX package's scanned
chunks.

Not ported yet, and refused with ``NotImplementedError``:
``mesh``/``shard_model_axis`` (ROADMAP Slice G).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .evaluation import global_sums, metrics_from_sums
from .resident import ResidentData, ResidentLoop
from .trainer import (TrainState, _not_ported, pad_batch, reg_row_weights,
                      restore_or_init_state)

__all__ = ["GroupedTrainer"]


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
    takes the fused train kernels where ``model.fast_path_info`` (MSE) or
    ``model.sobolev_path_info`` (Sobolev) says so. ``w_value``, ``w_jac``
    and ``w_hess`` weigh the Sobolev terms when a step gets ``target_jac``
    (or ``target_hess``).
    """

    def __init__(self, model, optimizer: Callable, mesh=None, use_reg: bool = True,
                 seed: int = 0, fused: Optional[bool] = None,
                 shard_model_axis: bool = False, w_value: float = 1.0,
                 w_jac: float = 1.0, w_hess: float = 1.0):
        if mesh is not None or shard_model_axis:
            raise _not_ported("GroupedTrainer over a mesh (mesh / shard_model_axis)",
                              "Slice G: multi-GPU")
        self.model = model
        self.make_optimizer = optimizer
        self.use_reg = use_reg
        self.fused = fused
        self.w_value, self.w_jac, self.w_hess = w_value, w_jac, w_hess
        self._rng = np.random.default_rng(seed)
        self.history: Dict[str, List] = {"epoch": [], "loss": []}

    def init(self, seed: int = 0) -> TrainState:
        """Redraw the model's parameters from ``seed`` and build the
        optimizer over them: step 0."""
        self.model.init(seed)
        optimizer = self.make_optimizer([p for _, p in self.model.param_items()])
        return TrainState(self.model.param_tree(), optimizer, 0)

    def init_or_restore(self, seed, ckpt_dir: str) -> TrainState:
        """Resumable init (same semantics as ``Trainer.init_or_restore``)."""
        return restore_or_init_state(self, seed, ckpt_dir)

    def _record_path(self, P: int, si: Optional[int] = None, sobolev: bool = False,
                     hess: bool = False) -> None:
        """Record once per mode which path P-point group batches take
        (``history["path"]`` for MSE steps, ``history["sobolev_path"]`` for
        every step with Jacobian or Hessian targets, as the JAX package keys
        them; ``hess`` only picks the gate that answers; each with a
        ``..._reason`` for an eager fallback), and let the model log its
        one-time path message. The first record of a mode stands."""
        key = "sobolev_path" if sobolev else "path"
        if key in self.history:
            return
        if sobolev:
            info = self.model.sobolev_path_info(P, si, hess=hess)
            self.model._announce_sobolev_path(P, si, hess=hess)
        else:
            info = self.model.fast_path_info(P)
            self.model._announce_path(P)
        self.history[key] = info["path"]
        if info["reason"]:
            self.history[key + "_reason"] = info["reason"]

    def step(self, state: TrainState, t, x, u, w=None, rw=None,
             target_jac=None, target_hess=None):
        """One training step on a ``(t, x, u[, w])`` group batch (arrays or
        tensors; tensors already on the model's device are used as they
        are). ``w [Gb, Pb]`` weights the points, ``rw [Gb]`` the rows of the
        batch-mean regularization terms; ``target_jac [Gb, Pb, so, si]``
        (and/or ``target_hess [Gb, Pb, so, si, si]``) switches the step to the
        Sobolev loss. Returns ``(state, loss)``
        with the loss as a 0-dim device tensor: no host sync."""
        sobolev = target_jac is not None or target_hess is not None
        self._record_path(x.shape[1], x.shape[2], sobolev, hess=target_hess is not None)
        loss = self._grads(t, x, u, w, rw, target_jac, target_hess)
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    def _grads(self, t, x, u, w=None, rw=None, target_jac=None, target_hess=None):
        """The loss of one batch, with its gradient left in each parameter's
        ``.grad``: the step before the optimizer's update, with no host sync
        (``fit_resident`` captures it in a CUDA graph on the card)."""
        if target_jac is not None or target_hess is not None:
            loss, _terms, grads = self.model.sobolev_value_and_grad(
                t, x, u, target_jac=target_jac, target_hess=target_hess,
                w_value=self.w_value, w_jac=self.w_jac, w_hess=self.w_hess, weight=w,
                fused=self.fused, use_reg=self.use_reg, reg_weight=rw)
        else:
            loss, grads = self.model.mse_value_and_grad(
                t, x, u, weight=w, fused=self.fused, use_reg=self.use_reg, reg_weight=rw)
        for path, p in self.model.param_items():
            g = grads
            for key in path:
                g = g[key]
            p.grad = g
        return loss

    def _residual_probs(self, state: TrainState, t, x, u, alpha: float,
                        mix: float) -> np.ndarray:
        """Per-point sampling distribution proportional to the current
        squared residual (mixed with uniform for coverage): ``[G, P]``
        float64. Evaluated in group chunks of about 4M points through
        ``apply_grouped`` (one K1 launch per chunk on the card) under
        ``torch.inference_mode``, so a refresh never needs more device
        memory than a training step. ``t, x, u`` are arrays or tensors (a
        resident dataset stays where it is)."""
        G, P = x.shape[0], x.shape[1]
        chunk = max(1, 4_000_000 // max(P, 1))
        r = np.empty((G, P), np.float64)
        with torch.inference_mode():
            for s in range(0, G, chunk):
                sl = slice(s, min(s + chunk, G))
                bt, bx, bu = self._put(t[sl], x[sl], u[sl])
                pred = self.model.apply_grouped(bt, bx)
                r[sl] = torch.mean(torch.square(pred - bu.to(pred.dtype)),
                                   dim=-1).double().cpu().numpy()
        r = np.maximum(r, 0.0) ** alpha
        rs = r.sum(axis=1, keepdims=True)
        prop = np.where(rs > 0, r / np.maximum(rs, 1e-300), 1.0 / P)
        return mix / P + (1.0 - mix) * prop

    def residual_probs(self, state: TrainState, t, x, u, alpha: float = 1.0,
                       mix: float = 0.5) -> np.ndarray:
        """The residual sampling distribution ``[G, P]`` of
        ``fit(point_sampling="residual")``: ``mix / P`` plus ``1 - mix``
        times each group's squared residual to the power ``alpha``,
        normalized over its points. Sampling by it optimizes a
        residual-reweighted objective; evaluate final metrics on the full
        set."""
        return self._residual_probs(state, np.asarray(t), np.asarray(x), np.asarray(u),
                                    alpha, mix)

    @staticmethod
    def _gumbel_topk(probs: np.ndarray, k: int, rng) -> np.ndarray:
        """Vectorized without-replacement sampling: per-row top-k of
        log p + Gumbel noise (one Gumbel-max draw per kept point)."""
        g = rng.gumbel(size=probs.shape)
        keys = np.log(np.maximum(probs, 1e-300)) + g
        return np.argpartition(-keys, k - 1, axis=1)[:, :k]

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
        resample_every: int = 10,
        residual_alpha: float = 1.0,
        residual_mix: float = 0.5,
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
        once per epoch. ``target_jac [G, P, so, si]`` switches every step to
        the Sobolev loss, and ``target_hess [G, P, so, si, si]`` adds the
        Hessian term (their batches drawn with no extra generator calls, as
        in the JAX loop).

        ``point_sampling="residual"`` draws each group's points without
        replacement in proportion to :meth:`residual_probs` (``residual_alpha``,
        ``residual_mix``), refreshed every ``resample_every`` epochs before
        the epoch's permutation: hard-point mining for localized features,
        which optimizes a residual-reweighted objective (evaluate final
        metrics on the full set). The distribution stays value-MSE based
        under Sobolev targets."""
        if point_sampling not in ("uniform", "residual"):
            raise ValueError(f"unknown point_sampling {point_sampling!r}")
        t, x, u = np.asarray(t), np.asarray(x), np.asarray(u)
        target_jac = None if target_jac is None else np.asarray(target_jac)
        target_hess = None if target_hess is None else np.asarray(target_hess)
        G, P = x.shape[0], x.shape[1]
        group_batch = min(group_batch or G, G)
        point_batch = min(point_batch or P, P)
        needs_pad = (G % group_batch != 0) or sample_weight is not None
        self._record_path(point_batch, x.shape[2],
                          target_jac is not None or target_hess is not None,
                          hess=target_hess is not None)

        for cb in callbacks:
            cb.on_train_begin(self)
        probs = None
        for epoch in range(epochs):
            t0 = time.perf_counter()
            if point_sampling == "residual" and epoch % resample_every == 0:
                probs = self._residual_probs(state, t, x, u, residual_alpha, residual_mix)
            g_order = self._rng.permutation(G)
            losses, sizes = [], []
            for s in range(0, G, group_batch):
                gsel = g_order[s: s + group_batch]
                b = len(gsel)
                if probs is None:
                    psel = self._rng.choice(P, size=point_batch, replace=False)
                    w = None if sample_weight is None else sample_weight[gsel][:, psel]
                    bt, bx, bu = t[gsel], x[gsel][:, psel], u[gsel][:, psel]
                    bju = None if target_jac is None else target_jac[gsel][:, psel]
                    bhu = None if target_hess is None else target_hess[gsel][:, psel]
                else:
                    # each group's own hard-point subsample: [b, point_batch]
                    psel = self._gumbel_topk(probs[gsel], point_batch, self._rng)
                    rows = gsel[:, None]
                    w = None if sample_weight is None else sample_weight[rows, psel]
                    bt, bx, bu = t[gsel], x[rows, psel], u[rows, psel]
                    bju = None if target_jac is None else target_jac[rows, psel]
                    bhu = None if target_hess is None else target_hess[rows, psel]
                rw = None
                if needs_pad:
                    opts = tuple(a for a in (bju, bhu) if a is not None)
                    arrs, w_rows = pad_batch((bt, bx, bu) + opts, None, b, group_batch)
                    bt, bx, bu = arrs[:3]
                    rest = iter(arrs[3:])
                    bju = None if bju is None else next(rest)
                    bhu = None if bhu is None else next(rest)
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
                state, loss = self.step(state, *self._put(bt, bx, bu, w, rw, bju, bhu))
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

    def fit_resident(
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
        seed: Optional[int] = None,
        validation_data=None,
        validation_every: int = 1,
        point_sampling: str = "uniform",
        resample_every: int = 10,
        residual_alpha: float = 1.0,
        residual_mix: float = 0.5,
    ) -> TrainState:
        """Device-resident training: stage the whole grouped dataset on the
        model's device once and draw every batch there (no per-step host
        traffic). An epoch is ``max(G // group_batch, 1)`` steps; each takes
        ``group_batch`` groups without replacement (a prefix of a fresh
        permutation) and ``point_batch`` points per group i.i.d. with
        replacement (an unbiased SGD subsample), ``sample_weight``,
        ``target_jac`` and ``target_hess`` gathered alongside; a full
        ``group_batch`` takes the groups in order, a full ``point_batch``
        under uniform sampling every point in order. The batches of step i
        depend only on ``seed`` and i (``seed=None`` draws one from the
        trainer's generator, as the JAX loop does).

        ``point_sampling="residual"`` draws the points from each group's
        :meth:`residual_probs` (``residual_alpha``, ``residual_mix``),
        refreshed every ``resample_every`` epochs through K1, by inverse CDF
        on the device. Like ``fit``'s variant it optimizes a
        residual-reweighted objective.

        Steps run in chunks that end where the host has work: on every
        epoch when there are callbacks, on validation epochs, before a
        residual refresh, and at least every 4096 steps; the losses of a
        chunk are read back once. On the card the steps replay as a CUDA
        graph (``training/resident.py``); ``history["resident_graph"]``
        says which form ran and ``["resident_graph_reason"]`` why (the whole
        step for an Adam or AdamW with ``capturable=True``, else
        ``opt.step()`` after each replay), ``["resident_capture_ms"]`` the
        host time of each capture and ``["resident_step_ms"]`` the device
        time per replayed step of each chunk."""
        t, x, u = np.asarray(t), np.asarray(x), np.asarray(u)
        G, P = x.shape[0], x.shape[1]
        group_batch = min(group_batch or G, G)
        point_batch = min(point_batch or P, P)
        if point_sampling not in ("uniform", "residual"):
            raise ValueError(f"unknown point_sampling {point_sampling!r}")
        residual = point_sampling == "residual"
        self._record_path(point_batch, x.shape[2],
                          target_jac is not None or target_hess is not None,
                          hess=target_hess is not None)
        steps_per_epoch = max(G // group_batch, 1)

        # Chunk boundaries align with every host-side obligation: callbacks
        # need end-of-epoch state (chunk = 1 epoch), validation needs state
        # at its cadence, a residual refresh needs state every
        # resample_every epochs, and the cap bounds each loss readback.
        chunk_cap = max(1, min(epochs, -(-4096 // steps_per_epoch)))
        if callbacks:
            chunk_cap = 1
        if residual:
            chunk_cap = min(chunk_cap, max(1, resample_every))

        base = self._rng.integers(2**63) if seed is None else seed
        data = ResidentData(t, x, u, sample_weight, target_jac, target_hess,
                            group_batch=group_batch, point_batch=point_batch, seed=base,
                            residual=residual, device=self.model.device)
        loop = ResidentLoop(self, state.opt_state, data, max(epochs, 0) * steps_per_epoch)
        self.history["resident_graph"] = loop.form
        self.history["resident_graph_reason"] = loop.reason
        for cb in callbacks:
            cb.on_train_begin(self)
        step_i = 0
        epoch = 0
        refreshed = False
        try:
            while epoch < epochs:
                n_ep = min(chunk_cap, epochs - epoch)
                if validation_data is not None:
                    nv = epoch + (-epoch) % validation_every
                    if nv < epoch + n_ep:
                        n_ep = nv - epoch + 1
                if residual:
                    if epoch % resample_every == 0 or not refreshed:
                        data.set_probs(self._residual_probs(
                            state, data.t, data.x, data.u, residual_alpha, residual_mix))
                        refreshed = True
                    # chunks must not cross a refresh boundary
                    nr = epoch + (-epoch) % resample_every
                    if nr == epoch:
                        nr += resample_every
                    n_ep = min(n_ep, nr - epoch)
                t0 = time.perf_counter()
                n = n_ep * steps_per_epoch
                loop.run(n)
                losses = loop.losses(step_i, n).reshape(n_ep, steps_per_epoch)
                dt = (time.perf_counter() - t0) / n_ep
                step_i += n
                state = TrainState(state.params, state.opt_state, state.step + n)
                for j in range(n_ep):
                    e = epoch + j
                    epoch_loss = float(losses[j].mean())
                    self.history["epoch"].append(e)
                    self.history["loss"].append(epoch_loss)
                    logs = {"loss": epoch_loss, "epoch": e, "time": dt}
                    if (validation_data is not None and j == n_ep - 1
                            and e % validation_every == 0):
                        vt, vx, vu = validation_data
                        logs["val_loss"] = self.evaluate(state, vt, vx, vu)
                        self.history.setdefault("val_loss", []).append(logs["val_loss"])
                        self.history.setdefault("val_epoch", []).append(e)
                    if verbose_every and e % verbose_every == 0:
                        print(f"epoch {e:5d}  loss {epoch_loss:.6e}  ({dt:.3f}s)")
                    for cb in callbacks:
                        cb.on_epoch_end(self, state, e, logs)
                epoch += n_ep
        finally:
            self.history.setdefault("resident_capture_ms", []).extend(loop.capture_ms)
            self.history.setdefault("resident_step_ms", []).extend(loop.step_ms)
            loop.close()
        for cb in callbacks:
            cb.on_train_end(self, state)
        return state

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

    def evaluate_sobolev(self, state: TrainState, t, x, u, target_jac, sample_weight=None,
                         group_batch: Optional[int] = None,
                         target_hess=None) -> Dict[str, float]:
        """``{"value_mse", "jacobian_mse", "total"}`` over the full grouped
        dataset, ``total`` weighted by the trainer's ``w_value``/``w_jac``:
        the per-term monitoring of Sobolev training. Evaluated in chunks of
        ``group_batch`` groups (default: about 4M points per chunk) through
        ``output_and_jacobian_grouped``, which runs one K5 launch per chunk
        on the card. ``target_hess [G, P, so, si, si]`` adds a
        ``"hessian_mse"`` term and its ``w_hess`` share of ``total``; the
        chunks then go through ``output_jacobian_hessian_grouped``, one K7
        launch per chunk on the card."""
        from ..ops.derivatives import (output_and_jacobian_grouped,
                                       output_jacobian_hessian_grouped)

        t, x = np.asarray(t), np.asarray(x)
        u, ju = np.asarray(u), np.asarray(target_jac)
        hu = None if target_hess is None else np.asarray(target_hess)
        G, P = x.shape[0], x.shape[1]
        gb = min(group_batch or max(1, 4_000_000 // max(P, 1)), G)
        se_y = se_j = se_h = 0.0
        with torch.no_grad():
            for s in range(0, G, gb):
                sl = slice(s, min(s + gb, G))
                bt, bx, bu, bj = self._put(t[sl], x[sl], u[sl], ju[sl])
                if hu is None:
                    y, jac = output_and_jacobian_grouped(self.model, bt, bx)
                else:
                    y, jac, hess = output_jacobian_hessian_grouped(self.model, bt, bx)
                w = (None if sample_weight is None else
                     torch.as_tensor(np.asarray(sample_weight[sl], np.float32), device=y.device))

                def wsum(pred, target):
                    sq = torch.square(pred.float() - target.float())
                    if w is not None:
                        sq = sq * w.reshape(w.shape + (1,) * (sq.dim() - 2))
                    return float(torch.sum(sq))

                se_y += wsum(y, bu)
                se_j += wsum(jac, bj)
                if hu is not None:
                    se_h += wsum(hess, self._put(hu[sl])[0])
        n_y = float(G * P * u.shape[-1])
        n_j = float(G * P * ju.shape[-2] * ju.shape[-1])
        se_y, se_j, n_y, n_j = global_sums(se_y, se_j, n_y, n_j)
        value_mse = se_y / max(n_y, 1.0)
        jac_mse = se_j / max(n_j, 1.0)
        out = {"value_mse": value_mse, "jacobian_mse": jac_mse,
               "total": self.w_value * value_mse + self.w_jac * jac_mse}
        if hu is not None:
            se_h, n_h = global_sums(se_h, float(G * P * int(np.prod(hu.shape[-3:]))))
            out["hessian_mse"] = se_h / max(n_h, 1.0)
            out["total"] += self.w_hess * out["hessian_mse"]
        return out
