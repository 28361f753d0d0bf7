"""The point-wise trainer and the pieces of the training loop the trainers
share (counterpart of ``nif_tpu/training/trainer.py``): zero-weight batch
padding, the train state, resumable init, the weighted-MSE loss and its
train step, and ``Trainer``.

``Trainer`` trains on point-wise rows ``[t..., x...] -> u`` through
``model.apply``: eager PyTorch, as the JAX package's point-wise path runs
outside any Pallas kernel. Batching draws one numpy permutation per epoch in
the JAX loop's calls and order, so one seed feeds both packages the same
batches; a short tail batch (or every batch, when sample weights are given)
is padded with zero-weight rows so the loss and gradient stay the exact
means.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .evaluation import global_sums, metrics_from_sums

__all__ = ["TrainState", "Trainer", "make_loss_fn", "make_train_step", "pad_batch",
           "reg_row_weights", "restore_or_init_state"]


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to nif_tpu_torch yet (ROADMAP {where})")


def pad_batch(arrays, weight, n_real: int, n_target: int):
    """Pad a batch's dim 0 to ``n_target`` with zero-weight filler rows.

    Real rows get their weight scaled by ``n_target / n_real`` so the
    mean-reduced weighted MSE over the padded batch equals the exact mean
    over the real rows — tail batches and mesh-divisibility padding change
    neither the loss value nor the gradient. Batch-mean regularization
    terms (act_l1/l2, jac_reg) need the same correction *without* the
    user's sample weights folded in; pass ``reg_row_weights`` as the
    model's ``reg_weight``.
    """
    scale = n_target / n_real
    w = (np.ones(n_real, np.float32) if weight is None
         else np.asarray(weight, np.float32)) * scale
    if n_target == n_real:
        return arrays, w
    pad = n_target - n_real
    padded = tuple(
        np.concatenate(
            [a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])], axis=0
        )
        for a in arrays
    )
    return padded, np.concatenate([w, np.zeros(pad, np.float32)])


def reg_row_weights(n_real: int, n_target: int) -> np.ndarray:
    """Per-row weights making a padded batch's batch-mean regularization
    terms exact: ``n_target/n_real`` for real rows, 0 for filler, so
    ``mean(per_row * w)`` over ``n_target`` rows equals the true mean over
    the ``n_real`` real rows."""
    w = np.zeros(n_target, np.float32)
    w[:n_real] = n_target / n_real
    return w


class TrainState:
    """The train state: ``params`` (every parameter of the model, an
    ``nn.ModuleDict`` keyed like the JAX params tree: ``"pnet"``, and
    ``"snet"`` for NIF-linear's trunk), ``opt_state`` (the
    ``torch.optim.Optimizer`` over them) and ``step``. PyTorch updates the
    parameters and the optimizer in place, so a new state shares both with
    the one it was made from and carries the next step count."""

    def __init__(self, params, opt_state, step=0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


def _is_full_state(payload) -> bool:
    return isinstance(payload, dict) and set(payload) == {"params", "opt_state", "step"}


def restore_or_init_state(trainer, seed, ckpt_dir: str) -> TrainState:
    """Resumable init shared by ``Trainer`` and ``GroupedTrainer``: a fresh
    ``trainer.init(seed)``, then the checkpoint of ``ckpt_dir`` that a resume
    should continue from, if there is one.

    The latest real step below ``FINAL_MARKER_OFFSET`` is taken; a completed
    run's params-only final marker (saved at step + ``FINAL_MARKER_OFFSET``)
    only when it is all there is, since resuming from it would start a fresh
    optimizer at an inflated step count. A full-state payload
    (``CheckpointCallback``'s ``{"params", "opt_state", "step"}``) restores
    the parameters, the optimizer's state and the step; a params-only
    payload (the parameters' state dict) restores the parameters under the
    fresh optimizer, at the checkpoint's step."""
    from .checkpoint import FINAL_MARKER_OFFSET, Checkpointer

    state = trainer.init(seed)
    ckpt = Checkpointer(ckpt_dir)
    steps = ckpt.all_steps()
    if not steps:
        return state
    real = [s for s in steps if s < FINAL_MARKER_OFFSET]
    step = real[-1] if real else steps[-1]
    payload = ckpt.restore(step, map_location=trainer.model.device)
    if _is_full_state(payload):
        state.params.load_state_dict(payload["params"])
        state.opt_state.load_state_dict(payload["opt_state"])
        return TrainState(state.params, state.opt_state, int(payload["step"]))
    state.params.load_state_dict(payload)
    return TrainState(state.params, state.opt_state, step)


def make_loss_fn(model, use_reg: bool = True) -> Callable:
    """Weighted-MSE loss closure over ``(inputs, targets, weight=None,
    reg_w=None)`` on the model's current parameters (PyTorch keeps them in
    the module, where the JAX closure takes them as its first argument).

    ``inputs [B, pi + si]``, ``targets [B, so]``, ``weight [B]`` (arrays or
    tensors); ``reg_w [B]`` reweights the rows of the batch-mean
    regularization terms (see ``reg_row_weights``); the MSE term is already
    exact under zero-weight padding via ``weight``. Returns a 0-dim tensor
    that autograd can differentiate."""

    def loss_fn(inputs, targets, weight=None, reg_w=None):
        pred = model.apply(inputs)
        targets = torch.as_tensor(targets, device=pred.device)
        err = torch.square(pred - targets.to(pred.dtype))
        if weight is not None:
            weight = torch.as_tensor(weight, device=pred.device)
            err = err * weight.unsqueeze(-1).to(pred.dtype)
        loss = torch.mean(err)
        if use_reg and model.has_regularization:
            loss = loss + model.regularization_loss(inputs=inputs, reg_weight=reg_w)
        return loss

    return loss_fn


def make_train_step(model, use_reg: bool = True) -> Callable:
    """A ``(state, inputs, targets, weight=None, reg_w=None) -> (state,
    loss)`` step: the gradient of :func:`make_loss_fn`'s loss into each
    parameter's ``.grad``, then ``state.opt_state.step()``. The optimizer is
    the state's (the JAX function takes the optax transformation instead).
    The loss comes back as a 0-dim device tensor: no host sync."""
    loss_fn = make_loss_fn(model, use_reg)

    def step(state: TrainState, inputs, targets, weight=None, reg_w=None):
        params = [p for _, p in model.param_items()]
        with torch.enable_grad():
            loss = loss_fn(inputs, targets, weight, reg_w)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss.detach()

    return step


class Trainer:
    """Mini-batch point-wise trainer with callbacks.

    Usage::

        model = nif_tpu_torch.NIF(cfg_s, cfg_p)
        trainer = Trainer(model, lambda p: torch.optim.Adam(p, lr=1e-3))
        state = trainer.init(0)
        state = trainer.fit(state, inputs, targets, epochs=100, batch_size=512)

    ``optimizer`` is a factory, ``parameters -> torch.optim.Optimizer``, as
    in ``GroupedTrainer``. ``mesh``, ``shard_opt_state`` and
    ``shard_model_axis`` (data, ZeRO-1 and tensor parallelism in the JAX
    package) are not ported yet and raise ``NotImplementedError``."""

    def __init__(self, model, optimizer: Callable, mesh=None, use_reg: bool = True,
                 seed: int = 0, shard_opt_state: bool = False,
                 shard_model_axis: bool = False):
        if mesh is not None or shard_opt_state or shard_model_axis:
            raise _not_ported("Trainer over a mesh (mesh / shard_opt_state / shard_model_axis)",
                              "Slice G: multi-GPU")
        self.model = model
        self.make_optimizer = optimizer
        self.use_reg = use_reg
        self._rng = np.random.default_rng(seed)
        self._step = make_train_step(model, use_reg)
        self.history: Dict[str, List[float]] = {"epoch": [], "loss": []}

    def init(self, seed: int = 0) -> TrainState:
        """Redraw the model's parameters from ``seed`` and build the
        optimizer over them: step 0."""
        self.model.init(seed)
        optimizer = self.make_optimizer([p for _, p in self.model.param_items()])
        return TrainState(self.model.param_tree(), optimizer, 0)

    def init_or_restore(self, seed, ckpt_dir: str) -> TrainState:
        """Resumable init: the checkpoint of ``ckpt_dir`` a resume continues
        from (:func:`restore_or_init_state`), else a fresh init. Full-state
        checkpoints resume exactly; params-only ones restore under a fresh
        optimizer."""
        return restore_or_init_state(self, seed, ckpt_dir)

    def _put(self, *arrays):
        """Host arrays to the model's device (None passes through)."""
        return tuple(None if a is None else torch.as_tensor(a, device=self.model.device)
                     for a in arrays)

    def fit(
        self,
        state: TrainState,
        inputs: np.ndarray,
        targets: np.ndarray,
        sample_weight: Optional[np.ndarray] = None,
        epochs: int = 1,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        callbacks: Sequence = (),
        verbose_every: int = 0,
        validation_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        validation_every: int = 1,
    ) -> TrainState:
        """Train for ``epochs`` passes over the rows, ``batch_size`` rows a
        step in a fresh permutation each epoch (``shuffle``). The epoch loss
        is the row-weighted mean of the step losses, read from the device
        once per epoch."""
        n = inputs.shape[0]
        batch_size = min(batch_size or n, n)
        needs_pad = (n % batch_size != 0) or sample_weight is not None
        inputs = np.asarray(inputs)
        targets = np.asarray(targets)
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight).reshape(n)

        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            idx = self._rng.permutation(n) if shuffle else np.arange(n)
            losses, sizes = [], []
            for s in range(0, n, batch_size):
                sel = idx[s: s + batch_size]
                b = len(sel)
                w = None if sample_weight is None else sample_weight[sel]
                bi, bt = inputs[sel], targets[sel]
                rw = None
                if needs_pad:
                    (bi, bt), w = pad_batch((bi, bt), w, b, batch_size)
                    if self.use_reg:
                        rw = reg_row_weights(b, batch_size)
                state, loss = self._step(state, *self._put(bi, bt, w, rw))
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
                vi, vt = validation_data
                logs["val_loss"] = self.evaluate(state, vi, vt)
                self.history.setdefault("val_loss", []).append(logs["val_loss"])
                self.history.setdefault("val_epoch", []).append(epoch)
            if verbose_every and epoch % verbose_every == 0:
                print(f"epoch {epoch:5d}  loss {epoch_loss:.6e}  ({logs['time']:.3f}s)")
            for cb in callbacks:
                cb.on_epoch_end(self, state, epoch, logs)
        for cb in callbacks:
            cb.on_train_end(self, state)
        return state

    def _eval_sums(self, state: TrainState, inputs, targets, sample_weight=None,
                   batch_size: int = 65536):
        """LOCAL ``(sse, sst, n_el)`` over the rows, in batches of
        ``batch_size``, through ``model.apply`` under
        ``torch.inference_mode``."""
        inputs = np.asarray(inputs)
        targets = np.asarray(targets)
        n = inputs.shape[0]
        if n == 0:
            return 0.0, 0.0, 0.0
        bs = min(batch_size, n)
        sw = (np.ones(n, np.float32) if sample_weight is None
              else np.asarray(sample_weight, np.float32).reshape(n))
        sse = sst = 0.0
        with torch.inference_mode():
            for s in range(0, n, bs):
                bi, bt, w = self._put(inputs[s: s + bs], targets[s: s + bs], sw[s: s + bs])
                pred = self.model.apply(bi)
                bt = bt.to(pred.dtype)
                err = torch.square(pred - bt) * w.unsqueeze(-1).to(pred.dtype)
                sse += float(torch.sum(err.to(torch.float32)))
                sst += float(torch.sum(torch.square(bt).to(torch.float32)))
        return sse, sst, float(n * targets.shape[-1])

    def evaluate(self, state: TrainState, inputs, targets, sample_weight=None,
                 batch_size: int = 65536) -> float:
        """Mean (weighted) MSE over the whole dataset."""
        sse, _sst, n_el = self._eval_sums(state, inputs, targets, sample_weight, batch_size)
        sse, n_el = global_sums(sse, n_el)
        return sse / n_el if n_el else float("nan")

    def evaluate_metrics(self, state: TrainState, inputs, targets, sample_weight=None,
                         batch_size: int = 65536) -> Dict[str, float]:
        """``{"mse", "rel_l2"}`` over the whole dataset."""
        sse, sst, n_el = self._eval_sums(state, inputs, targets, sample_weight, batch_size)
        sse, sst, n_el = global_sums(sse, sst, n_el)
        return metrics_from_sums(sse, sst, n_el)
