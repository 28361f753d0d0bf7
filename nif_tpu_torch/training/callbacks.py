"""Callbacks for the training loop (counterpart of
``nif_tpu/training/callbacks.py``): plain objects with ``on_train_begin`` /
``on_epoch_end`` / ``on_train_end`` hooks for printing, CSV and TensorBoard
logs, checkpoints and learning-rate schedules.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Callable, Optional

__all__ = [
    "Callback",
    "LossPrintingCallback",
    "CSVLogger",
    "CheckpointCallback",
    "TensorBoardCallback",
    "LearningRateScheduler",
]


def save_state(ckpt, step: int, payload, mesh) -> None:
    """``ckpt.save(step, payload)``; under a mesh rank 0 writes and every
    rank waits for the file (a shared directory every rank then reads)."""
    from ..parallel.collectives import barrier, is_primary

    if mesh is None:
        ckpt.save(step, payload)
        return
    if is_primary():
        ckpt.save(step, payload)
    barrier()


class Callback:
    def on_train_begin(self, trainer):
        pass

    def on_epoch_end(self, trainer, state, epoch: int, logs: dict):
        pass

    def on_train_end(self, trainer, state):
        pass


class LossPrintingCallback(Callback):
    """Prints loss every ``every`` epochs (reference
    LossAndErrorPrintingCallback, README.md:81-82)."""

    def __init__(self, every: int = 100):
        self.every = every
        self._t0 = None

    def on_train_begin(self, trainer):
        self._t0 = time.perf_counter()

    def on_epoch_end(self, trainer, state, epoch, logs):
        if epoch % self.every == 0:
            dt = time.perf_counter() - self._t0
            print(f"[{dt:8.1f}s] epoch {epoch:6d}  loss {logs['loss']:.6e}")


class CSVLogger(Callback):
    def __init__(self, path: str):
        self.path = path
        self._writer = None
        self._fh = None

    def on_train_begin(self, trainer):
        self._fh = open(self.path, "w", newline="")
        self._writer = csv.writer(self._fh)
        self._writer.writerow(["epoch", "loss", "time"])

    def on_epoch_end(self, trainer, state, epoch, logs):
        self._writer.writerow([epoch, logs["loss"], logs.get("time", "")])

    def on_train_end(self, trainer, state):
        if self._fh:
            self._fh.close()


class CheckpointCallback(Callback):
    """Saves a ``torch.save`` checkpoint every ``every`` epochs, keyed by
    the global step (epochs restart at 0 on every ``fit`` call, so a resumed
    run against the same directory would otherwise collide).

    By default it saves the full train state: ``{"params": the parameters'
    state dict, "opt_state": the optimizer's state dict, "step": int}``;
    ``full_state=False`` saves the parameters' state dict alone. Under a
    trainer's mesh the state is assembled whole first (a row-parallel head,
    ZeRO-1 shares; ``parallel/state.py``), rank 0 writes it, and every rank
    waits for the file."""

    def __init__(self, directory: str, every: int = 1000,
                 keep: Optional[int] = None, full_state: bool = True):
        from .checkpoint import Checkpointer

        self.ckpt = Checkpointer(directory, keep=keep)
        self.every = every
        self.full_state = full_state

    def _payload(self, trainer, state):
        from ..parallel.state import full_optimizer_state, full_param_state

        params = full_param_state(trainer.model)
        if not self.full_state:
            return params
        return {"params": params,
                "opt_state": full_optimizer_state(trainer.model, state.opt_state),
                "step": int(state.step)}

    def on_epoch_end(self, trainer, state, epoch, logs):
        if epoch % self.every == 0:
            save_state(self.ckpt, int(state.step), self._payload(trainer, state),
                       getattr(trainer, "mesh", None))

    def on_train_end(self, trainer, state):
        self.ckpt.wait()


class TensorBoardCallback(Callback):
    """Writes TensorBoard scalar event files with the dependency-free
    writer (``utils/tb_events.py``), plus a ``scalars.csv`` mirror so the
    numbers stay greppable without TensorBoard."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        self._csv = None

    def on_train_begin(self, trainer):
        from ..utils.tb_events import EventFileWriter

        os.makedirs(self.log_dir, exist_ok=True)
        self._writer = EventFileWriter(self.log_dir)
        self._csv = CSVLogger(os.path.join(self.log_dir, "scalars.csv"))
        self._csv.on_train_begin(trainer)

    def on_epoch_end(self, trainer, state, epoch, logs):
        for key, val in logs.items():
            if isinstance(val, (int, float)):
                self._writer.add_scalar(key, float(val), epoch)
        self._csv.on_epoch_end(trainer, state, epoch, logs)

    def on_train_end(self, trainer, state):
        self._writer.close()
        self._csv.on_train_end(trainer, state)


class LearningRateScheduler(Callback):
    """Epoch-wise LR control (reference README.md:84-90): after each epoch,
    every parameter group's ``lr`` becomes ``schedule(epoch, lr)``."""

    def __init__(self, schedule: Callable[[int, float], float]):
        self.schedule = schedule

    def on_epoch_end(self, trainer, state, epoch, logs):
        for group in state.opt_state.param_groups:
            group["lr"] = self.schedule(epoch, float(group["lr"]))
