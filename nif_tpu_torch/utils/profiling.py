"""Tracing, step timing and NaN checks (counterpart of
``nif_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` context that writes a Chrome /
  TensorBoard trace of the host and (on the card) the device into
  ``logdir``; open it in TensorBoard's profile plugin or Perfetto.
* ``StepTimer``: windowed step timing that asynchronous launches cannot
  fool: it syncs by reading back the step's loss tensor.
* ``enable_nan_checks()`` / ``disable_nan_checks()``: the counterpart of
  ``jax_debug_nans``, which raises at the first NaN any op makes. Autograd's
  anomaly mode alone sees only backward NaNs, so these enter (and leave) a
  dispatch mode that checks the floating outputs of every op, forward and
  backward, and raises ``FloatingPointError`` naming the op. The fused
  kernels fill their outputs through ctypes, outside the dispatcher, so a
  NaN a kernel makes is caught at the first op that reads it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["trace", "StepTimer", "enable_nan_checks", "disable_nan_checks"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('./tb-logs'): run_steps()`` writes
    ``logdir/trace_<pid>.json`` (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_NAN_MODE: Optional[_NaNCheck] = None


def enable_nan_checks() -> None:
    """From now on, raise at the first op that makes a NaN (see the module
    docstring). Costs a device sync per op: for debugging."""
    global _NAN_MODE
    if _NAN_MODE is None:
        _NAN_MODE = _NaNCheck()
        _NAN_MODE.__enter__()


def disable_nan_checks() -> None:
    global _NAN_MODE
    if _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)


class StepTimer:
    """Wall-clock step timing with a device sync per window.

    Asynchronous launches make naive per-step timing meaningless; this
    timer syncs by reading back the loss of the last step of each window.

    Usage::

        timer = StepTimer(window=50)
        for batch in data:
            state, loss = trainer.step(state, *batch)
            stats = timer.tick(loss)     # None except at window edges
            if stats:
                print(f"{stats['steps_per_sec']:.1f} steps/s")
    """

    def __init__(self, window: int = 50):
        self.window = window
        self._count = 0
        self._t0: Optional[float] = None

    @staticmethod
    def _sync(value) -> None:
        float(torch.as_tensor(value).reshape(-1)[0])

    def tick(self, sync_value) -> Optional[dict]:
        self._count += 1
        if self._t0 is None:
            # Sync before starting the window so warm-up (builds) is excluded.
            self._sync(sync_value)
            self._t0 = time.perf_counter()
            self._count = 0
            return None
        if self._count < self.window:
            return None
        self._sync(sync_value)
        dt = time.perf_counter() - self._t0
        stats = {
            "steps_per_sec": self._count / dt,
            "sec_per_step": dt / self._count,
            "window": self._count,
        }
        self._t0 = time.perf_counter()
        self._count = 0
        return stats
