"""Checkpointing (counterpart of ``nif_tpu/training/checkpoint.py``).

``torch.save`` files keyed by step, ``<directory>/ckpt_<step>.pt``, beside
the model's config JSON (``save_config``), so a checkpoint plus config.json
reconstructs a model. ``latest_step``/``restore`` continue an interrupted run.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

__all__ = ["Checkpointer", "FINAL_MARKER_OFFSET"]

#: Step offset used for the params-only "final" checkpoint a completed run
#: saves after training. Keeps the final weights distinct from the periodic
#: full-state checkpoints in the same directory: ``latest_step`` finds the
#: marker, while a resume prefers the latest real step below this offset.
FINAL_MARKER_OFFSET = 1_000_000

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Saves and restores payloads (nested dicts of tensors, numbers and
    optimizer state dicts) by step. ``keep`` bounds how many are kept, the
    oldest going first."""

    def __init__(self, directory: str, keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, payload: Any) -> None:
        """Write ``payload`` for ``step`` through a temporary file, so a
        reader never sees a partial checkpoint; then drop the oldest past
        ``keep``."""
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.keep is not None:
            for old in self.all_steps()[:-self.keep]:
                os.unlink(self._path(old))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The payload saved for ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=False)

    def all_steps(self) -> List[int]:
        steps = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""
