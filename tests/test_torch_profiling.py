"""``nif_tpu_torch.utils.profiling`` (counterpart of
``nif_tpu/utils/profiling.py``) on the CPU: ``trace`` writes a Chrome trace
holding the traced ops, ``StepTimer`` reports a window of steps, and the NaN
checks raise at the first op that makes a NaN, forward or backward, and
stop raising after ``disable_nan_checks``."""
import json
import os

import numpy as np
import pytest
import torch

import nif_tpu_torch
from nif_tpu_torch.training import GroupedTrainer
from nif_tpu_torch.utils.profiling import (StepTimer, disable_nan_checks, enable_nan_checks,
                                           trace)

torch.set_num_threads(1)

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 8, "nlayers": 1, "activation": "sine",
         "use_resblock": False, "omega_0": 30.0, "connectivity": "full",
         "weight_init_factor": 0.1}
CFG_P = {"input_dim": 1, "latent_dim": 2, "units": 8, "nlayers": 1, "activation": "swish"}


def _trainer():
    model = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu")
    tr = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-3))
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((2, 1)).astype(np.float32),
             rng.standard_normal((2, 16, 2)).astype(np.float32),
             rng.standard_normal((2, 16, 1)).astype(np.float32))
    return tr, tr.init(0), batch


def test_trace_writes_a_chrome_trace(tmp_path):
    tr, state, batch = _trainer()
    with trace(str(tmp_path / "tb")):
        tr.step(state, *batch)
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "tb" / files[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names


def test_step_timer_reports_a_window():
    tr, state, batch = _trainer()
    timer = StepTimer(window=3)
    stats = []
    for _ in range(7):
        state, loss = tr.step(state, *batch)
        stats.append(timer.tick(loss))
    # the first tick starts the window; a window closes every 3 steps after
    assert [s is not None for s in stats] == [False, False, False, True, False, False, True]
    s = stats[3]
    assert s["window"] == 3 and s["steps_per_sec"] > 0
    assert s["sec_per_step"] == pytest.approx(1.0 / s["steps_per_sec"])


def test_nan_checks_raise_forward_and_backward_then_stop():
    x = torch.tensor([-1.0, 1.0], requires_grad=True)
    enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
        y = torch.sqrt(x * 0.0)  # finite forward: [0, 0]
        with pytest.raises(FloatingPointError, match="NaN"):
            y.sum().backward()  # d sqrt at 0 is inf, times d(x * 0) = 0: NaN
        enable_nan_checks()  # idempotent
    finally:
        disable_nan_checks()
    assert bool(torch.isnan(torch.log(torch.tensor([-1.0]))).all())
    disable_nan_checks()  # idempotent
