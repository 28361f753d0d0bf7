"""The port's parallel tutorials (``nif_tpu_torch/examples`` 09 and 12) on
local CPU gloo ranks at the budgets and thresholds of
``tests/test_examples.py``: 09 spawns two ranks (one process each) and
returns rank 0's MSE; 12 runs the multi-host worker on two hosts of two
ranks each (``nif_tpu_torch.entry.dryrun_multihost``). Both clusters start
at once."""
import concurrent.futures

import numpy as np
import pytest

from _torch_examples import port_example


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        dp = pool.submit(port_example("09_data_parallel").main, epochs=40, batch_size=512,
                         device="cpu")
        mh = pool.submit(port_example("12_multihost").main, n_processes=2,
                         devices_per_process=2)
        return {"09": dp.result(), "12": mh.result()}


def test_tutorial_9_data_parallel(runs):
    # Mechanics smoke: the data-parallel step must actually optimize (finite,
    # below the ~1.0026 init loss), as the JAX test holds it
    mse = runs["09"]
    assert np.isfinite(mse) and mse < 1.0


def test_tutorial_12_multihost(runs):
    assert runs["12"] == 0.0
