"""The port's tutorial 1 (``nif_tpu_torch/examples/01_simple_1d_wave.py``:
the point-wise ``Trainer``, a checkpoint round trip and 600 L-BFGS
iterations) on the CPU at the budget and threshold of
``tests/test_examples.py``.

The run starts from the JAX package's init at ``jax.random.key(0)`` (as
``test_torch_convergence.py`` does): at 60 Adam epochs and 600 L-BFGS
iterations the outcome hangs on the draw (the port's own draws of seeds 0-8
end at 0.045-0.96, the JAX draws of seeds 0-3 at 0.026-0.47; from the JAX
draws the port ends at 0.0077-0.34).
"""
import torch

import nif_tpu

from _torch_examples import carry_jax_init, port_example

torch.set_num_threads(2)


def test_tutorial_1_trains_and_finetunes(tmp_path, monkeypatch):
    mod = port_example("01_simple_1d_wave")
    carry_jax_init(monkeypatch, mod, nif_tpu.NIF(mod.cfg_shape_net, mod.cfg_parameter_net))
    mse = mod.main(epochs=60, batch_size=512, lbfgs_iters=600,
                   ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    assert mse < 0.5  # random init starts ~1.0
    assert (tmp_path / "ckpt" / "config.json").exists()




def test_the_committed_tutorial_1_init_is_the_jax_init():
    """``tests/data/tutorial1_jax_init_key0.npz`` (the start point
    ``chip_smoke.py`` phase 3p gives tutorial 1 on the card, where JAX is
    absent) holds the JAX package's init at ``jax.random.key(0)`` bit for bit."""
    import pathlib

    import jax
    import numpy as np

    mod = port_example("01_simple_1d_wave")
    params = nif_tpu.NIF(mod.cfg_shape_net, mod.cfg_parameter_net).init(jax.random.key(0))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(params, "")
    path = pathlib.Path(__file__).resolve().parent / "data" / "tutorial1_jax_init_key0.npz"
    with np.load(path) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            assert z[k].dtype == v.dtype and np.array_equal(z[k], v), k
