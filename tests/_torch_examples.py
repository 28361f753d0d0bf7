"""Helpers of the ``tests/test_torch_examples_*.py`` files: load an example
of the port (``nif_tpu_torch/examples``) or of the JAX package
(``examples/``, by path, as ``tests/test_examples.py`` does), and carry a
JAX init into a port example's trainer."""
import importlib
import importlib.util
import pathlib

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def port_example(name):
    return importlib.import_module(f"nif_tpu_torch.examples.{name}")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def carry_jax_init(monkeypatch, mod, jax_model, trainer="Trainer"):
    """Make ``mod``'s trainer start from ``jax_model.init(jax.random.key(seed))``
    (carried across by ``from_jax_params``) in place of the port's own draw
    of the same seed, the start point the JAX example's budget was set on."""
    import jax

    from nif_tpu_torch.convert import from_jax_params

    base = getattr(mod, trainer)

    class Carried(base):
        def init(self, seed=0):
            state = super().init(seed)
            params = jax_model.init(jax.random.key(seed))
            from_jax_params(self.model, jax.tree_util.tree_map(np.asarray, params))
            return state

    monkeypatch.setattr(mod, trainer, Carried)
