"""The port's compression and serving tutorials (``nif_tpu_torch/examples``
07 and 10) on the CPU at the budgets and thresholds of
``tests/test_examples.py``."""
import numpy as np
import torch

from _torch_examples import port_example

torch.set_num_threads(2)


def test_tutorial_7_compression():
    mod = port_example("07_compression")
    mse, mse_q = mod.main(epochs=40, device="cpu")
    assert mse < 1.0 and mse_q < 2.0


def test_tutorial_10_serving(tmp_path):
    mod = port_example("10_serving")
    rl2 = mod.main(epochs=30, out_dir=str(tmp_path), device="cpu")
    assert rl2 < 1.5
    assert (tmp_path / "model.pt2").stat().st_size > 0


def test_tutorial_7_quantized_weights_are_what_the_model_evaluates(monkeypatch):
    """The dequantized evaluation runs on the dequantized weights, and the
    trained weights come back afterwards."""
    mod = port_example("07_compression")
    seen = {}
    real = mod.Trainer.evaluate

    def evaluate(self, state, *a, **kw):
        seen.setdefault("params", []).append(
            {k: v.clone() for k, v in self.model.param_tree().state_dict().items()})
        seen["model"] = self.model
        return real(self, state, *a, **kw)

    monkeypatch.setattr(mod.Trainer, "evaluate", evaluate)
    mod.main(epochs=2, device="cpu")
    trained, dq = seen["params"]
    after = seen["model"].param_tree().state_dict()
    assert all(torch.equal(after[k], trained[k]) for k in trained)
    w = "pnet.hidden_0.dense.w"
    assert not torch.equal(dq[w], trained[w])
    assert np.allclose(dq[w].numpy(), trained[w].numpy(),
                       atol=float(trained[w].abs().max()) / 127)
