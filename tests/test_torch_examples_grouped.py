"""The port's grouped tutorials (``nif_tpu_torch/examples`` 05, 08 and 13)
on the CPU at the budgets and thresholds of ``tests/test_examples.py``; each
data generator bit for bit the JAX example's (the JAX file loaded by path);
and tutorial 13's held-out reconstruction and finer ROM decode on
parameters carried across from the JAX model of the same config, against
the JAX package's calls (the ``mixed_bfloat16`` policy: rel-L2 1e-2).
"""
import jax
import numpy as np
import pytest
import torch

import nif_tpu
from nif_tpu_torch.convert import from_jax_params

from _torch_examples import jax_example, port_example

torch.set_num_threads(2)


def test_tutorial_5_streaming(tmp_path):
    mod = port_example("05_large_scale_training")
    loss = mod.main(epochs=2, batch_size=4096, n_points=20_000, workdir=str(tmp_path),
                    device="cpu")
    assert loss < 2.0


def test_tutorial_5_grouped_streaming(tmp_path):
    mod = port_example("05_large_scale_training")
    final = mod.grouped_streaming_demo(workdir=str(tmp_path), epochs=2, device="cpu")
    assert np.isfinite(final)


def test_tutorial_8_sobolev():
    mod = port_example("08_sobolev_training")
    value_mse = mod.main(epochs=10, device="cpu")
    assert value_mse < 5.0


def test_tutorial_8_sobolev_grouped():
    mod = port_example("08_sobolev_training")
    value_mse = mod.main_grouped(epochs=10, device="cpu")
    assert value_mse < 5.0


def test_tutorial_8_sobolev_trainer():
    mod = port_example("08_sobolev_training")
    loss = mod.main_trainer(epochs=10, device="cpu")
    assert np.isfinite(loss)


def test_tutorial_8_sobolev_hessian():
    mod = port_example("08_sobolev_training")
    loss = mod.main_hessian(epochs=10, device="cpu")
    assert np.isfinite(loss)


def test_tutorial_13_paper_scale_smoke(tmp_path):
    mod = port_example("13_paper_scale_3d")
    err = mod.main(workdir=str(tmp_path), epochs=3, device="cpu")
    assert np.isfinite(err)


class _Captured(Exception):
    """Raised by a stub in place of the JAX example's dataset writer, once
    it holds the arrays."""


def test_tutorial_5_generators_equal_the_jax_examples(tmp_path, monkeypatch):
    """The JAX example's inline generators, caught where they hand their
    arrays to the dataset writer: the npz ``main`` writes, and the arrays
    ``grouped_streaming_demo`` shards."""
    import nif_tpu.data

    mine = port_example("05_large_scale_training")
    ref = jax_example("05_large_scale_training")
    caught = {}

    class Sharded:
        def __init__(self, *a, **kw):
            pass

        def create_from_npz(self, npz_path, npz_key, **kw):
            with np.load(npz_path) as z:
                caught["big"] = z[npz_key]
            raise _Captured

    class Grouped:
        @staticmethod
        def create_from_arrays(t, x, u, *a, **kw):
            caught["grouped"] = (t, x, u)
            raise _Captured

    monkeypatch.setattr(ref, "ShardedDataset", Sharded)
    monkeypatch.setattr(nif_tpu.data, "GroupedDataset", Grouped)
    with pytest.raises(_Captured):
        ref.main(n_points=20_000, seed=3, workdir=str(tmp_path))
    with pytest.raises(_Captured):
        ref.grouped_streaming_demo(workdir=str(tmp_path))
    big = mine.stream_data(20_000, seed=3)
    assert big.dtype == caught["big"].dtype and np.array_equal(big, caught["big"])
    for a, b in zip(mine.grouped_data(), caught["grouped"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tutorial_8_problems_equal_the_jax_examples():
    from nif_tpu.demo import TravelingWaveHighFreq
    from nif_tpu.demo.datasets import traveling_wave_dudx

    mine = port_example("08_sobolev_training")
    ref = jax_example("08_sobolev_training")
    for n_xg, G in ((256, 10), (64, 3)):
        for a, b in zip(mine._grouped_problem(n_xg, G), ref._grouped_problem(n_xg, G)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # main's data, as the JAX example's main builds it
    tw = TravelingWaveHighFreq()
    lo = tw.n_p + tw.n_x
    dudx = traveling_wave_dudx(tw.data_raw[:, 0], tw.data_raw[:, 1], tw.wavenumber)
    want = (np.asarray(tw.data[:, :2], np.float32), np.asarray(tw.u, np.float32),
            (dudx * tw.std[1] / tw.std[lo]).reshape(-1, 1, 1).astype(np.float32))
    for a, b in zip(mine._pointwise_problem(), want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("G, P, seed", [(8, 4096, 0), (5, 300, 7)])
def test_tutorial_13_synth_field_equals_the_jax_examples(G, P, seed):
    mine = port_example("13_paper_scale_3d").synth_field(G, P, seed)
    ref = jax_example("13_paper_scale_3d").synth_field(G, P, seed)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _rel_l2(a, b) -> float:
    a = np.asarray(a.float().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tutorial_13_reconstruction_stage_matches_jax():
    """The held-out ``apply_grouped`` and the finer ROM decode at the
    example's CPU defaults (units 32, latent 16, G=8 x P=4096) on
    parameters carried across from the JAX model, against the JAX calls the
    JAX example makes."""
    from nif_tpu.utils import rel_l2 as jax_rel_l2

    mod = port_example("13_paper_scale_3d")
    G, P, n_train = 8, 4096, 7
    t, x, u = mod.synth_field(G, P, 0)
    model = mod.make_model(32, 16, device="cpu")
    jax_model = nif_tpu.NIFMultiScale(model.cfg_shape_net.to_dict(),
                                      model.cfg_parameter_net.to_dict(),
                                      mixed_policy="mixed_bfloat16")
    params = jax_model.init(jax.random.key(2))
    from_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    out = mod.reconstruct(model, t, x, u, n_train)

    pred = np.asarray(jax_model.apply_grouped(params, t[n_train:], x[n_train:]), np.float32)
    err = float(jax_rel_l2(pred.ravel(), u[n_train:].ravel()))
    lr = jax_model.p_to_lr(params, t[n_train:])
    wb = jax_model.lr_to_w(params, lr)
    x_fine = np.random.default_rng(1).uniform(-1, 1, (G - n_train, 2 * P, 3)).astype(np.float32)
    u_fine = jax_model.x_to_u_given_w_grouped(x_fine, wb)
    assert out["pred"].shape == pred.shape and tuple(out["u_fine"].shape) == u_fine.shape
    for mine, ref in ((out["pred"], pred), (out["lr"], lr), (out["wb"], wb),
                      (out["u_fine"], u_fine)):
        assert _rel_l2(mine, ref) <= 1e-2
    assert abs(out["err"] - err) <= 1e-2 * err
