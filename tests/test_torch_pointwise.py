"""The port's point-wise training and data against the JAX package on the
CPU: ``Trainer`` (``fit`` with padded tails and sample weights,
``evaluate``, ``evaluate_metrics``, validation), ``make_loss_fn`` with
regularization and ``make_train_step``, and the port's copies of
``PointWiseData`` and the demo datasets (pinned equal by AST, and equal in
their data, ``as_grouped`` included).

The JAX model draws the parameters; they cross to the port as numpy arrays
(``from_jax_params``), and both packages get the same numpy inputs and the
same numpy seed, so the same batches. Tolerances (float32): losses rel 1e-5
and gradients normalized by each leaf's largest entry atol 1e-5 for one
evaluation; losses rtol 1e-4 (rel 1e-5 for single steps) and parameters atol
1e-4 (normalized) after Adam steps, whose eager chains round differently in
the last bit in the two packages and whose update divides a near-zero
gradient entry by its own root mean square.
"""
import ast
import csv
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu import demo as jax_demo
from nif_tpu.data.point_wise_data import PointWiseData as JaxPointWiseData
from nif_tpu.demo import datasets as jax_datasets
from nif_tpu.training import Trainer as JaxTrainer
from nif_tpu.training.trainer import make_loss_fn as jax_make_loss_fn
from nif_tpu.training.trainer import make_train_step as jax_make_train_step
import nif_tpu_torch
from nif_tpu_torch import demo
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.data import PointWiseData
from nif_tpu_torch.demo import datasets
from nif_tpu_torch.training import CSVLogger, Trainer, TrainState, make_loss_fn, make_train_step

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]

# tutorial 1's model (examples/01_simple_1d_wave.py)
CFG_S = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2, "activation": "swish"}
CFG_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2, "activation": "swish"}


# ------------------------------------------------------------- the copies
def _code(path: pathlib.Path, drop_imports: bool = False) -> str:
    """The module's AST without its docstrings (and, with
    ``drop_imports``, without its imports)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    if drop_imports:
        tree.body = [n for n in tree.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


def test_point_wise_data_is_a_copy_of_the_jax_module():
    """Same code as nif_tpu/data/point_wise_data.py, module docstring aside."""
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(REPO / "nif_tpu_torch/data/point_wise_data.py") == body(
        REPO / "nif_tpu/data/point_wise_data.py")


def test_demo_datasets_are_a_copy_of_the_jax_module():
    """Same code as nif_tpu/demo/datasets.py, docstrings (the port's speak
    of the port) and the import line aside."""
    assert _code(REPO / "nif_tpu_torch/demo/datasets.py", drop_imports=True) == _code(
        REPO / "nif_tpu/demo/datasets.py", drop_imports=True)
    assert demo.__all__ == jax_demo.__all__
    assert issubclass(demo.TravelingWave, PointWiseData)


@pytest.mark.parametrize("name,kwargs", [
    ("TravelingWave", {}), ("TravelingWave", {"n_t": 4, "n_x": 64}),
    ("TravelingWaveHighFreq", {}), ("TravelingWaveHighFreq", {"n_t": 10, "n_x": 256}),
    ("CylinderFlow", {"n_t": 3, "n_pts": 50, "seed": 2})])
def test_demo_datasets_match_jax(name, kwargs):
    mine, ref = getattr(demo, name)(**kwargs), getattr(jax_demo, name)(**kwargs)
    for attr in ("data_raw", "data", "mean", "std", "sample_weight", "parameter", "x", "u"):
        a, b = getattr(mine, attr), getattr(ref, attr)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.as_grouped(), ref.as_grouped()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.denormalize_u(mine.u), ref.denormalize_u(ref.u))


def test_demo_analytic_helpers_match_jax():
    t, x = np.meshgrid(np.linspace(0, 90, 7), np.linspace(0, 1, 11), indexing="ij")
    for fn in ("traveling_wave_field", "traveling_wave_dudx", "traveling_wave_d2udx2"):
        np.testing.assert_array_equal(getattr(datasets, fn)(t, x, 400.0),
                                      getattr(jax_datasets, fn)(t, x, 400.0))


def test_point_wise_data_grouping_and_refusals():
    rng = np.random.default_rng(0)
    p = np.repeat(np.arange(3.0), 4)[:, None]
    x = rng.standard_normal((12, 2))
    u = rng.standard_normal((12, 1))
    mine, ref = PointWiseData(p, x, u), JaxPointWiseData(p, x, u)
    mine.data, mine.mean, mine.std = mine.standard_normalize(mine.data_raw)
    ref.data, ref.mean, ref.std = ref.standard_normalize(ref.data_raw)
    for a, b in zip(mine.as_grouped(), ref.as_grouped()):
        np.testing.assert_array_equal(a, b)
    ragged = PointWiseData(p[:-1], x[:-1], u[:-1])
    ragged.data = ragged.data_raw
    with pytest.raises(ValueError, match="same number of points"):
        ragged.as_grouped()
    with pytest.raises(ValueError, match="not been normalized"):
        PointWiseData(p, x, u).denormalize_u(u)


# --------------------------------------------------------- loss and step
def _models(cfg_p=CFG_P, seed=0, kind="NIF", cfg_s=CFG_S):
    jm = getattr(nif_tpu, kind)(cfg_s, cfg_p)
    params = jm.init(jax.random.key(seed))
    tm = getattr(nif_tpu_torch, kind)(cfg_s, cfg_p, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _rows(n=96, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            rng.standard_normal((n, 1)).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32))


def _trees_close(mine, ref, atol):
    def check(a, b):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)
    jax.tree_util.tree_map(check, mine, jax.tree_util.tree_map(np.asarray, ref))


def _port_grads(tm, loss):
    params = [p for _, p in tm.param_items()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return jax.tree_util.tree_map(
        lambda g: g.numpy(),
        tm._grad_tree([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]))


@pytest.mark.parametrize("reg", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_make_loss_fn_matches_jax(reg, weighted):
    """The weighted MSE plus l2, activity-l2 and latent-Jacobian terms,
    reweighted per row by ``reg_w``, and its gradient."""
    cfg_p = {**CFG_P, "l2_reg": 1e-3, "act_l2_reg": 1e-4, "jac_reg": 1e-2} if reg else CFG_P
    jm, params, tm = _models(cfg_p)
    inputs, targets, w = _rows()
    w = w if weighted else None
    rw = np.linspace(0.0, 2.0, len(inputs)).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda p: jax_make_loss_fn(jm)(p, inputs, targets, w, rw))(params)
    loss = make_loss_fn(tm)(inputs, targets, w, rw)
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-5)
    _trees_close(_port_grads(tm, loss), g_ref, atol=1e-5)
    no_reg = make_loss_fn(tm, use_reg=False)(inputs, targets, w, rw)
    assert (float(no_reg.detach()) < float(loss.detach())) == reg


def test_make_train_step_matches_jax():
    jm, params, tm = _models(seed=2)
    inputs, targets, w = _rows(seed=5)
    tx = optax.adam(1e-2)
    from nif_tpu.training import TrainState as JaxTrainState

    js = JaxTrainState(params, tx.init(params), 0)
    ts = TrainState(tm.param_tree(), torch.optim.Adam([p for _, p in tm.param_items()],
                                                      lr=1e-2), 0)
    jstep, tstep = jax_make_train_step(jm, tx), make_train_step(tm)
    for _ in range(3):
        js, l_ref = jstep(js, inputs, targets, w)
        ts, loss = tstep(ts, inputs, targets, w)
        assert loss.dim() == 0 and not loss.requires_grad
        assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    assert ts.step == int(js.step) == 3
    _trees_close(to_numpy_params(tm), js.params, atol=1e-4)


# -------------------------------------------------------------- the Trainer
def _trainers(seed=4, lr=2e-3):
    jm, params, tm = _models()
    jt = JaxTrainer(jm, optax.adam(lr), seed=seed)
    js = jt.init(jax.random.key(0))
    tt = Trainer(tm, lambda p: torch.optim.Adam(p, lr=lr), seed=seed)
    ts = tt.init(0)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    return jt, js, tt, ts


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
def test_trainer_fit_matches_jax_on_tutorial1(weighted):
    """Three epochs of tutorial 1's model on ``TravelingWave`` (2000 rows in
    batches of 512: a tail of 464 padded to 512 with zero-weight rows), the
    same permutation from one numpy seed in both packages; then
    ``evaluate`` and ``evaluate_metrics`` in batches of 700 (a short last
    one)."""
    tw = demo.TravelingWave()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    sw = (np.random.default_rng(1).uniform(0.5, 1.5, len(inputs)).astype(np.float32)
          if weighted else None)
    jt, js, tt, ts = _trainers()
    kw = dict(epochs=3, batch_size=512, sample_weight=sw)
    js = jt.fit(js, inputs, targets, **kw)
    ts = tt.fit(ts, inputs, targets, **kw)
    assert ts.step == int(js.step) == 12
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    _trees_close(to_numpy_params(tt.model), js.params, atol=1e-4)
    assert tt._rng.integers(2**63) == jt._rng.integers(2**63)
    assert tt.evaluate(ts, inputs, targets, sample_weight=sw, batch_size=700) == pytest.approx(
        jt.evaluate(js, inputs, targets, sample_weight=sw, batch_size=700), rel=1e-4)
    mine = tt.evaluate_metrics(ts, inputs, targets, batch_size=700)
    ref = jt.evaluate_metrics(js, inputs, targets, batch_size=700)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-4)


def test_trainer_validation_callbacks_and_whole_batches(tmp_path):
    inputs, targets, _ = _rows(n=40)
    _, _, tt, ts = _trainers()
    ts = tt.fit(ts, inputs, targets, epochs=4, batch_size=1000, shuffle=False,
                validation_data=(inputs, targets), validation_every=2,
                callbacks=[CSVLogger(str(tmp_path / "log.csv"))])
    assert ts.step == 4  # a batch larger than the data takes it whole
    assert tt.history["val_epoch"] == [0, 2] and len(tt.history["val_loss"]) == 2
    rows = list(csv.reader(open(tmp_path / "log.csv")))
    assert [r[0] for r in rows[1:]] == ["0", "1", "2", "3"]
    assert np.isnan(tt.evaluate(ts, inputs[:0], targets[:0]))


def test_trainer_decreases_loss():
    """tests/test_training.py:58-64 on the port: the dense sinusoid's loss
    falls by 30% in 50 epochs."""
    t = np.linspace(0.0, 1.0, 20, endpoint=False)
    x = np.linspace(0.0, 1.0, 100, endpoint=False)
    tt_, xx = np.meshgrid(t, x, indexing="ij")
    raw = np.stack([tt_.ravel(), xx.ravel(), np.sin(2 * np.pi * (xx - tt_)).ravel()], -1)
    data = PointWiseData(raw[:, [0]], raw[:, [1]], raw[:, [2]])
    data.data, data.mean, data.std = data.standard_normalize(data.data_raw)
    inputs = np.asarray(data.data[:, :2], np.float32)
    targets = np.asarray(data.u, np.float32)
    cfg = {"input_dim": 1, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "swish"}
    trainer = Trainer(nif_tpu_torch.NIF(cfg, {**cfg, "latent_dim": 1}, device="cpu"),
                      lambda p: torch.optim.Adam(p, lr=2e-3))
    state = trainer.init(0)
    trainer.fit(state, inputs, targets, epochs=50, batch_size=500)
    assert trainer.history["loss"][-1] < trainer.history["loss"][0] * 0.7


@pytest.mark.parametrize("case", ["mesh", "shard_opt_state", "shard_model_axis"])
def test_trainer_refuses_the_mesh(case):
    """The arguments once refused are ported (multi-rank runs:
    tests/test_torch_parallel.py): ``mesh`` on a one-rank gloo mesh trains
    as no mesh does, bit for bit; ``shard_opt_state`` without a mesh does
    nothing, as JAX's (the factory's optimizer, moments whole);
    ``shard_model_axis`` without a ``model`` axis raises JAX's ValueError."""
    from _torch_dist import one_rank_mesh

    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    inputs, targets, _w = _rows(n=40)
    if case == "shard_model_axis":
        with pytest.raises(ValueError, match="'model' axis"):
            Trainer(_models()[2], adam, shard_model_axis=True)
        return
    if case == "shard_opt_state":
        tr = Trainer(_models()[2], adam, shard_opt_state=True)
        state = tr.fit(tr.init(0), inputs, targets, epochs=1, batch_size=16)
        assert type(state.opt_state) is torch.optim.Adam
        for p in tr.model.parameters():
            assert state.opt_state.state[p]["exp_avg"].shape == p.shape
        return
    hist = []
    with one_rank_mesh() as mesh:
        for m in (None, mesh):
            tr = Trainer(_models()[2], adam, mesh=m, seed=2)
            tr.fit(tr.init(0), inputs, targets, epochs=3, batch_size=16)
            hist.append(tr.history["loss"])
    assert hist[0] == hist[1]