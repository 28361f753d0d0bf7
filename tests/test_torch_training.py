"""The port's training path against the JAX package on the CPU:
``mse_value_and_grad`` (fused: plain K2 + autograd through the ParameterNet;
eager: autograd over the eager chain), ``regularization_loss``, the batch
padding helpers, and ``GroupedTrainer`` (``fit``, ``evaluate``,
``evaluate_metrics``, callbacks, the refusals, the mesh on one rank). Residual
sampling, ``fit_resident`` and resumable init are held against the JAX
package in ``tests/test_torch_resident.py``.

The JAX model draws the parameters; they cross to the port as numpy arrays
(``from_jax_params``), and both packages get the same numpy inputs. On the
CPU the JAX package's fused path runs its Pallas kernels in interpret mode.
Tolerances (float32): losses rel 1e-5 and gradients normalized by the
largest entry of each leaf, atol 1e-5 (``tests/test_pallas_kernel.py``'s
model-level bound; the same function summed in another order); per-epoch
training losses rtol 1e-4 over five epochs of Adam (torch's and optax's
Adam are the same update; the eager chains round differently in the last
bit and Adam carries that on).
"""
import ast
import csv
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
from nif_tpu.training import evaluation as jax_evaluation
from nif_tpu.training.trainer import pad_batch as jax_pad_batch
from nif_tpu.training.trainer import reg_row_weights as jax_reg_row_weights
import nif_tpu_torch
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.ops import _build
from nif_tpu_torch.training import (
    CheckpointCallback,
    Checkpointer,
    CSVLogger,
    GroupedTrainer,
    LearningRateScheduler,
    LossPrintingCallback,
    TensorBoardCallback,
    pad_batch,
    reg_row_weights,
)
from nif_tpu_torch.training import evaluation

torch.set_num_threads(1)

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 32, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 10.0,
         "connectivity": "full", "weight_init_factor": 0.01}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish"}
REPO = pathlib.Path(__file__).resolve().parents[1]


def _models(cfg_p=None, policy="float32", kind="NIFMultiScale", seed=0):
    cfg_p = CFG_P if cfg_p is None else cfg_p
    jm = getattr(nif_tpu, kind)(CFG_S, cfg_p, mixed_policy=policy)
    params = jm.init(jax.random.key(seed))
    tm = getattr(nif_tpu_torch, kind)(CFG_S, cfg_p, mixed_policy=policy, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _batch(G=2, P=128, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, 1)).astype(np.float32),
            rng.standard_normal((G, P, 2)).astype(np.float32),
            rng.standard_normal((G, P, 1)).astype(np.float32),
            rng.uniform(0.5, 1.5, (G, P)).astype(np.float32))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _trees_close(mine, ref, atol=1e-5):
    """Every leaf within ``atol`` of the reference, normalized by the
    reference leaf's largest entry."""
    def check(a, b):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)
    jax.tree_util.tree_map(check, _np_tree(mine), _np_tree(ref))


def _port_params(tm):
    return [p for _, p in tm.param_items()]


def _port_grads(tm, loss):
    grads = torch.autograd.grad(loss, _port_params(tm), allow_unused=True)
    return tm._grad_tree([torch.zeros_like(p) if g is None else g
                          for p, g in zip(_port_params(tm), grads)])


# --------------------------------------------------------- mse_value_and_grad
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_mse_value_and_grad_matches_jax(fused, weighted):
    """Port fused (plain K2) / eager against the JAX model's same path
    (its fused path runs the Pallas train kernel in interpret mode)."""
    jm, params, tm = _models()
    t, x, u, w = _batch()
    w = w if weighted else None
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=fused)
    loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=fused)
    assert loss.dim() == 0 and not loss.requires_grad
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    _trees_close(grads, g_ref)


def test_mse_value_and_grad_fused_equals_eager_and_counts_no_launch():
    _, _, tm = _models()
    t, x, u, _ = _batch()
    before = dict(_build.LAUNCHES)
    l_f, g_f = tm.mse_value_and_grad(t, x, u, fused=True)
    l_e, g_e = tm.mse_value_and_grad(t, x, u, fused=False)
    assert float(l_f) == pytest.approx(float(l_e), rel=1e-5)
    _trees_close(g_f, g_e)
    assert _build.LAUNCHES == before
    # auto routing on the CPU takes the eager path, as JAX does off the TPU
    l_a, _ = tm.mse_value_and_grad(t, x, u)
    assert float(l_a) == float(l_e)


def test_mse_value_and_grad_bf16_fused_matches_jax():
    """mixed_bfloat16: plain K2 against the Pallas train kernel in interpret
    mode, behind the same bf16 ParameterNet. Loss rel 2e-3; each gradient
    leaf within 2e-2 relative L2 (bf16 ParameterNet matmuls round their
    outputs in both packages, in different orders)."""
    jm, params, tm = _models(policy="mixed_bfloat16")
    t, x, u, w = _batch()
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=True)
    loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=True)
    assert float(loss) == pytest.approx(float(l_ref), rel=2e-3)

    def check(a, b):
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b) + 1e-12
    jax.tree_util.tree_map(check, _np_tree(grads), _np_tree(g_ref))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_mse_value_and_grad_with_regularization_matches_jax(fused):
    cfg_p = {**CFG_P, "l2_reg": 1e-3, "act_l2_reg": 1e-4, "jac_reg": 1e-2}
    jm, params, tm = _models(cfg_p)
    t, x, u, w = _batch()
    rw = np.array([1.5, 0.5], np.float32)
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=fused,
                                         reg_weight=rw)
    loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=fused, reg_weight=rw)
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    _trees_close(grads, g_ref)
    l_noreg, _ = tm.mse_value_and_grad(t, x, u, weight=w, fused=fused, use_reg=False)
    assert float(l_noreg) < float(loss)


# ------------------------------------------------------- regularization_loss
REGS = {
    "l1": {"l1_reg": 1e-3},
    "l2": {"l2_reg": 1e-3},
    "l2_over_l1": {"l1_reg": 1e-2, "l2_reg": 1e-3},
    "act_l1": {"act_l1_reg": 1e-4},
    "act_l2": {"act_l2_reg": 1e-4},
    "jac": {"jac_reg": 1e-2},
}


@pytest.mark.parametrize("reg_weighted", [False, True], ids=["rows", "reg_weight"])
@pytest.mark.parametrize("reg", sorted(REGS))
def test_regularization_loss_and_grads_match_jax(reg, reg_weighted):
    jm, params, tm = _models({**CFG_P, **REGS[reg]})
    assert tm.has_regularization and jm.has_regularization
    t = np.random.default_rng(9).standard_normal((3, 1)).astype(np.float32)
    rw = np.array([1.5, 0.0, 1.5], np.float32) if reg_weighted else None
    ref, g_ref = jax.value_and_grad(
        lambda p: jm.regularization_loss(p, t=t, reg_weight=rw))(params)
    loss = tm.regularization_loss(t=t, reg_weight=rw)
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    _trees_close(_port_grads(tm, loss), g_ref)


def test_regularization_parts_and_inputs():
    cfg_p = {**CFG_P, "l2_reg": 1e-3, "act_l1_reg": 1e-4}
    jm, params, tm = _models(cfg_p)
    t = np.random.default_rng(2).standard_normal((4, 1)).astype(np.float32)
    rows = np.concatenate([t, np.zeros((4, 2), np.float32)], axis=1)
    for parts in ("params", "batch", "all"):
        ref = jm.regularization_loss(params, t=t, parts=parts)
        assert float(tm.regularization_loss(t=t, parts=parts)) == pytest.approx(
            float(ref), rel=1e-5)
    assert float(tm.regularization_loss(inputs=rows)) == pytest.approx(
        float(jm.regularization_loss(params, inputs=rows)), rel=1e-5)
    with pytest.raises(ValueError, match="needs `inputs`"):
        tm.regularization_loss()
    with pytest.raises(ValueError, match="unknown parts"):
        tm.regularization_loss(t=t, parts="most")
    _, _, plain = _models()
    assert not plain.has_regularization
    assert float(plain.regularization_loss()) == 0.0


def test_vanilla_nif_mse_value_and_grad_matches_jax():
    cfg_p = {**CFG_P, "l1_reg": 1e-4}
    jm, params, tm = _models(cfg_p, kind="NIF", seed=3)
    t, x, u, w = _batch(seed=11)
    for fused in (False, True):
        l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=fused)
        loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=fused)
        assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
        _trees_close(grads, g_ref)


# ------------------------------------------------------------- batch padding
@pytest.mark.parametrize("n_real,n_target,weighted", [(3, 3, False), (2, 5, False),
                                                      (3, 4, True)])
def test_pad_batch_and_reg_row_weights_match_jax(n_real, n_target, weighted):
    rng = np.random.default_rng(n_real * 10 + n_target)
    arrays = (rng.standard_normal((n_real, 2)), rng.standard_normal((n_real, 4, 3)))
    weight = rng.uniform(0.5, 1.5, n_real) if weighted else None
    mine, w = pad_batch(arrays, weight, n_real, n_target)
    ref, w_ref = jax_pad_batch(arrays, weight, n_real, n_target)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(w, w_ref)
    assert w.dtype == w_ref.dtype == np.float32
    np.testing.assert_array_equal(reg_row_weights(n_real, n_target),
                                  jax_reg_row_weights(n_real, n_target))


def test_evaluation_helpers_match_jax():
    assert evaluation.global_sums(1.5, 2, np.float32(3.0)) == (1.5, 2.0, 3.0)
    assert evaluation.metrics_from_sums(2.0, 8.0, 4.0) == jax_evaluation.metrics_from_sums(
        2.0, 8.0, 4.0)
    assert evaluation.metrics_from_sums(0.0, 0.0, 0.0) == jax_evaluation.metrics_from_sums(
        0.0, 0.0, 0.0)


# ------------------------------------------------------------ GroupedTrainer
def _dataset(G=5, P=64, seed=7):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 2)).astype(np.float32)
    u = (np.sin(np.pi * x[..., :1] + t[:, None, :]) * np.cos(x[..., 1:])).astype(np.float32)
    return t, x, u


def _trainers(lr=1e-3, seed=3, fused=None):
    jm, _, tm = _models()
    jt = JaxGroupedTrainer(jm, optax.adam(lr), seed=seed)
    js = jt.init(jax.random.key(1))
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=lr), seed=seed, fused=fused)
    ts = tt.init(1)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    return jt, js, tt, ts


@pytest.mark.parametrize("fused,weighted", [(None, False), (None, True), (True, False)],
                         ids=["eager", "eager-sample_weight", "fused"])
def test_grouped_fit_matches_jax(fused, weighted):
    """Five epochs, a tail batch of 1 group padded to 2, 32 of 64 points per
    step: the same batches (one numpy seed) and Adam in both packages."""
    t, x, u = _dataset()
    sw = np.random.default_rng(4).uniform(0.5, 1.5, x.shape[:2]).astype(np.float32)
    sw = sw if weighted else None
    jt, js, tt, ts = _trainers(fused=fused)
    kw = dict(epochs=5, group_batch=2, point_batch=32, sample_weight=sw)
    js = jt.fit(js, t, x, u, **kw)
    ts = tt.fit(ts, t, x, u, **kw)
    assert ts.step == js.step == 15
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    assert tt.history["loss"][-1] < tt.history["loss"][0]
    assert tt.history["path"] == "eager" and "not on CUDA" in tt.history["path_reason"]
    np.testing.assert_allclose(tt.evaluate(ts, t, x, u, sample_weight=sw),
                               jt.evaluate(js, t, x, u, sample_weight=sw), rtol=1e-4)
    mine = tt.evaluate_metrics(ts, t, x, u, group_batch=2)
    ref = jt.evaluate_metrics(js, t, x, u, group_batch=2)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-4)
    _trees_close(to_numpy_params(tt.model), jax.tree_util.tree_map(np.asarray, js.params),
                 atol=1e-4)


def test_grouped_step_and_validation():
    t, x, u = _dataset(G=4, P=32)
    jt, js, tt, ts = _trainers()
    js, l_ref = jt.step(js, t, x, u)
    ts, loss = tt.step(ts, t, x, u)
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0 and ts.step == 1
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    _trees_close(to_numpy_params(tt.model), jax.tree_util.tree_map(np.asarray, js.params),
                 atol=1e-5)
    tt.fit(ts, t, x, u, epochs=2, validation_data=(t, x, u))
    assert tt.history["val_epoch"] == [0, 1] and len(tt.history["val_loss"]) == 2


def test_fit_callbacks(tmp_path, capsys):
    t, x, u = _dataset(G=4, P=32)
    _, _, tt, ts = _trainers(lr=1e-3)
    ck = tmp_path / "ckpt"
    callbacks = [LossPrintingCallback(every=1), CSVLogger(str(tmp_path / "log.csv")),
                 CheckpointCallback(str(ck), every=1, keep=2),
                 TensorBoardCallback(str(tmp_path / "tb")),
                 LearningRateScheduler(lambda epoch, lr: lr * 0.5)]
    ts = tt.fit(ts, t, x, u, epochs=3, group_batch=2, callbacks=callbacks)
    assert "epoch      2" in capsys.readouterr().out
    rows = list(csv.reader(open(tmp_path / "log.csv")))
    assert rows[0] == ["epoch", "loss", "time"] and [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert ts.opt_state.param_groups[0]["lr"] == pytest.approx(1e-3 / 8)
    assert Checkpointer(str(ck)).all_steps() == [4, 6]
    payload = Checkpointer(str(ck)).restore()
    assert payload["step"] == 6 and set(payload) == {"params", "opt_state", "step"}
    for k, v in ts.params.state_dict().items():
        assert torch.equal(payload["params"][k], v)
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    assert (tmp_path / "tb" / "scalars.csv").exists()


def test_checkpointer_round_trip_and_final_marker(tmp_path):
    from nif_tpu.training.checkpoint import FINAL_MARKER_OFFSET as JAX_OFFSET
    from nif_tpu_torch.training import FINAL_MARKER_OFFSET

    assert FINAL_MARKER_OFFSET == JAX_OFFSET
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    ck.save(3, {"w": torch.arange(4.0), "step": 3})
    ck.save(FINAL_MARKER_OFFSET + 3, {"w": torch.ones(2)})
    assert ck.all_steps() == [3, FINAL_MARKER_OFFSET + 3]
    assert torch.equal(ck.restore(3)["w"], torch.arange(4.0))
    assert torch.equal(ck.restore()["w"], torch.ones(2))


def test_tb_events_is_a_copy_of_the_jax_module():
    """The port keeps its own copy of the JAX package's JAX-free event
    writer; the code (docstrings aside) stays identical."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
        return ast.dump(tree)

    assert code(REPO / "nif_tpu_torch/utils/tb_events.py") == code(
        REPO / "nif_tpu/utils/tb_events.py")


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("kwargs,error,match", [
    # Sobolev and Hessian training are ported; derivative targets of the
    # wrong shape are refused
    ({"target_jac": np.zeros((4, 32, 1, 3), np.float32)}, ValueError, "target_jac shape"),
    ({"target_hess": np.zeros((4, 32, 1, 3, 3), np.float32)}, ValueError, "target_hess shape"),
], ids=["target_jac", "target_hess"])
def test_fit_refuses_what_is_not_ported(kwargs, error, match):
    t, x, u = _dataset(G=4, P=32)
    _, _, tt, ts = _trainers()
    with pytest.raises(error, match=match):
        tt.fit(ts, t, x, u, **kwargs)
    with pytest.raises(error, match=match):
        tt.step(ts, t, x, u, **kwargs)
    assert ts.step == 0


def test_trainer_refuses_mesh_and_fit_resident():
    """The mesh once refused is ported (multi-rank runs:
    tests/test_torch_parallel.py): on a one-rank gloo mesh ``fit`` and
    ``fit_resident`` train as no mesh does, bit for bit;
    ``shard_model_axis`` without a ``model`` axis raises JAX's ValueError;
    an unknown point sampling still raises."""
    from _torch_dist import one_rank_mesh

    _, _, tm = _models()
    adam = lambda p: torch.optim.Adam(p, lr=1e-3)  # noqa: E731
    with pytest.raises(ValueError, match="'model' axis"):
        GroupedTrainer(tm, adam, shard_model_axis=True)
    t, x, u = _dataset(G=4, P=16)
    hist = []
    with one_rank_mesh() as mesh:
        for m in (None, mesh):
            tr = GroupedTrainer(_models()[2], adam, mesh=m, seed=1)
            state = tr.fit(tr.init(0), t, x, u, epochs=2, group_batch=2, point_batch=8)
            tr.fit_resident(state, t, x, u, epochs=2, group_batch=2, point_batch=8, seed=3)
            hist.append(tr.history["loss"])
    assert len(hist[0]) == 4 and hist[0] == hist[1]
    with pytest.raises(ValueError, match="unknown point_sampling"):
        t, x, u = _dataset(G=2, P=8)
        GroupedTrainer(tm, adam).fit(None, t, x, u, point_sampling="stratified")
