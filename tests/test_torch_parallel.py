"""The port's ``parallel/`` on a two-rank gloo cluster on the CPU, against
the JAX package (the counterparts of ``tests/test_parallel.py``).

One module-scoped cluster (``parallel.launch.run_ranks``, two local ranks,
a timeout on the rendezvous, every collective and each process) runs every
case in ``tests/_torch_parallel_ranks.py``, which imports the port only;
the JAX side runs here. The JAX model draws the parameters (SIREN-regime
head: the generated weights ~0.3/omega_0, so f32 sums in another order
stay within the bounds below; ROADMAP Queue 3) and they cross as numpy.

Bounds (float32): the two-rank data-parallel step against JAX's
single-device step on the full batch, loss rel 1e-5 and parameters after 3
Adam steps max|diff| <= 1e-5 max|p| a leaf; per-epoch fit losses rtol 1e-4
(the test_torch_training bound: the eager chains round differently in the
last bit and Adam carries that on); the port against itself (one rank
against two, tensor parallel against data parallel, ZeRO-1 against
replicated) rel 1e-5, the same function summed in another order; across
ranks, bit for bit.
"""
import ast
import json
import pathlib

import jax
import numpy as np
import optax
import pytest

import nif_tpu
from nif_tpu.parallel import mesh as jax_mesh
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
from nif_tpu.training.trainer import TrainState as JaxTrainState
from nif_tpu_torch.parallel import mesh as torch_mesh
from nif_tpu_torch.parallel.launch import run_ranks

import _torch_parallel_ranks as ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = str(REPO / "tests" / "_torch_parallel_ranks.py")


def _jax_params():
    """JAX-drawn parameters with a SIREN-regime head (weights generated at
    ~0.3 / omega_0)."""
    model = nif_tpu.NIFMultiScale(ranks.CFG_S, ranks.CFG_P)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    last = params["pnet"]["last"]
    scale = 0.3 / ranks.CFG_S["omega_0"]
    last["w"] = (rng.standard_normal(last["w"].shape) * scale / 2).astype(np.float32)
    last["b"] = (rng.standard_normal(last["b"].shape) * scale).astype(np.float32)
    return model, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    model, params = _jax_params()
    np.savez(work / "params.npz", **_flat(params))
    results = run_ranks(f"{RANKS}:scenarios", 2, {"workdir": str(work)}, device="cpu",
                        timeout=240)
    return model, params, results


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def test_the_ranks_agree_bit_for_bit(cluster):
    _, _, (r0, r1) = cluster
    for key in ("dp_steps", "dp_fit", "pointwise", "evaluation", "resident", "lbfgs"):
        a, b = ({k: v for k, v in r[key].items() if not k.endswith("_owned")}
                for r in (r0, r1))  # a ZeRO-1 share is the rank's own
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), key
    assert r0["tp_checkpoint"]["continued"] == r1["tp_checkpoint"]["continued"]


def test_mesh_helpers(cluster):
    _, _, (r0, r1) = cluster
    h = r0["helpers"]
    assert h["mesh"] == [["data"], {"data": 2}, 2, "gloo"]
    assert h["tp"][:4] == [["data", "model"], {"data": 1, "model": 2}, ["data"], 1]
    assert (h["tp"][4], r1["helpers"]["tp"][4]) == (0, 1)
    # one node: a degenerate replica axis leads, so specs stay portable
    assert h["hybrid"] == [["replica", "data"], {"replica": 1, "data": 2},
                           ["replica", "data"], 2]
    assert h["hybrid2"] == [["replica", "data", "model"],
                            {"replica": 1, "data": 1, "model": 2}]
    assert h["block"] == [[8, 3], 48.0, [0, 2]] and r1["helpers"]["block"][2] == [1, 2]
    assert h["placed_again"] and h["tree"] == [[4, 2], [0.0, 1.0, 2.0, 3.0]]
    assert r1["helpers"]["tree"][1] == [4.0, 5.0, 6.0, 7.0]
    assert h["replicated_differs_raises"] and h["replicated_same"] and h["uneven_raises"]
    assert h["eval_block"] == [[0, 3], [0, 4]]
    assert r1["helpers"]["eval_block"] == [[3, 7], [4, 8]]


def test_pad_to_multiple_is_the_jax_function():
    """A copy, pinned equal by AST, and its behaviour (tests/test_parallel.py)."""
    def fn(mod):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        node = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == "pad_to_multiple")
        return ast.dump(node)

    assert fn(torch_mesh) == fn(jax_mesh)
    padded, n = torch_mesh.pad_to_multiple(np.ones((13, 2)), 8)
    assert padded.shape == (16, 2) and n == 13
    same, n2 = torch_mesh.pad_to_multiple(np.ones((16, 2)), 8)
    assert same.shape == (16, 2) and n2 == 16


def test_data_parallel_step_matches_jax_on_the_full_batch(cluster):
    model, params, (r0, _) = cluster
    jt = JaxGroupedTrainer(model, optax.adam(ranks.LR))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    state = JaxTrainState(jparams, jt.tx.init(jparams), 0)
    t, x, u = ranks.inputs(4, 32, 11)
    losses = []
    for _ in range(3):
        state, loss = jt.step(state, t, x, u)
        losses.append(float(loss))
    assert _rel(r0["dp_steps"]["losses"], losses) <= 1e-5
    want = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    got = r0["dp_steps"]["params"]
    assert set(got) == set(want)
    for k, w in want.items():
        diff = np.max(np.abs(np.asarray(got[k]) - w))
        assert diff <= 1e-5 * np.max(np.abs(w)), (k, diff)


def test_data_parallel_fit_matches_jax(cluster):
    model, params, (r0, _) = cluster
    jt = JaxGroupedTrainer(model, optax.adam(ranks.LR), seed=4)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    state = JaxTrainState(jparams, jt.tx.init(jparams), 0)
    t, x, u = ranks.inputs(8, 32, 12)
    jt.fit(state, t, x, u, epochs=3, group_batch=4, point_batch=16)
    np.testing.assert_allclose(r0["dp_fit"]["dp"], jt.history["loss"], rtol=1e-4)


def test_tensor_parallel_grouped_trainer_matches_dp(cluster):
    _, params, (r0, _) = cluster
    fit = r0["dp_fit"]
    latent, po = params["pnet"]["last"]["w"].shape
    # the head kernel and its Adam moments really are split over 'model'
    assert fit["tp_head_shape"] == [latent // 2, po] == fit["tp_moment_shape"]
    assert _rel(fit["tp"], fit["dp"]) <= 1e-5
    for k in ("mse", "rel_l2"):
        assert _rel(fit["tp_metrics"][k], fit["dp_metrics"][k]) <= 1e-5


def test_tensor_parallel_pointwise_trainer_with_zero1_matches_dp(cluster):
    _, _, (r0, r1) = cluster
    pw = r0["pointwise"]
    assert _rel(pw["dp"], pw["none"]) <= 1e-5
    assert _rel(pw["tp_zero"], pw["none"]) <= 1e-5
    assert _rel(pw["zero"], pw["none"]) <= 1e-5
    # ZeRO-1: each rank's optimizer holds a share of the parameters, and the
    # shares cover them all
    n = pw["zero_owned"][1]
    assert 0 < pw["zero_owned"][0] < n
    assert pw["zero_owned"][0] + r1["pointwise"]["zero_owned"][0] == n


def test_tensor_parallel_checkpoint_restore(cluster):
    _, params, (r0, _) = cluster
    ck = r0["tp_checkpoint"]
    assert ck["step"][0] == ck["step"][1] == 6
    # the checkpoint holds the unsplit head and moments; the restore cut
    # this rank's rows of both again
    assert ck["saved_head_shape"] == list(params["pnet"]["last"]["w"].shape)
    assert ck["saved_moment_shape"] == ck["saved_head_shape"]
    assert ck["head_equal"] and ck["moments_equal"]
    assert len(ck["continued"]) == 2 and np.all(np.isfinite(ck["continued"]))


def test_meshed_evaluate_sobolev_with_hessian_matches_unmeshed(cluster):
    _, _, (r0, _) = cluster
    ev = r0["evaluation"]
    assert set(ev["none"]["hess"]) == {"value_mse", "jacobian_mse", "hessian_mse", "total"}
    for name in ("mesh", "tp"):
        for form in ("hess", "jac", "metrics"):
            for k, v in ev["none"][form].items():
                assert _rel(ev[name][form][k], v) <= 1e-5, (name, form, k)


def test_full_batch_fit_resident_on_two_ranks_matches_one(cluster):
    _, _, (r0, _) = cluster
    res = r0["resident"]
    assert len(res["none"]) == 3
    assert _rel(res["mesh"], res["none"]) <= 1e-5


@pytest.mark.parametrize("form", ["pointwise", "grouped"])
def test_lbfgs_on_two_ranks_matches_one(cluster, form):
    _, _, (r0, _) = cluster
    lb = r0["lbfgs"]
    assert len(lb["none"][form]) == 4
    assert _rel(lb["mesh"][form], lb["none"][form]) <= 1e-5
    assert lb["mesh"]["counts"]["iterations"] == lb["none"]["counts"]["iterations"]
