"""L-BFGS on a row-parallel head, and the port's entry points
(``nif_tpu_torch/entry.py``), against the unsplit port model and the JAX
package.

``LBFGS`` and ``GroupedLBFGS`` take a model whose hypernetwork head
``pnet.last.w`` is split over the mesh's ``'model'`` axis: the flat vector
holds the whole head, gathered by ``all_reduce``, and every rank writes its
own rows back. Two gloo clusters on the CPU, two ranks on a (1 x 2) and four
on a (2 x 2) ``('data', 'model')`` mesh, run ``tests/_torch_lbfgs_ranks.py``
(the port only), unchunked and with the chunks split over the data axis.
The unsplit port model and the JAX optimizers run here on the same
JAX-drawn parameters (SIREN-regime head, as in ``test_torch_parallel.py``).

Bounds (float32): loss histories rtol 1e-4, as ``tests/test_optimizers.py``
holds the meshed JAX L-BFGS against the unmeshed; final parameters within
1e-5 of max|p| a leaf; the ranks of a cluster bit for bit equal.
"""
import concurrent.futures
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import nif_tpu
from nif_tpu.optimizers import GroupedLBFGS as JaxGroupedLBFGS
from nif_tpu.optimizers import LBFGS as JaxLBFGS
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.parallel.launch import rank_env, run_ranks

import _torch_lbfgs_ranks as ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = str(REPO / "tests" / "_torch_lbfgs_ranks.py")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
TIMEOUT = 240


def _jax_params():
    """JAX-drawn parameters with a SIREN-regime head (generated weights
    ~0.3 / omega_0), as a flat ``{"pnet/...": array}``."""
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


def _jax_fine_tune(model, params):
    rows, targets, t, x, u = ranks.data()
    out = {}
    for form in ("pointwise", "grouped"):
        if form == "pointwise":
            opt = JaxLBFGS(model, inputs=rows, targets=targets)
        else:
            opt = JaxGroupedLBFGS(model, t, x, u)
        final = opt.minimize(params, max_iter=ranks.ITERS)
        out[form] = {"loss": list(map(float, opt.history["loss"])),
                     "params": _flat(jax.tree_util.tree_map(np.asarray, final))}
    return out


_DRYRUNS = {
    "multichip": "from nif_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4)",
    "multihost": "from nif_tpu_torch.entry import dryrun_multihost; dryrun_multihost(2, 2)",
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two clusters and the two dryruns (their own processes) at once;
    the unsplit port run and the JAX runs here meanwhile."""
    work = tmp_path_factory.mktemp("lbfgs_tp")
    jax_model, params = _jax_params()
    flat = _flat(params)
    np.savez(work / "params.npz", **flat)
    dry = {name: subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=rank_env(),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for name, code in _DRYRUNS.items()}
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = {name: pool.submit(run_ranks, f"{RANKS}:split_head", n_data * n_model,
                                         {"workdir": str(work), "mesh_shape": [n_data, n_model]},
                                         device="cpu", timeout=TIMEOUT)
                       for name, (n_data, n_model) in MESHES.items()}
            torch.set_num_threads(1)
            unsplit = ranks.fine_tune(flat)
            reference = _jax_fine_tune(jax_model, params)
            split = {name: f.result() for name, f in futures.items()}
        logs = {}
        for name, p in dry.items():
            logs[name] = (p.communicate(timeout=TIMEOUT)[0], p.returncode)
    finally:
        for p in dry.values():
            if p.poll() is None:
                p.kill()
    return {"split": split, "unsplit": unsplit, "jax": reference, "dryruns": logs}


def _param_gap(a, b) -> float:
    """max over leaves of max|a - b| / max|b|."""
    gaps = []
    for k in b:
        diff = np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)
        gaps.append(float(np.max(np.abs(diff))) / max(float(np.max(np.abs(b[k]))), 1e-30))
    return max(gaps)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_the_ranks_agree_bit_for_bit_and_hold_their_rows(runs, mesh):
    results = runs["split"][mesh]
    assert len(results) == int(np.prod(MESHES[mesh]))
    for r in results[1:]:
        assert r == results[0]
    n_model = MESHES[mesh][1]
    for chunking in ("whole", "chunked"):
        for form in ("pointwise", "grouped"):
            assert results[0][chunking][form]["head_rows"] == ranks.CFG_P["latent_dim"] // n_model


@pytest.mark.parametrize("form", ["pointwise", "grouped"])
@pytest.mark.parametrize("chunking", ["whole", "chunked"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_split_head_lbfgs_matches_the_unsplit_model(runs, mesh, chunking, form):
    mine = runs["split"][mesh][0][chunking][form]
    ref = runs["unsplit"][form]
    assert len(ref["loss"]) == ranks.ITERS
    assert len(mine["loss"]) == len(ref["loss"])
    assert _rel(mine["loss"], ref["loss"]) <= 1e-4
    assert _param_gap(mine["params"], ref["params"]) <= 1e-5
    assert mine["counts"]["iterations"] == ref["counts"]["iterations"]
    # the split changes no count of the loop's work: host reads included
    assert mine["counts"] == ref["counts"]


@pytest.mark.parametrize("form", ["pointwise", "grouped"])
@pytest.mark.parametrize("mesh", sorted(MESHES) + ["unsplit"])
def test_lbfgs_matches_jax(runs, mesh, form):
    mine = (runs["unsplit"] if mesh == "unsplit" else runs["split"][mesh][0]["whole"])[form]
    ref = runs["jax"][form]
    np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=1e-4)
    assert _param_gap(mine["params"], ref["params"]) <= 1e-5


@pytest.mark.parametrize("name", sorted(_DRYRUNS))
def test_dryruns_finish_and_print_their_ok_lines(runs, name):
    out, rc = runs["dryruns"][name]
    assert rc == 0, out[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith(f"dryrun_{name} OK:")]
    assert line, out[-3000:]
    if name == "multichip":
        assert "(2 data x 2 model) on 4 cpu ranks" in line[0]


def _graft_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry_and_exports():
    from nif_tpu_torch.entry import entry

    jfn, (jparams, jt, jx) = _graft_entry().entry()
    ref = np.asarray(jfn(jparams, jt, jx), np.float32)
    fn, args = entry("cpu")
    from_jax_params(fn.model, jax.tree_util.tree_map(np.asarray, jparams))
    np.testing.assert_array_equal(args[0].numpy(), jt)
    np.testing.assert_array_equal(args[1].numpy(), jx)
    with torch.no_grad():
        out = fn(*args)
    assert tuple(out.shape) == ref.shape == (4, 64, 1) and out.dtype == torch.float32
    err = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
    assert err <= 1e-2, err  # the mixed_bfloat16 policy: bf16 rounding in another order
    program = torch.export.export(fn, args)
    with torch.no_grad():
        exported = program.module()(*args)
    torch.testing.assert_close(exported, out, rtol=0, atol=0)
