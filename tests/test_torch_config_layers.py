"""The port's config, policy, metrics, layers and ParameterNet
(``nif_tpu_torch``) against the JAX package (``nif_tpu``) on the CPU.

Inputs and parameters are made with numpy from a seed and handed to both
packages. f32 layer outputs agree to rtol 1e-5: the same products summed in
a different order."""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nif_tpu
import nif_tpu.config as jcfg
import nif_tpu.layers as jl
import nif_tpu.utils.metrics as jmetrics
import nif_tpu_torch
import nif_tpu_torch.config as tcfg
import nif_tpu_torch.layers as tl
import nif_tpu_torch.utils.metrics as tmetrics
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.models.nif import resolve_device
from nif_tpu_torch.utils.policy import get_policy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("si,so,n,l", [(1, 1, 30, 2), (2, 3, 128, 4), (3, 1, 8, 0)])
@pytest.mark.parametrize("resblock", [False, True])
@pytest.mark.parametrize("connectivity", ["full", "last_layer"])
def test_param_counts_match_jax(si, so, n, l, resblock, connectivity):
    kw = dict(input_dim=si, output_dim=so, units=n, nlayers=l,
              use_resblock=resblock, connectivity=connectivity)
    a, b = tcfg.ShapeNetConfig(**kw), jcfg.ShapeNetConfig(**kw)
    assert tcfg.shapenet_param_count(a, 7) == jcfg.shapenet_param_count(b, 7)
    assert tcfg.shapenet_segment_sizes(a) == jcfg.shapenet_segment_sizes(b)


def test_config_json_round_trip_across_packages(tmp_path):
    kw_s = dict(input_dim=3, output_dim=1, units=128, nlayers=2, activation="sine",
                omega_0=30.0, l2_reg=1e-4)
    kw_p = dict(input_dim=4, latent_dim=128, units=128, nlayers=2, activation="swish",
                act_l2_reg=1e-3)
    mine = tcfg.NIFConfig(tcfg.ShapeNetConfig(**kw_s), tcfg.ParameterNetConfig(**kw_p),
                          "mixed_bfloat16")
    ref = jcfg.NIFConfig(jcfg.ShapeNetConfig(**kw_s), jcfg.ParameterNetConfig(**kw_p),
                         "mixed_bfloat16")
    mine.save(str(tmp_path / "torch.json"))
    ref.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "torch.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert jcfg.NIFConfig.load(str(tmp_path / "torch.json")) == ref
    assert tcfg.NIFConfig.load(str(tmp_path / "jax.json")) == mine
    assert mine.po_dim == ref.po_dim == 33665


def test_config_module_is_a_copy_of_the_jax_one():
    """Same code as nif_tpu/config.py, module docstring aside."""
    def body(path):
        tree = ast.parse(path.read_text())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert body(ROOT / "nif_tpu_torch" / "config.py") == body(ROOT / "nif_tpu" / "config.py")


# ----------------------------------------------------------------- policy, metrics
@pytest.mark.parametrize("name,param,compute", [
    ("float32", torch.float32, torch.float32),
    ("float64", torch.float64, torch.float64),
    ("mixed_bfloat16", torch.float32, torch.bfloat16),
    ("mixed_float16", torch.float32, torch.bfloat16),
])
def test_policy_matches_jax(name, param, compute):
    p, j = get_policy(name), nif_tpu.get_policy(name)
    assert (p.param_dtype, p.compute_dtype) == (param, compute)
    assert str(j.param_dtype) == str(param).split(".")[-1]
    assert str(j.compute_dtype) == str(compute).split(".")[-1]
    assert get_policy(p) is p


def test_policy_unknown_raises():
    with pytest.raises(ValueError, match="unknown mixed_policy"):
        get_policy("int8")


@pytest.mark.parametrize("fn", ["mse", "rmse", "rel_l2"])
def test_metrics_match_jax(fn):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = rng.standard_normal((5, 7)).astype(np.float32)
    _close(getattr(tmetrics, fn)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jmetrics, fn)(a, b))
    if fn == "rel_l2":
        _close(tmetrics.rel_l2(torch.from_numpy(a), torch.from_numpy(b), dim=1),
               jmetrics.rel_l2(a, b, axis=1))


# ----------------------------------------------------------------- layers
def _dense(rng, fi, fo):
    return {"w": rng.standard_normal((fi, fo)).astype(np.float32) * 0.3,
            "b": rng.standard_normal((fo,)).astype(np.float32) * 0.3}


def _both(tree):
    """The same params as torch tensors and as jax arrays."""
    return (jax.tree_util.tree_map(torch.from_numpy, tree),
            jax.tree_util.tree_map(jnp.asarray, tree))


@pytest.mark.parametrize("activation", [None, "linear", "relu", "tanh", "sigmoid", "swish",
                                        "silu", "gelu", "elu", "softplus", "sine"])
def test_dense_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    pt, pj = _both(_dense(rng, 5, 4))
    _close(tl.dense_apply(pt, torch.from_numpy(x), activation),
           jl.dense_apply(pj, jnp.asarray(x), activation))


@pytest.mark.parametrize("block", ["shortcut", "resnet"])
def test_mlp_blocks_match_jax(block):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    if block == "shortcut":
        pt, pj = _both({"dense": _dense(rng, 8, 8)})
        _close(tl.mlp_shortcut_apply(pt, torch.from_numpy(x), "swish"),
               jl.mlp_shortcut_apply(pj, jnp.asarray(x), "swish"))
    else:
        pt, pj = _both({"dense1": _dense(rng, 8, 8), "dense2": _dense(rng, 8, 8)})
        _close(tl.mlp_resnet_apply(pt, torch.from_numpy(x), "tanh"),
               jl.mlp_resnet_apply(pj, jnp.asarray(x), "tanh"))


@pytest.mark.parametrize("position", ["first", "hidden", "bottleneck"])
def test_siren_matches_jax(position):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    pt, pj = _both(_dense(rng, 8, 8))
    _close(tl.siren_apply(pt, torch.from_numpy(x), 30.0, position),
           jl.siren_apply(pj, jnp.asarray(x), 30.0, position), rtol=1e-5, atol=1e-5)


def test_siren_resnet_and_hyper_linear_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    d1, d2 = _dense(rng, 8, 8), _dense(rng, 8, 8)
    pt, pj = _both({"w": d1["w"] / 30, "b": d1["b"], "w2": d2["w"] / 30, "b2": d2["b"]})
    _close(tl.siren_resnet_apply(pt, torch.from_numpy(x), 30.0),
           jl.siren_resnet_apply(pj, jnp.asarray(x), 30.0), rtol=1e-5, atol=1e-5)
    pt, pj = _both(_dense(rng, 8, 40))
    _close(tl.hyper_linear_apply(pt, torch.from_numpy(x)),
           jl.hyper_linear_apply(pj, jnp.asarray(x)))


# ----------------------------------------------------------------- ParameterNet kinds
KINDS = {
    "vanilla": (nif_tpu.NIF, nif_tpu_torch.NIF,
                {"activation": "tanh", "use_resblock": False}),
    "siren": (nif_tpu.NIFMultiScale, nif_tpu_torch.NIFMultiScale,
              {"activation": "sine", "use_resblock": False}),
    "siren_resblock": (nif_tpu.NIFMultiScale, nif_tpu_torch.NIFMultiScale,
                       {"activation": "sine", "use_resblock": True}),
    "mlp_hyper": (nif_tpu.NIFMultiScale, nif_tpu_torch.NIFMultiScale,
                  {"activation": "swish", "use_resblock": False}),
    "mlp_hyper_resnet": (nif_tpu.NIFMultiScale, nif_tpu_torch.NIFMultiScale,
                         {"activation": "swish", "use_resblock": True}),
}


def _kind_pair(kind):
    jcls, tcls, pkw = KINDS[kind]
    cfg_s = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2,
             "activation": "sine" if jcls is nif_tpu.NIFMultiScale else "tanh",
             "omega_0": 10.0, "connectivity": "full", "weight_init_factor": 0.01}
    cfg_p = {"input_dim": 3, "latent_dim": 6, "units": 12, "nlayers": 2,
             "omega_0": 10.0, **pkw}
    jm = jcls(cfg_s, cfg_p)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    tm = from_jax_params(tcls(cfg_s, cfg_p, device="cpu"), params)
    return jm, params, tm


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_parameter_net_matches_jax(kind):
    jm, params, tm = _kind_pair(kind)
    assert tm.pnet_kind == jm.pnet_kind == kind.replace("_resblock", "").replace("_resnet", "")
    t = np.random.default_rng(5).standard_normal((4, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tm.p_to_w(t), jm.p_to_w(params, t), rtol=1e-5, atol=1e-6)
        lat = tm.p_to_lr(t)
        _close(lat, jm.p_to_lr(params, t), rtol=1e-5, atol=1e-6)
        _close(tm.lr_to_w(lat.numpy()), jm.lr_to_w(params, lat.numpy()), rtol=1e-5, atol=1e-6)
    back = to_numpy_params(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


# ----------------------------------------------------------------- init distributions
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_truncated_normal_bounds():
    w = tl.truncated_normal_init(_gen(), (10000,), stddev=0.1).numpy()
    assert np.abs(w).max() <= 0.2 + 1e-6  # truncated at 2 stddev
    assert 0.07 < w.std() < 0.1


def test_siren_first_bounds():
    w, b = tl.siren_first_init(_gen(), 4, 5000)
    assert float(w.abs().max()) <= 1 / 4 + 1e-6
    assert float(b.abs().max()) <= 1 / 2 + 1e-6
    assert float(w.abs().max()) > 0.9 / 4  # fills the range, not a constant


def test_siren_hidden_bounds():
    w, b = tl.siren_hidden_init(_gen(), 64, 2000, omega_0=30.0)
    lim = np.sqrt(6.0 / 64) / 30.0
    assert float(w.abs().max()) <= lim + 1e-7
    assert float(b.abs().max()) <= 1 / 8 + 1e-6


def test_hyper_bias_segment_scales_match_jax():
    kw = dict(num_outputs=100, num_weight_first=10, num_weight_hidden=50,
              num_weight_last=20, input_dim=2, width=16, omega_0=30.0)
    s = tl.hyper_bias_scales(**kw)
    np.testing.assert_array_equal(s, jl.hyper_bias_scales(**kw))
    w, b = tl.hyper_linear_init(_gen(), 8, 100, 0.01, 10, 50, 20, 2, 16, 30.0)
    assert float(w.abs().max()) <= np.sqrt(6 / 8) * 0.01 + 1e-7
    assert np.all(np.abs(b.numpy()) <= s + 1e-7)


def test_siren_resnet_init_ties_second_matmul():
    p = tl.siren_resnet_init(_gen(), 16, 30.0)
    assert torch.equal(p["w"], p["w2"]) and torch.equal(p["b"], p["b2"])
    assert p["w"].data_ptr() != p["w2"].data_ptr()


def test_seeded_init_is_deterministic_and_seed_dependent():
    cfg_s = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
             "activation": "sine"}
    cfg_p = {"input_dim": 1, "latent_dim": 4, "units": 8, "nlayers": 1,
             "activation": "swish"}
    a = to_numpy_params(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, device="cpu", seed=3))
    b = to_numpy_params(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, device="cpu").init(3))
    c = to_numpy_params(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, device="cpu", seed=4))
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    assert not np.array_equal(a["pnet"]["last"]["w"], c["pnet"]["last"]["w"])
    # the SIREN-aware head keeps the generated first-layer weights in range
    assert np.abs(a["pnet"]["last"]["b"][:32]).max() <= 1 / 2 + 1e-6


# ----------------------------------------------------------------- package rules
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "nif_tpu_torch").rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_nif_tpu(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "nif_tpu"), f"{path} imports {name}"


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    cfg_s = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
             "activation": "sine"}
    cfg_p = {"input_dim": 1, "latent_dim": 4, "units": 8, "nlayers": 1,
             "activation": "swish"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p)
    assert resolve_device("cpu") == torch.device("cpu")
