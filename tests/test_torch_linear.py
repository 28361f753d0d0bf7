"""The port's NIF-linear (``NIFMultiScaleLastLayerParameterized``) against the
JAX package on the CPU: its parameters, forward and serving paths, plain K4
(``niflinear_mse_grads``) against the Pallas kernel in interpret mode,
``mse_value_and_grad`` (every leaf, the trunk's included, with and without
regularization), the derivatives and Sobolev/Hessian gradients through the
effective generated chain, ``GroupedTrainer`` and its checkpoints, and
``predict_shared_mesh`` (float32 and int8).

The JAX model draws the parameters; they cross to the port as numpy arrays
(``from_jax_params``), and both packages get the same numpy inputs. On the
CPU the JAX package's fused paths run its Pallas kernels in interpret mode.
Tolerances:

* plain K4, float32: loss rel 1e-5 and every gradient normalized by its
  max|ref| atol 5e-5 (the JAX package's bound for its fused NIF-linear
  kernel, ``tests/test_pallas_kernel.py``: the trunk grads sum over every
  group). bfloat16: loss rel 2e-3 and max|d| <= 2^-6 max|ref| (two bf16 ulps
  at the top of the range: an f32 last-bit difference can flip one bf16
  rounding of an activation, derivative or dz).
* The model paths (float32): outputs and losses rel 1e-5 / normalized atol
  1e-5; gradients per leaf normalized by its largest entry atol 5e-5 (the
  same bound); derivatives normalized atol 5e-5; per-epoch training losses
  rtol 1e-4 (Adam carries a last-bit difference on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nif_tpu
import nif_tpu.config as jcfg
import nif_tpu.ops.pallas_shapenet as jps
from nif_tpu.ops import derivatives as jd
from nif_tpu.serving import predict_shared_mesh as jax_predict_shared_mesh
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
import nif_tpu_torch
import nif_tpu_torch.config as tcfg
from nif_tpu_torch.compression import quantize_shared_mesh
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import derivatives as td
from nif_tpu_torch.ops import fused_linear as fl
from nif_tpu_torch.serving import predict_grouped, predict_shared_mesh
from nif_tpu_torch.training import CheckpointCallback, Checkpointer, GroupedTrainer

torch.set_num_threads(1)

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "sine",
         "use_resblock": False, "omega_0": 5.0, "connectivity": "last_layer",
         "weight_init_factor": 1.0}
CFG_P = {"input_dim": 1, "latent_dim": 8, "units": 16, "nlayers": 1, "activation": "swish",
         "use_resblock": False, "omega_0": 5.0}
G, P = 3, 64


def _models(cfg_s=None, cfg_p=None, policy="float32", seed=0):
    cfg_s = {**CFG_S, **(cfg_s or {})}
    cfg_p = {**CFG_P, **(cfg_p or {})}
    jm = nif_tpu.NIFMultiScaleLastLayerParameterized(cfg_s, cfg_p, mixed_policy=policy)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(cfg_s, cfg_p, mixed_policy=policy,
                                                           device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _batch(si=2, so=1, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, 1)).astype(np.float32),
            rng.uniform(-1, 1, (G, P, si)).astype(np.float32),
            rng.standard_normal((G, P, so)).astype(np.float32),
            rng.uniform(0.5, 1.5, (G, P)).astype(np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(mine, ref, atol=1e-5):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(mine / scale, ref / scale, atol=atol)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree)


def _trees_close(mine, ref, atol=5e-5):
    """Every leaf within ``atol`` of the reference, normalized by the
    reference leaf's largest entry; both trees have the same keys."""
    mine, ref = _np_tree(mine), _np_tree(ref)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref)
    jax.tree_util.tree_map(lambda a, b: _close(a, b, atol), mine, ref)


# ------------------------------------------------------- params and convert
@pytest.mark.parametrize("resblock", [False, True], ids=["plain", "resblock"])
def test_params_match_jax_init_and_convert_round_trips(resblock):
    jm, params, tm = _models({"use_resblock": resblock})
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert set(tree) == {"pnet", "snet"}
    mine = to_numpy_params(tm)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, tree)
    # the port's own draw has JAX's shapes; the resblock's second matrix
    # starts equal to its first, as in the JAX package
    own = to_numpy_params(nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
        {**CFG_S, "use_resblock": resblock}, CFG_P, device="cpu", seed=3))
    jax.tree_util.tree_map(lambda a, b: a.shape == b.shape or pytest.fail("shape"), own, tree)
    if resblock:
        np.testing.assert_array_equal(own["snet"]["hidden_0"]["w"], own["snet"]["hidden_0"]["w2"])
    assert tm.po_dim == jm.po_dim == 8 and own["snet"]["bias"].shape == (1,)
    assert np.abs(own["snet"]["bias"]).max() <= 0.2  # TruncatedNormal(0.1) cut at 2 sigma
    with pytest.raises(KeyError, match="snet"):
        from_jax_params(tm, {"pnet": tree["pnet"]})
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["snet"]["bias"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="snet/bias"):
        from_jax_params(tm, bad)


def test_construction_and_subnetworks():
    jm, params, tm = _models()
    with pytest.raises(ValueError, match="last_layer"):
        nif_tpu_torch.NIFMultiScaleLastLayerParameterized({**CFG_S, "connectivity": "full"},
                                                          CFG_P, device="cpu")
    t, x, *_ = _batch()
    with torch.no_grad():
        a = tm.p_to_lr(t)
        _close(a, jm.p_to_lr(params, t))
        _close(tm.p_to_w(t), a)
        rows = np.repeat(a.numpy(), P, axis=0)
        _close(tm.x_to_u_given_w(x.reshape(-1, 2), rows),
               jm.x_to_u_given_w(x.reshape(-1, 2), rows, params=params))
    with pytest.raises(ValueError, match="same as `lr`"):
        tm.lr_to_w(a)


# ------------------------------------------------------------ forward paths
@pytest.mark.parametrize("so,resblock", [(1, False), (2, True)], ids=["so1", "so2-res"])
def test_forward_paths_match_jax(so, resblock):
    """x_to_phi, apply, apply_grouped (eager and through plain K1, against
    the Pallas kernel in interpret mode) and apply_shared_mesh."""
    jm, params, tm = _models({"output_dim": so, "use_resblock": resblock})
    t, x, *_ = _batch(so=so)
    rows = np.concatenate([np.repeat(t, P, 0), x.reshape(G * P, 2)], 1)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        phi = tm.x_to_phi(x)
        assert tuple(phi.shape) == (G, P, so, 8)
        _close(phi, jm.x_to_phi(params, x))
        _close(tm.x_to_phi(x[0], fused=True), jm.x_to_phi(params, x[0], fused=True))
        u, lat = tm.apply(rows, return_latent=True)
        u_ref, lat_ref = jm.apply(params, rows, return_latent=True)
        _close(u, u_ref)
        _close(lat, lat_ref)
        for fused in (None, False, True):
            out = tm.apply_grouped(t, x, fused=fused)
            assert out.dtype == torch.float32 and tuple(out.shape) == (G, P, so)
            _close(out, jm.apply_grouped(params, t, x, fused=fused))
        _close(tm.apply_shared_mesh(t, x[0]), jm.apply_shared_mesh(params, t, x[0]))
    assert _build.LAUNCHES == before  # the CPU runs plain K1


def test_apply_grouped_fused_is_differentiable_through_plain_k3():
    """apply_grouped(fused=True) under autograd: plain K1 forward, plain K3
    backward (the trunk's weights broadcast to every group), against eager
    autograd for every leaf, the trunk's included."""
    _, _, tm = _models()
    t, x, *_ = _batch()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((G, P, 1)).astype(np.float32))
    params = [p for _, p in tm.param_items()]
    fused = torch.autograd.grad(tm.apply_grouped(t, x, fused=True), params, g)
    eager = torch.autograd.grad(tm.apply_grouped(t, x, fused=False), params, g)
    _trees_close(tm._grad_tree(fused), tm._grad_tree(eager))


# --------------------------------------------------------------- plain K4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("so,resblock,weighted", [(1, False, False), (2, False, True),
                                                  (1, True, False), (3, True, True)],
                         ids=["so1", "so2-weighted", "so1-res", "so3-res-weighted"])
def test_k4_plain_matches_pallas_interpret(so, resblock, weighted, dtype):
    """The JAX K4 test's grid: trunk width 16, two hidden layers, K=8."""
    si, K, n, om = 2, 8, 16, 5.0
    n_mats = 4 if resblock else 2
    rng = np.random.default_rng(7)
    w_shapes = [(si, n)] + [(n, n)] * n_mats + [(n, so * K)]
    b_shapes = [(n,)] * (n_mats + 1) + [(so * K,)]
    ws = [(rng.standard_normal(s) * 0.3 / om).astype(np.float32) for s in w_shapes]
    bs = [(rng.standard_normal(s) * 0.3 / om).astype(np.float32) for s in b_shapes]
    a = (rng.standard_normal((G, K)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(so) * 0.1).astype(np.float32)
    x = rng.standard_normal((G, P, si)).astype(np.float32)
    tgt = rng.standard_normal((G, P, so)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (G, P)).astype(np.float32) if weighted else None
    args = (si, so * K, n, 2, "sine", resblock, om)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    T = lambda v: torch.from_numpy(v).to(tdt)  # noqa: E731
    J = lambda v: jnp.asarray(v, jdt)  # noqa: E731
    before = dict(_build.LAUNCHES)
    mine = fl.niflinear_mse_grads(
        [T(v) for v in ws], [T(v) for v in bs], T(a), T(bias), T(x), torch.from_numpy(tgt),
        tcfg.ShapeNetConfig(*args), so, None if w is None else torch.from_numpy(w))
    ref = jps.niflinear_mse_grads(
        [J(v) for v in ws], [J(v) for v in bs], J(a), J(bias), J(x), jnp.asarray(tgt),
        jcfg.ShapeNetConfig(*args), so, None if w is None else jnp.asarray(w), True)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    l_rel = 1e-5 if dtype == "float32" else 2e-3
    assert mine[0].dtype == torch.float32
    assert float(mine[0]) == pytest.approx(float(ref[0]), rel=l_rel)
    flat = lambda r: [*r[1], *r[2], r[3], r[4]]  # noqa: E731
    for m, r in zip(flat(mine), flat(ref)):
        assert m.dtype == torch.float32
        if dtype == "float32":
            _close(m, r, atol=5e-5)
        else:
            assert np.abs(_np(m) - _np(r)).max() <= 2.0 ** -6 * np.abs(_np(r)).max()


def test_gate_matches_jax():
    """The JAX package's reasons, including the point-tile rule at P = 77."""
    jm, _, tm = _models()
    assert "point tile" in tm.fast_path_info(77)["reason"]
    assert tm.fast_path_info(77)["reason"] == jm.fast_path_info(77)["reason"]
    assert tm.fast_path_info(64) == {"path": "eager", "tile": None,
                                     "reason": "not on CUDA (device 'cpu')"}
    for so, K, n, P_ in [(9, 8, 16, 64), (1, 8, 4, 64), (2, 8, 16, 100), (1, 8, 16, 256)]:
        args = (2, so * K, n, 2, "sine", False, 5.0)
        assert (fl.linear_fused_unsupported_reason(tcfg.ShapeNetConfig(*args), so, P_)
                == jps.linear_fused_unsupported_reason(jcfg.ShapeNetConfig(*args), so, P_))
    with pytest.raises(ValueError, match="CUDA"):
        fl.niflinear_mse_grads_cuda([torch.zeros(2, 16), torch.zeros(16, 8)],
                                    [torch.zeros(16), torch.zeros(8)], torch.zeros(G, 8),
                                    torch.zeros(1), torch.zeros(G, P, 2), torch.zeros(G, P, 1),
                                    tcfg.ShapeNetConfig(2, 8, 16, 0, "sine"), 1)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tc"), (torch.float32, "simt")],
                         ids=["bf16", "f32"])
def test_k4_variant_and_gate_per_dtype(dtype, variant):
    """bf16 K4 runs the tensor-core kernel, f32 the CUDA-core one; off the
    card the gate's reasons for either dtype are the JAX package's, byte for
    byte."""
    assert fl.k4_variant(dtype) == variant
    for so, K, n, P_ in [(9, 8, 16, 64), (1, 8, 4, 64), (2, 8, 16, 100), (1, 8, 16, 256),
                         (3, 8, 16, 64)]:
        args = (2, so * K, n, 2, "sine", False, 5.0)
        mine = fl.linear_fused_unsupported_reason(tcfg.ShapeNetConfig(*args), so, P_, "cpu",
                                                  dtype)
        assert mine == jps.linear_fused_unsupported_reason(jcfg.ShapeNetConfig(*args), so, P_)
    assert fl.linear_fused_supported(tcfg.ShapeNetConfig(2, 8, 16, 2, "sine"), 1, 64, None,
                                     dtype)


@pytest.mark.parametrize("tc_status,variant", [(0, "tc"), (2, "simt")],
                         ids=["tc-takes-it", "tc-refuses"])
def test_k4_variant_asks_the_tensor_core_library_for_bf16_trunks_only(tc_status, variant,
                                                                      monkeypatch):
    """Given a trunk, float32 runs the CUDA-core K4 without asking any
    kernel library; bfloat16 asks the tensor-core K4's geometry and runs
    the CUDA-core K4 where it refuses the trunk (a width beyond its shared
    memory), so such a trunk trains on a fused kernel, not eager."""
    from nif_tpu_torch.ops import _build

    trunk = tcfg.ShapeNetConfig(3, 128, 288, 2, "sine", False, 30.0)
    asked = []

    def no_library(name):
        raise AssertionError(f"asked the {name} library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert fl.k4_variant(torch.float32, trunk, 1) == "simt"
    assert fl.k4_variant(torch.bfloat16) == "tc"
    monkeypatch.setattr(fl, "_tc_status",
                        lambda cfg, so, G, P: asked.append((cfg, so)) or (tc_status, {}))
    assert fl.k4_variant(torch.bfloat16, trunk, 1) == variant
    assert asked == [(trunk, 1)]


# ------------------------------------------------------- mse_value_and_grad
@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K4"])
@pytest.mark.parametrize("so,resblock,weighted", [(1, False, False), (2, True, True)],
                         ids=["so1", "so2-res-weighted"])
def test_mse_value_and_grad_matches_jax(so, resblock, weighted, fused):
    jm, params, tm = _models({"output_dim": so, "use_resblock": resblock})
    t, x, u, w = _batch(so=so)
    w = w if weighted else None
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=fused)
    loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=fused)
    assert loss.dim() == 0 and not loss.requires_grad
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    assert set(grads["snet"]) == {"first", "hidden_0", "hidden_1", "bottleneck", "bias"}
    _trees_close(grads, g_ref)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K4"])
def test_regularized_mse_value_and_grad_matches_jax(fused):
    """The JAX K4 test's regularized config (trunk l2_reg, ParameterNet
    act_l2_reg) plus a ParameterNet l2_reg: the ParameterNet's coefficient
    charges only the ParameterNet and the trunk's only the trunk."""
    jm, params, tm = _models({"nlayers": 1, "l2_reg": 1e-3},
                             {"act_l2_reg": 1e-3, "l2_reg": 1e-2})
    t, x, u, _ = _batch(seed=1)
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, fused=fused)
    loss, grads = tm.mse_value_and_grad(t, x, u, fused=fused)
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    _trees_close(grads, g_ref)
    for parts in ("params", "batch", "all"):
        assert float(tm.regularization_loss(t=t, parts=parts).detach()) == pytest.approx(
            float(jm.regularization_loss(params, t=t, parts=parts)), rel=1e-5)
    assert tm.has_regularization
    _, _, plain = _models()
    assert not plain.has_regularization


def test_mse_value_and_grad_bf16_fused_matches_jax():
    """mixed_bfloat16: plain K4 against the Pallas kernel in interpret mode
    behind the same bf16 ParameterNet. Loss rel 2e-3; each gradient leaf
    within 2e-2 relative L2 (as the MSE path's bf16 test: the bf16
    ParameterNet rounds its outputs in both packages, in other orders)."""
    jm, params, tm = _models(policy="mixed_bfloat16")
    t, x, u, w = _batch()
    l_ref, g_ref = jm.mse_value_and_grad(params, t, x, u, weight=w, fused=True)
    loss, grads = tm.mse_value_and_grad(t, x, u, weight=w, fused=True)
    assert float(loss) == pytest.approx(float(l_ref), rel=2e-3)

    def check(a, b):
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b) + 1e-12
    jax.tree_util.tree_map(check, _np_tree(grads), _np_tree(g_ref))


# --------------------------------------------- the effective generated chain
def test_effective_chain_derivatives_match_jax():
    """(y, jac) and (y, jac, hess): eager jacfwd through the trunk, and plain
    K5/K7 on the effective chain, against the JAX package's eager path."""
    jm, params, tm = _models({"use_resblock": True})
    t, x, *_ = _batch()
    y_ref, j_ref = jd.output_and_jacobian_grouped(jm, params, t, x, fused=False)
    _, _, h_ref = jd.output_jacobian_hessian_grouped(jm, params, t, x, fused=False)
    wb_eff, cfg_eff = tm._fwd_jac_effective_chain(t)
    wb_ref, _ = jm._fwd_jac_effective_chain(params, t)
    _close(wb_eff, wb_ref)
    assert cfg_eff.output_dim == 1 and tm._derivative_kernel_cfg() == (cfg_eff, "siren")
    before = dict(_build.LAUNCHES)
    for fused in (False, True):
        y, jac = td.output_and_jacobian_grouped(tm, t, x, fused=fused)
        assert tuple(jac.shape) == (G, P, 1, 2)
        _close(y, y_ref, atol=5e-5)
        _close(jac, j_ref, atol=5e-5)
        y, jac, hess = td.output_jacobian_hessian_grouped(tm, t, x, fused=fused)
        assert tuple(hess.shape) == (G, P, 1, 2, 2)
        _close(jac, j_ref, atol=5e-5)
        _close(hess, h_ref, atol=5e-5)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K6"])
def test_sobolev_value_and_grad_matches_jax(fused):
    """Jacobian targets: the gradient reaches the trunk and the ParameterNet
    through the effective chain (plain K6) or eager autograd."""
    jm, params, tm = _models()
    t, x, u, w = _batch()
    ju = np.random.default_rng(8).standard_normal((G, P, 1, 2)).astype(np.float32)
    kw = dict(target_jac=ju, w_jac=0.5, weight=w, fused=fused)
    total, terms, grads = tm.sobolev_value_and_grad(t, x, u, **kw)
    ref, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, **kw)
    assert float(total) == pytest.approx(float(ref), rel=1e-5)
    for k in ("value_mse", "jacobian_mse"):
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=1e-5)
    _trees_close(grads, g_ref)


def test_sobolev_value_and_grad_hessian_matches_jax():
    """Hessian targets through plain K8 on the effective chain, against the
    JAX package's eager gradient."""
    jm, params, tm = _models()
    t, x, u, _ = _batch()
    rng = np.random.default_rng(9)
    ju = rng.standard_normal((G, P, 1, 2)).astype(np.float32)
    hu = rng.standard_normal((G, P, 1, 2, 2)).astype(np.float32)
    kw = dict(target_jac=ju, target_hess=hu, w_jac=0.1, w_hess=0.01)
    total, terms, grads = tm.sobolev_value_and_grad(t, x, u, fused=True, **kw)
    ref, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, fused=False, **kw)
    assert float(total) == pytest.approx(float(ref), rel=1e-5)
    for k in ("value_mse", "jacobian_mse", "hessian_mse"):
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=1e-5)
    _trees_close(grads, g_ref)


# ----------------------------------------------------------- GroupedTrainer
def _wave(G_=5, P_=64, seed=7):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G_, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G_, P_, 2)).astype(np.float32)
    u = (np.sin(np.pi * x[..., :1] + t[:, None, :]) * np.cos(x[..., 1:])).astype(np.float32)
    return t, x, u


@pytest.mark.parametrize("fused", [None, True], ids=["auto", "plain-K4"])
def test_grouped_fit_matches_jax(fused):
    """Three epochs, a tail batch of 1 group padded to 2, 32 of 64 points a
    step: the same batches (one numpy seed) and Adam in both packages, the
    trunk trained with the ParameterNet."""
    t, x, u = _wave()
    jm, _, tm = _models()
    jt = JaxGroupedTrainer(jm, optax.adam(1e-3), seed=3, fused=fused)
    js = jt.init(jax.random.key(1))
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=1e-3), seed=3, fused=fused)
    ts = tt.init(1)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    kw = dict(epochs=3, group_batch=2, point_batch=32)
    js = jt.fit(js, t, x, u, **kw)
    ts = tt.fit(ts, t, x, u, **kw)
    assert ts.step == js.step == 9
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    assert tt.history["path"] == "eager" and "not on CUDA" in tt.history["path_reason"]
    _trees_close(to_numpy_params(tm), jax.tree_util.tree_map(np.asarray, js.params), atol=1e-4)
    assert tt.evaluate(ts, t, x, u) == pytest.approx(jt.evaluate(js, t, x, u), rel=1e-4)


def test_checkpoint_round_trip_carries_the_trunk(tmp_path):
    """The train state holds the trunk beside the ParameterNet: a checkpoint
    of a NIF-linear state restores every leaf into a fresh model."""
    t, x, u = _wave()
    _, _, tm = _models()
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=1e-3), seed=0)
    ts = tt.init(1)
    assert set(ts.params) == {"pnet", "snet"}
    ts = tt.fit(ts, t, x, u, epochs=2, group_batch=5,
                callbacks=[CheckpointCallback(str(tmp_path), every=1)])
    payload = Checkpointer(str(tmp_path)).restore()
    assert payload["step"] == 2 and any(k.startswith("snet.") for k in payload["params"])
    fresh = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(CFG_S, CFG_P, device="cpu",
                                                              seed=9)
    state = GroupedTrainer(fresh, lambda p: torch.optim.Adam(p, lr=1e-3)).init(9)
    state.params.load_state_dict(payload["params"])
    state.opt_state.load_state_dict(payload["opt_state"])
    saved, restored = to_numpy_params(tm), to_numpy_params(fresh)
    assert jax.tree_util.tree_structure(saved) == jax.tree_util.tree_structure(restored)
    jax.tree_util.tree_map(np.testing.assert_array_equal, restored, saved)


# -------------------------------------------------------------- serving
def test_predict_shared_mesh_and_grouped_match_jax():
    """Ragged P (100, padded to 128) and G=5 in chunks of 2 (the last one
    padded), against the JAX package's serving functions."""
    jm, params, tm = _models({"output_dim": 2})
    rng = np.random.default_rng(4)
    t = rng.standard_normal((5, 1)).astype(np.float32)
    xm = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    out = predict_shared_mesh(tm, t, xm, group_batch=2, point_pad=128)
    ref = jax_predict_shared_mesh(jm, params, t, xm, group_batch=2, point_pad=128)
    assert out.shape == ref.shape == (5, 100, 2) and out.dtype == np.float32
    _close(out, ref)
    grouped = predict_grouped(tm, t, np.broadcast_to(xm, (5, 100, 2)), group_batch=2)
    _close(grouped, out)
    assert predict_shared_mesh(tm, t[:0], xm).shape == (0, 100, 2)
    # the int8 decode (tests/test_serving.py:178-184): within 0.05 of max of float32
    i8 = predict_shared_mesh(tm, t, xm, group_batch=2, int8_pack=quantize_shared_mesh(tm, xm))
    assert i8.shape == out.shape and i8.dtype == np.float32
    assert np.max(np.abs(i8 - out)) / max(np.max(np.abs(out)), 1e-6) < 0.05
    with pytest.raises(ValueError, match=r"\[P, si\]"):
        predict_shared_mesh(tm, t, xm[None])
    plain = nif_tpu_torch.NIFMultiScale({**CFG_S, "connectivity": "full"}, CFG_P, device="cpu")
    with pytest.raises(TypeError, match="apply_shared_mesh"):
        predict_shared_mesh(plain, t, xm)
