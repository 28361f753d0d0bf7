"""The port's optimizers against the JAX package's on the CPU.

First-order optimizers (``adam``, the three AdaBelief forms, ``lion``,
centralized ``adam``, a scheduled ``adabelief``): fed the same 20
numpy-seeded gradients, they give the same parameters as their optax
counterparts, within 1e-6 relative in float32 and 1e-12 in float64 (optax
under ``jax.enable_x64``). The one exception is ``adam`` in float32, which is
``torch.optim.Adam``: it computes its bias corrections in float64, optax in
float32, where ``1 - float32(0.999)`` is 1.3e-5 off ``1 - 0.999``, so each
update differs by up to 6.5e-6 relative; over 20 steps at lr 1e-2 that
allows 20 * 1e-2 * 1e-5 = 2e-6 absolute beside the 1e-6 relative (the
observed drift is 6e-7). The schedule's values equal optax's.

L-BFGS: ``lbfgs_minimize`` gives JAX's loss history (float64, first 5
iterations, 1e-8 relative, and 1e-8 of the first loss for a loss at
roundoff) and converges as ``tests/test_optimizers.py``
asserts; resume, float64 against float32 and the state guard behave as
there. ``LBFGS._objective`` and ``GroupedLBFGS._objective`` give the value
and gradient of JAX's ``jax.value_and_grad(opt._objective)`` at the same
parameters (float32: value rel 1e-5, gradients normalized by each leaf's
largest entry atol 1e-5; float64 models under the float64 policy: 1e-12),
and the grouped objective's fused path (the plain K2/K4/K6/K8 on the CPU)
equals its eager one. Every refusal message equals JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu import optimizers as jopt
import nif_tpu_torch
from nif_tpu_torch import optimizers as topt
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.data import prefetch_to_device
from nif_tpu_torch.optimizers import GroupedLBFGS, LBFGS, cast_parameters, lbfgs_minimize

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, 1e-6), "float64": (np.float64, torch.float64, 1e-12)}


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


# ------------------------------------------------------------ first order
# (name, port factory, JAX transformation)
# torch.optim.Adam's float64 bias corrections against optax's float32 ones
# (module docstring): the absolute drift 20 steps at lr 1e-2 allow
ADAM_F32_ATOL = 20 * 1e-2 * 1e-5
FIRST_ORDER = [
    ("adam", lambda: topt.adam(1e-2), lambda: jopt.adam(1e-2)),
    ("adabelief", lambda: topt.adabelief(1e-2), lambda: jopt.adabelief(1e-2)),
    ("adabelief_wd", lambda: topt.adabelief(1e-2, weight_decay=1e-2),
     lambda: jopt.adabelief(1e-2, weight_decay=1e-2)),
] + [
    (f"adabelief_full_r{int(r)}_a{int(a)}",
     lambda r=r, a=a: topt.adabelief_full(1e-2, weight_decay=1e-2, rectify=r, amsgrad=a),
     lambda r=r, a=a: jopt.adabelief_full(1e-2, weight_decay=1e-2, rectify=r, amsgrad=a))
    for r in (False, True) for a in (False, True)
] + [
    ("lion_wd", lambda: topt.lion(1e-3, weight_decay=1e-2),
     lambda: jopt.lion(1e-3, weight_decay=1e-2)),
    ("centralized_adam", lambda: topt.centralize_gradients(topt.adam(1e-2)),
     lambda: optax.chain(jopt.centralize_gradients(), jopt.adam(1e-2))),
    ("adabelief_scheduled",
     lambda: topt.adabelief(1e-2, total_steps=16, warmup_proportion=0.25, min_lr=1e-4),
     lambda: jopt.adabelief(1e-2, total_steps=16, warmup_proportion=0.25, min_lr=1e-4)),
]


def _first_order_run(make_port, make_jax, dtype, steps=20):
    npd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 3)).astype(npd),
          "b": rng.standard_normal(3).astype(npd)}
    grads = [{k: rng.standard_normal(v.shape).astype(npd) for k, v in p0.items()}
             for _ in range(steps)]
    with _x64(dtype):
        tx = make_jax()
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
            params = optax.apply_updates(params, upd)
        ref = {k: np.asarray(v) for k, v in params.items()}
    mine = {k: torch.nn.Parameter(torch.tensor(v, dtype=td)) for k, v in p0.items()}
    opt = make_port()([mine["w"], mine["b"]])
    for g in grads:
        for k, p in mine.items():
            p.grad = torch.tensor(g[k], dtype=td)
        opt.step()
    return {k: p.detach().numpy() for k, p in mine.items()}, ref, p0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,make_port,make_jax", FIRST_ORDER, ids=[c[0] for c in FIRST_ORDER])
def test_first_order_matches_optax(name, make_port, make_jax, dtype):
    mine, ref, p0 = _first_order_run(make_port, make_jax, dtype)
    rtol = DTYPES[dtype][2]
    atol = ADAM_F32_ATOL if dtype == "float32" and "adam" in name else 0.0
    for k in ref:
        assert mine[k].dtype == ref[k].dtype == p0[k].dtype
        assert not np.allclose(ref[k], p0[k])
        np.testing.assert_allclose(mine[k], ref[k], rtol=rtol, atol=atol)


def test_rectified_adabelief_passes_its_gate_in_twenty_steps():
    """Twenty steps take the rectified form past sma_t >= 5, so the tests
    above exercise both of its branches."""
    b2 = 0.999
    sma_inf = 2.0 / (1 - b2) - 1.0
    sma = [sma_inf - 2.0 * t * b2 ** t / (1 - b2 ** t) for t in range(1, 21)]
    assert sma[0] < 5.0 <= sma[-1]


@pytest.mark.parametrize("args", [(1e-3, 100, 0.2, 1e-5), (1e-2, 16, 0.25, 1e-4),
                                  (3e-4, 7, 0.1, 0.0)])
def test_warmup_linear_decay_equals_optax(args):
    mine, ref = topt.warmup_linear_decay(*args), jopt.warmup_linear_decay(*args)
    for step in range(0, args[1] + 10):
        value = mine(step)
        assert isinstance(value, float)
        assert np.float32(value) == np.asarray(ref(step)), step


def test_schedule_is_read_at_the_optimizers_own_count():
    """Update k runs at schedule(k): the first warmed-up update has lr 0,
    and the count is saved with the optimizer's state."""
    sched = topt.warmup_linear_decay(1.0, 10, 0.5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.lion(sched)([p])
    seen = []
    for _ in range(4):
        p.grad = torch.ones(3)
        opt.step()
        seen.append(opt.param_groups[0]["lr"])
    assert seen == [sched(k) for k in range(4)] and seen[0] == 0.0
    assert opt.state_dict()["param_groups"][0]["schedule_count"] == 4


def test_centralize_gradients_like_jax():
    """tests/test_optimizers.py's case: rank-2 gradients centred to zero,
    rank-1 untouched."""
    w = torch.nn.Parameter(torch.ones(3, 4))
    b = torch.nn.Parameter(torch.ones(4))
    opt = topt.centralize_gradients(lambda ps: torch.optim.SGD(ps, lr=1.0))([w, b])
    w.grad, b.grad = torch.full((3, 4), 2.0), torch.full((4,), 2.0)
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), 1.0, atol=1e-7)
    np.testing.assert_allclose(b.detach().numpy(), -1.0, atol=1e-7)


def test_get_optimizer_and_its_refusal():
    params = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(topt.get_optimizer("adam", 1e-3)(params), torch.optim.Adam)
    assert isinstance(topt.get_optimizer("AdaBelief", 1e-3)(params), topt.AdaBelief)
    assert isinstance(topt.get_optimizer("lion", 1e-3)(params), topt.Lion)
    with pytest.raises(ValueError) as mine:
        topt.get_optimizer("sgd")
    with pytest.raises(ValueError) as ref:
        jopt.get_optimizer("sgd")
    assert str(mine.value) == str(ref.value)


# ------------------------------------------------------------ lbfgs_minimize
def _quad_j(p):
    return jnp.sum((p - jnp.arange(5.0)) ** 2)


def _quad_t(p):
    return torch.sum((p - torch.arange(5.0, dtype=p.dtype)) ** 2)


def _rosen(p):
    return (1 - p["x"]) ** 2 + 100 * (p["y"] - p["x"] ** 2) ** 2


def _ill(p):
    x = p["x"]
    return (x[0] - 1.0) ** 2 + 1e4 * (x[1] - x[0] ** 2) ** 2


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_lbfgs_minimize_history_matches_jax_float64(problem):
    if problem == "quadratic":
        _, ref = jopt.lbfgs_minimize(_quad_j, jnp.zeros(5), max_iter=100, dtype="float64")
        p, mine = lbfgs_minimize(_quad_t, torch.zeros(5), max_iter=100, dtype="float64")
        assert p.dtype == torch.float64
    else:
        _, ref = jopt.lbfgs_minimize(_rosen, {"x": jnp.float32(-1.2), "y": jnp.float32(1.0)},
                                     max_iter=300, dtype="float64")
        p, mine = lbfgs_minimize(_rosen, {"x": torch.tensor(-1.2), "y": torch.tensor(1.0)},
                                 max_iter=300, dtype="float64")
        assert p["x"].dtype == torch.float64
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine[:5], ref[:5], rtol=1e-8, atol=1e-8 * ref[0])


def test_lbfgs_minimize_converges_like_the_jax_tests():
    p, losses = lbfgs_minimize(_quad_t, torch.zeros(5), max_iter=100)
    assert float(_quad_t(p)) < 1e-10 and losses[0] > losses[-1]
    assert len(losses) >= 1 and np.all(np.isfinite(losses))
    p, _ = lbfgs_minimize(_rosen, {"x": torch.tensor(-1.2), "y": torch.tensor(1.0)},
                          max_iter=300)
    assert float(_rosen(p)) < 1e-6


def test_lbfgs_resume_continues():
    """Two 25-iteration calls, the second resumed from the first's state,
    are the 50-iteration run: the same losses and the same point."""
    p0 = {"x": torch.tensor(-1.2), "y": torch.tensor(1.0)}
    p_a, l_a, st = lbfgs_minimize(_rosen, p0, max_iter=25, return_state=True, dtype="float64")
    p_a2, l_a2 = lbfgs_minimize(_rosen, p_a, max_iter=25, opt_state=st, dtype="float64")
    p_b, l_b = lbfgs_minimize(_rosen, p0, max_iter=50, dtype="float64")
    np.testing.assert_array_equal(np.concatenate([l_a, l_a2]), l_b)
    assert float(p_a2["x"]) == float(p_b["x"]) and float(p_a2["y"]) == float(p_b["y"])
    assert st.iterations == 50 and st.evaluations >= 50 and st.host_reads > st.evaluations
    p, _ = lbfgs_minimize(_quad_t, torch.zeros(5), max_iter=25)
    assert float(_quad_t(p)) < 1e-8


def test_lbfgs_float64_beats_f32_on_ill_conditioned():
    p0 = {"x": torch.zeros(2)}
    _, l32 = lbfgs_minimize(_ill, p0, max_iter=300)
    p64, l64 = lbfgs_minimize(_ill, p0, max_iter=300, dtype="float64")
    assert p64["x"].dtype == torch.float64
    assert l64[-1] < 1e-15
    assert l64[-1] < l32[-1] * 1e-3


def test_lbfgs_restores_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []

        def loss(p):
            seen.append(torch.get_float32_matmul_precision())
            return _quad_t(p)

        lbfgs_minimize(loss, torch.zeros(5), max_iter=3)
        assert set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


# ------------------------------------------------------------ point-wise LBFGS
PW_S = {"input_dim": 1, "output_dim": 1, "units": 8, "nlayers": 1, "activation": "tanh"}
PW_P = {"input_dim": 1, "latent_dim": 2, "units": 8, "nlayers": 1, "activation": "tanh"}
PW_P_REG = dict(PW_P, l2_reg=1e-3, act_l2_reg=1e-4, jac_reg=1e-3)


def _pw_models(cfg_p, policy):
    with _x64(policy):
        jm = nif_tpu.NIF(PW_S, cfg_p, mixed_policy=policy)
        params = jm.init(jax.random.key(0))
    tm = nif_tpu_torch.NIF(PW_S, cfg_p, mixed_policy=policy, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _pw_data(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.standard_normal((n, 1)).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().double().numpy()
    return np.asarray(tree, np.float64)


def _trees_close(mine, ref, atol):
    """Every leaf within ``atol`` of the reference, normalized by the
    reference leaf's largest entry."""
    def check(a, b):
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, rtol=0)
    jax.tree_util.tree_map(check, _np_tree(mine), _np_tree(ref))


def _objectives_match(mine, ref, policy):
    (v, g), (v_ref, g_ref) = mine, ref
    tol = 1e-5 if policy == "float32" else 1e-12
    assert float(v) == pytest.approx(float(v_ref), rel=tol)
    _trees_close(g, g_ref, tol)


def _custom_loss_t(pred, target):
    return torch.mean(torch.abs(pred - target)) + torch.mean(pred ** 2)


def _custom_loss_j(pred, target):
    return jnp.mean(jnp.abs(pred - target)) + jnp.mean(pred ** 2)


@pytest.mark.parametrize("policy", ["float32", "float64"])
@pytest.mark.parametrize("case", ["plain", "weighted", "custom_loss", "reg", "chunked",
                                  "chunked_weighted_reg"])
def test_lbfgs_objective_matches_jax(case, policy):
    cfg_p = PW_P_REG if "reg" in case else PW_P
    jm, params, tm = _pw_models(cfg_p, policy)
    x, y, w = _pw_data()
    kw = dict(inputs=x, targets=y, reg="reg" in case)
    if "weighted" in case:
        kw["sample_weight"] = w
    if "chunked" in case:
        kw["chunk_size"] = 16  # 50 rows: 4 chunks, 14 rows of padding
    mine = LBFGS(tm, _custom_loss_t if case == "custom_loss" else None, **kw)
    with _x64(policy):
        ref_opt = jopt.LBFGS(jm, _custom_loss_j if case == "custom_loss" else None, **kw)
        ref = jax.value_and_grad(ref_opt._objective)(params)
    _objectives_match(mine._objective(), ref, policy)


def test_lbfgs_minimize_lowers_the_objective_and_keeps_f64():
    jm, params, tm = _pw_models(PW_P, "float32")
    x, y, _ = _pw_data()
    opt = LBFGS(tm, inputs=x, targets=y, reg=False)
    before = float(opt._objective()[0])
    tree = opt.minimize(rounds=2, max_iter=20)
    assert tree is not None and list(tree.keys()) == ["pnet"]
    h = opt.history["loss"]
    assert len(h) == len(opt.history["iteration"]) and h[0] == pytest.approx(before, rel=1e-6)
    assert float(opt._objective()[0]) < before
    # one read an iteration and one a trial; a round's first evaluation
    # shares its iteration's read
    assert opt.counts["iterations"] == len(h)
    assert opt.counts["host_reads"] == (opt.counts["evaluations"] + opt.counts["iterations"]
                                        - 2)
    opt.minimize(max_iter=5, dtype="float64")
    assert all(p.dtype == torch.float64 for p in tm.parameters()) and tm._any_f64()
    snapshot = [p.detach().clone() for p in tm.parameters()]
    cast_parameters(tm, "float32")
    for p, q in zip(tm.parameters(), snapshot):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), q.numpy().astype(np.float32))


def test_lbfgs_resume_state_guard():
    """tests/test_optimizers.py's guard: resume carries the state across
    calls on the same trajectory; a dtype change starts afresh."""
    _, _, tm = _pw_models(PW_P, "float32")
    rng = np.random.default_rng(0)
    inputs = rng.standard_normal((64, 2)).astype(np.float32)
    targets = rng.standard_normal((64, 1)).astype(np.float32)
    opt = LBFGS(tm, inputs=inputs, targets=targets, reg=False)
    opt.minimize(max_iter=10, resume=True)
    assert hasattr(opt, "_opt_state")
    state = opt._opt_state
    n_hist = len(opt.history["loss"])
    opt.minimize(max_iter=10, resume=True)
    assert opt._opt_state is state
    h = opt.history["loss"]
    assert len(h) > n_hist
    assert h[-1] <= h[n_hist - 1] + 1e-6
    opt.minimize(max_iter=5, resume=True, dtype="float64")
    assert opt._opt_state is not state and opt._opt_state.dtype == torch.float64
    assert next(tm.parameters()).dtype == torch.float64


# ------------------------------------------------------------ GroupedLBFGS
GR_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "sine",
        "use_resblock": False, "omega_0": 10.0, "connectivity": "full",
        "weight_init_factor": 0.01}
GR_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1, "activation": "swish"}
GR_P_REG = dict(GR_P, l2_reg=1e-3, act_l2_reg=1e-4)
LIN_S = dict(GR_S, connectivity="last_layer", units=16)


def _gr_models(cfg_p, policy, kind="NIFMultiScale", cfg_s=GR_S):
    with _x64(policy):
        jm = getattr(nif_tpu, kind)(cfg_s, cfg_p, mixed_policy=policy)
        params = jm.init(jax.random.key(1))
    tm = getattr(nif_tpu_torch, kind)(cfg_s, cfg_p, mixed_policy=policy, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _gr_data(G=5, P=16, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h = f(G, P, 1, 2, 2)
    return dict(t=f(G, 1), x=f(G, P, 2), u=f(G, P, 1),
                weight=rng.uniform(0.5, 1.5, (G, P)).astype(np.float32),
                target_jac=f(G, P, 1, 2), target_hess=0.5 * (h + h.transpose(0, 1, 2, 4, 3)))


GROUPED = {
    "mse": dict(),
    "mse_weighted_chunked_reg": dict(weight=True, chunk_groups=2, reg=True),
    "jac_weighted": dict(weight=True, target_jac=True),
    "jac_chunked_reg": dict(target_jac=True, chunk_groups=2, reg=True),
    "hess": dict(target_hess=True),
    "jac_hess_weighted_chunked": dict(weight=True, target_jac=True, target_hess=True,
                                      chunk_groups=2),
}


def _grouped_args(spec, data):
    args = dict(t=data["t"], x=data["x"], u=data["u"], reg=spec.get("reg", False),
                w_value=0.7, w_jac=0.3, w_hess=0.2)
    for k in ("weight", "target_jac", "target_hess"):
        if spec.get(k):
            args[k] = data[k]
    if "chunk_groups" in spec:
        args["chunk_groups"] = spec["chunk_groups"]  # 5 groups: 3 chunks, one padded group
    return args


@pytest.mark.parametrize("policy", ["float32", "float64"])
@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_lbfgs_objective_matches_jax(name, policy):
    spec = GROUPED[name]
    jm, params, tm = _gr_models(GR_P_REG if spec.get("reg") else GR_P, policy)
    args = _grouped_args(spec, _gr_data())
    with _x64(policy):
        ref_opt = jopt.GroupedLBFGS(jm, fused=False, **args)
        ref = jax.value_and_grad(ref_opt._objective)(params)
    eager = GroupedLBFGS(tm, fused=False, **args)._objective()
    _objectives_match(eager, ref, policy)
    if policy == "float32":
        # the fused path: the plain kernels on the CPU
        fused = GroupedLBFGS(tm, fused=True, **args)._objective()
        _objectives_match(fused, ref, policy)
        _objectives_match(fused, eager, policy)


def test_grouped_lbfgs_auto_stays_eager_under_float64():
    _, _, tm = _gr_models(GR_P, "float32")
    opt = GroupedLBFGS(tm, **_grouped_args({}, _gr_data()))
    assert opt._fused_flag() is None
    cast_parameters(tm, "float64")
    assert opt._fused_flag() is False
    assert GroupedLBFGS(tm, fused=True, **_grouped_args({}, _gr_data()))._fused_flag() is True


def test_grouped_lbfgs_niflinear_objective_matches_jax():
    """NIF-linear's objective through its own mse_value_and_grad (the
    plain K4 on the fused path)."""
    jm, params, tm = _gr_models(GR_P, "float32", "NIFMultiScaleLastLayerParameterized", LIN_S)
    args = _grouped_args({"weight": True, "chunk_groups": 2}, _gr_data())
    ref = jax.value_and_grad(jopt.GroupedLBFGS(jm, fused=False, **args)._objective)(params)
    for fused in (False, True):
        _objectives_match(GroupedLBFGS(tm, fused=fused, **args)._objective(), ref, "float32")


def test_grouped_lbfgs_fine_tune_lowers_the_loss():
    _, _, tm = _gr_models(GR_P, "float32")
    opt = GroupedLBFGS(tm, fused=True, **_grouped_args({"target_jac": True}, _gr_data()))
    before = float(opt._objective()[0])
    opt.minimize(max_iter=15)
    assert float(opt._objective()[0]) < before
    assert np.all(np.diff(opt.history["loss"]) <= 0)


# ------------------------------------------------------------ refusals
def _messages(fn_mine, fn_ref, exc=ValueError):
    with pytest.raises(exc) as mine:
        fn_mine()
    with pytest.raises(exc) as ref:
        fn_ref()
    assert str(mine.value) == str(ref.value)


def test_refusals_match_jax():
    jm, _, tm = _gr_models(GR_P, "float32")
    d = _gr_data()
    bad_j, bad_h = d["target_jac"][:, :, :, :1], d["target_hess"][:, :, :, :1]
    _messages(lambda: GroupedLBFGS(tm, d["t"], d["x"], d["u"], target_jac=bad_j),
              lambda: jopt.GroupedLBFGS(jm, d["t"], d["x"], d["u"], target_jac=bad_j))
    _messages(lambda: GroupedLBFGS(tm, d["t"], d["x"], d["u"], target_hess=bad_h),
              lambda: jopt.GroupedLBFGS(jm, d["t"], d["x"], d["u"], target_hess=bad_h))
    jpw, _, tpw = _pw_models(PW_P, "float32")
    x, y, _ = _pw_data()
    _messages(lambda: LBFGS(tpw, _custom_loss_t, inputs=x, targets=y, chunk_size=8),
              lambda: jopt.LBFGS(jpw, _custom_loss_j, inputs=x, targets=y, chunk_size=8))


def test_mesh_is_not_ported():
    """The ``mesh=`` of LBFGS, GroupedLBFGS and prefetch_to_device, once
    refused, is ported: on a one-rank gloo mesh the chunked fine-tunes take
    the unmeshed runs' steps bit for bit (the average over one rank is the
    value itself), and prefetch_to_device(mesh=...) stages batches a
    trainer's step takes as they are (multi-rank runs:
    tests/test_torch_parallel.py)."""
    from _torch_dist import one_rank_mesh
    from nif_tpu_torch.parallel import put_batch

    d = _gr_data()
    x, y, w = _pw_data()
    runs = {}
    with one_rank_mesh() as mesh:
        for m in (None, mesh):
            _, _, tm = _gr_models(GR_P, "float32")
            pw = LBFGS(tm, inputs=np.concatenate([y, x], 1), targets=y, sample_weight=w,
                       chunk_size=16, mesh=m)
            pw.minimize(max_iter=3)
            _, _, tm2 = _gr_models(GR_P, "float32")
            gr = GroupedLBFGS(tm2, d["t"], d["x"], d["u"], weight=d["weight"], chunk_groups=2,
                              mesh=m)
            gr.minimize(max_iter=3)
            runs[m is None] = (pw.history["loss"], gr.history["loss"])
        batches = list(prefetch_to_device(iter([(0, d["x"], None)]), device="cpu", mesh=mesh))
        staged = batches[0][1]
        assert batches[0][0] == 0 and batches[0][2] is None
        assert put_batch(staged, mesh) is staged
        np.testing.assert_array_equal(staged.numpy(), d["x"])
    assert len(runs[True][0]) == 3 and len(runs[True][1]) == 3
    assert runs[True] == runs[False]


def test_resident_fit_under_a_scheduled_optimizer_equals_the_step_loop():
    """fit_resident (a Python loop on the CPU) under adam on a per-update
    schedule: the losses, parameters and learning rates of a loop of
    GroupedTrainer.step over the same batches; the schedule's count is no
    hyperparameter a whole-step graph would recapture for."""
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.training.resident import ResidentData, _hyperparameters

    d = _gr_data(G=4, P=32)
    sched = topt.warmup_linear_decay(1e-2, 6, 0.5)
    runs = []
    for _ in range(2):
        model = nif_tpu_torch.NIFMultiScale(GR_S, GR_P, device="cpu", seed=0)
        tr = GroupedTrainer(model, topt.centralize_gradients(topt.adam(sched)))
        runs.append((tr, tr.init(0)))
    (tr, st), (ref, rst) = runs
    st = tr.fit_resident(st, d["t"], d["x"], d["u"], epochs=5, group_batch=4, point_batch=16,
                         seed=3)
    data = ResidentData(d["t"], d["x"], d["u"], group_batch=4, point_batch=16, seed=3,
                        device="cpu")
    eager = []
    for _ in range(5):
        before = _hyperparameters(rst.opt_state)
        rst, loss = ref.step(rst, **data.batch())
        assert _hyperparameters(rst.opt_state) == before
        eager.append(float(loss))
    assert tr.history["loss"] == eager
    assert [g["lr"] for g in st.opt_state.param_groups] == [sched(4)]
    assert [g["schedule_count"] for g in st.opt_state.param_groups] == [5]
    for a, b in zip(tr.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
