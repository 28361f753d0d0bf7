"""The port's derivative slice against the JAX package on the CPU: plain K5
(``shapenet_fwd_jac``) and plain K6 (``shapenet_sobolev_grads``) against the
Pallas kernels in interpret mode, the eager derivatives of
``ops.derivatives``, ``sobolev_value_and_grad``, and Sobolev training and
evaluation under ``GroupedTrainer``.

Inputs are made with numpy from a seed and handed to both packages, with
SIREN-regime chain weights (0.3/omega_0) as the JAX kernel tests use; the
models' parameters are drawn by the JAX model and carried across with
``from_jax_params``. Tolerances:

* K5, float32: y and jac normalized by max|ref| atol 2e-5 (both sum in f32,
  in different orders). bfloat16: max|d| <= 2^-6 max|ref| (two bf16 ulps at
  the top of the range: an f32 last-bit difference can flip one bf16
  rounding of an activation, tangent or dz).
* K6, float32: both terms rel 1e-5, ``d_wb`` normalized atol 5e-5 (the JAX
  package's bound for its fused backward: the stacked backward sums over
  (1 + si) times the rows). bfloat16: terms rel 2e-3, ``d_wb`` max|d| <=
  2^-6 max|ref|.
* The eager derivatives, ``sobolev_value_and_grad`` and the trainer, float32:
  values and terms rel 1e-5, gradients normalized by each leaf's largest
  entry atol 1e-5 (``jacfwd`` in both packages, summed in other orders), per
  epoch training losses rtol 1e-4 over four epochs of Adam (the same update
  in both; a last-bit difference is carried on), evaluation terms rel 1e-4.
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
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
import nif_tpu_torch
import nif_tpu_torch.config as tcfg
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import derivatives as td
from nif_tpu_torch.ops import fused_derivatives as fd
from nif_tpu_torch.ops import fused_shapenet as fs
from nif_tpu_torch.training import GroupedTrainer

torch.set_num_threads(1)

# The chain configs of tests/test_pallas_kernel.py, and one with so > si,
# where K5 takes its forward-tangent body.
CASES = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0)),
    ("siren", (2, 2, 64, 1, "sine", True, 10.0)),
    ("siren", (1, 1, 16, 3, "sine", False, 5.0)),
    ("vanilla", (2, 3, 32, 2, "swish")),
    ("vanilla", (1, 1, 16, 1, "tanh")),
    ("vanilla", (2, 1, 64, 2, "relu")),
]
JAC_EXTRA = [("siren", (2, 3, 64, 2, "sine", False, 30.0))]


def _ids(cases):
    return [f"{v}-{a[0]}to{a[1]}-{a[2]}x{a[3]}{'-res' if len(a) > 5 and a[5] else ''}-{a[4]}"
            for v, a in cases]


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
G, P = 2, 64

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 32, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 10.0,
         "connectivity": "full", "weight_init_factor": 0.01}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish"}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(mine, ref, dtype, atol):
    mine, ref = _np(mine), _np(ref)
    assert mine.shape == ref.shape
    scale = np.abs(ref).max() + 1e-9
    if dtype == "float32":
        np.testing.assert_allclose(mine / scale, ref / scale, atol=atol)
    else:
        assert np.abs(mine - ref).max() <= 2.0 ** -6 * scale


def _chain_data(args, seed):
    cfg = jcfg.ShapeNetConfig(*args)
    si, so = cfg.input_dim, cfg.output_dim
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, jcfg.shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, si))
    tgt = rng.standard_normal((G, P, so))
    jt = rng.standard_normal((G, P, si * so))
    w = rng.uniform(0.5, 1.5, (G, P))
    return [a.astype(np.float32) for a in (wb, x, tgt, jt, w)]


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


# ------------------------------------------------------------ plain K5, K6
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,args", CASES + JAC_EXTRA, ids=_ids(CASES + JAC_EXTRA))
def test_k5_plain_matches_pallas_interpret(variant, args, dtype):
    """Both bodies: the reverse sweeps (so < si) and the forward tangents."""
    wb, x, *_ = _chain_data(args, seed=1)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    before = dict(_build.LAUNCHES)
    y, jac = fd.shapenet_fwd_jac(wt, xt, tcfg.ShapeNetConfig(*args), variant)
    y_ref, jac_ref = jps.shapenet_fwd_jac(wj, xj, jcfg.ShapeNetConfig(*args), variant, True)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    assert y.dtype == jac.dtype == DTYPES[dtype][0]
    _close(y, y_ref, dtype, atol=2e-5)
    _close(jac, jac_ref, dtype, atol=2e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,args", CASES, ids=_ids(CASES))
def test_k6_plain_matches_pallas_interpret(variant, args, dtype, weighted):
    """Term weights 0.7/1.3; on the multi-output configs a value mask (the
    first output) and a Jacobian mask (every other flat entry)."""
    wb, x, tgt, jt, w = _chain_data(args, seed=2)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    si, so = args[0], args[1]
    masks = {}
    if so > 1:
        masks = dict(y_mask=np.eye(1, so, dtype=np.float32)[0],
                     jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32))
    lv, lj, d_wb = fd.shapenet_sobolev_grads(
        wt, xt, torch.from_numpy(tgt), torch.from_numpy(jt), tcfg.ShapeNetConfig(*args),
        variant, 0.7, 1.3, weight=torch.from_numpy(w) if weighted else None, **masks)
    rv, rj, r_wb = jps.shapenet_sobolev_grads(
        wj, xj, jnp.asarray(tgt), jnp.asarray(jt), jcfg.ShapeNetConfig(*args), variant, 0.7,
        1.3, masks.get("y_mask"), masks.get("jac_mask"), jnp.asarray(w) if weighted else None,
        True)
    rel = 1e-5 if dtype == "float32" else 2e-3
    assert float(lv) == pytest.approx(float(rv), rel=rel)
    assert float(lj) == pytest.approx(float(rj), rel=rel)
    assert d_wb.dtype == DTYPES[dtype][0]
    _close(d_wb, r_wb, dtype, atol=5e-5)


def test_k6_plain_matches_autograd_of_the_eager_loss_in_f32():
    """In f32 plain K6's hand-written backward through the tangent chain
    (act'' and the seed rows) is the gradient of the same loss under
    autograd over plain K5's forward-tangent body."""
    cfg = tcfg.ShapeNetConfig(2, 3, 32, 2, "sine", False, 10.0)
    wb, x, tgt, jt, w = _chain_data((2, 3, 32, 2, "sine", False, 10.0), seed=3)
    wt = torch.from_numpy(wb).double().requires_grad_()
    xt = torch.from_numpy(x).double()
    _, lj, d_wb = fd.shapenet_sobolev_grads_reference(
        wt.detach(), xt, torch.from_numpy(tgt), torch.from_numpy(jt), cfg, "siren",
        w_value=0.0, w_jac=1.0, weight=torch.from_numpy(w).double())
    y, jac = fd.shapenet_fwd_jac_reference(wt, xt, cfg, "siren")
    jt_t = torch.from_numpy(jt).double().reshape(G, P, 2, 3).transpose(2, 3)
    loss = torch.mean(torch.square(jac - jt_t) * torch.from_numpy(w).double()[..., None, None])
    (grad,) = torch.autograd.grad(loss, wt)
    assert float(lj) == pytest.approx(float(loss.detach()), rel=1e-10)
    np.testing.assert_allclose(d_wb.numpy(), grad.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("degree", ["7", "9"])
def test_fast_sin_grad2_is_the_polynomial_curvature(degree, monkeypatch):
    """The exact second derivative of the polynomial sine (float64 autograd),
    and the JAX package's ``_fast_sin_grad2`` in float32 (rel 1e-6 of its
    largest value, about 4 pi^2 / (2 pi)^2 = 1)."""
    monkeypatch.setenv("NIF_SIN_DEGREE", degree)
    z = torch.linspace(-40.0, 40.0, 2001, dtype=torch.float64)
    zz = z.clone().requires_grad_()
    (d1,) = torch.autograd.grad(fs.fast_sin(zz).sum(), zz, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), zz)
    np.testing.assert_allclose(fs.fast_sin_grad2(z).numpy(), d2.numpy(), atol=1e-9)
    np.testing.assert_allclose(fs.fast_sin_grad(z).numpy(), d1.detach().numpy(), atol=1e-9)
    ref = np.asarray(jps._fast_sin_grad2(jnp.asarray(z.numpy(), jnp.float32)))
    np.testing.assert_allclose(fs.fast_sin_grad2(z.float()).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("name", ["tanh", "relu", "swish", "silu", "sigmoid", "linear"])
def test_vanilla_act_triples_are_derivatives(name):
    cfg = tcfg.ShapeNetConfig(1, 1, 8, 1, name)
    act, d1, d2 = fs._act_triple(cfg, "vanilla", torch.float32)
    z = torch.linspace(-3.0, 3.0, 601, dtype=torch.float64).requires_grad_()
    (g1,) = torch.autograd.grad(act(z).sum(), z, create_graph=True)
    g2 = (torch.autograd.grad(g1.sum(), z, allow_unused=True)[0] if g1.requires_grad
          else None)
    g2 = torch.zeros_like(z) if g2 is None else g2
    np.testing.assert_allclose(d1(z.detach()).numpy(), g1.detach().numpy(), atol=1e-12)
    np.testing.assert_allclose(d2(z.detach()).numpy(), g2.numpy(), atol=1e-12)


def test_derivative_entries_route_by_device_and_refuse_off_cuda():
    cfg = tcfg.ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x, tgt, jt, _ = _chain_data((2, 1, 16, 1, "sine"), seed=4)
    wt, xt = torch.from_numpy(wb), torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA"):
        fd.shapenet_fwd_jac_cuda(wt, xt, cfg, "siren")
    with pytest.raises(ValueError, match="CUDA"):
        fd.shapenet_sobolev_grads_cuda(wt, xt, torch.from_numpy(tgt), torch.from_numpy(jt), cfg,
                                       "siren")
    # the JAX package's routing rules, off the card (the P rule of the tiles)
    assert fd.fwd_jac_unsupported_reason(cfg, "siren", 64, 2) is None
    assert fd.sobolev_fused_supported(cfg, "siren", 64, 2)
    for P_ in (64, 100):
        for mine, ref in ((fd.fwd_jac_supported(cfg, "siren", P_, 2),
                           jps.fwd_jac_supported(jcfg.ShapeNetConfig(2, 1, 16, 1, "sine"),
                                                 "siren", P_, 2)),
                          (fd.sobolev_fused_supported(cfg, "siren", P_, 2),
                           jps.sobolev_fused_supported(jcfg.ShapeNetConfig(2, 1, 16, 1, "sine"),
                                                       "siren", P_, 2))):
            assert mine == ref


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tc"), (torch.float32, "simt"),
                                           (torch.float16, "simt")], ids=["bf16", "f32", "f16"])
def test_k6_variant_and_gate_per_dtype(dtype, variant):
    """bf16 K6 prefers the tensor-core kernel, f32 (and any other dtype,
    which the wrapper refuses) runs the CUDA-core one, and only bf16 asks
    the tensor-core library whether a chain fits; off the card the gate's
    reasons for each dtype are the JAX package's, byte for byte, and a dtype
    the wrapper refuses asks no kernel library for its limits."""
    siren = (3, 1, 16, 2, "sine", False, 30.0)
    assert fd.k6_variant(dtype) == variant
    if dtype != torch.bfloat16:
        assert fd.k6_variant(dtype, tcfg.ShapeNetConfig(*siren), "siren", 3) == "simt"
    cases = [("vanilla", (2, 1, 16, 1, "tanh"), 64, 2), ("vanilla", (2, 1, 16, 1, "gelu"), 64, 2),
             ("siren", siren, 100, 3), ("siren", siren, 64, 3), ("siren", siren, 64, 9)]
    for variant_, args, P_, si in cases:
        mine = fd.sobolev_fused_unsupported_reason(tcfg.ShapeNetConfig(*args), variant_, P_, si,
                                                   "cpu", dtype)
        assert mine == jps.sobolev_fused_unsupported_reason(jcfg.ShapeNetConfig(*args),
                                                             variant_, P_, si)
    assert fd.sobolev_fused_supported(tcfg.ShapeNetConfig(*siren), "siren", 64, 3, None, dtype)
    if dtype == torch.float16:
        assert fd.sobolev_fused_unsupported_reason(tcfg.ShapeNetConfig(*siren), "siren", 64, 3,
                                                   "cuda", dtype) is None


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_entry_on_cpu_tensors_runs_plain_k6_and_launches_nothing(dtype, weighted):
    """``shapenet_sobolev_grads`` on CPU tensors is plain K6, bit for bit,
    and counts no launch of either CUDA kernel."""
    args = (3, 1, 16, 2, "sine", False, 30.0)
    cfg = tcfg.ShapeNetConfig(*args)
    wb, x, tgt, jt, w = _chain_data(args, seed=9)
    tdt = DTYPES[dtype][0]
    wt, xt = torch.from_numpy(wb).to(tdt), torch.from_numpy(x).to(tdt)
    kw = dict(w_value=0.7, w_jac=1.3, weight=torch.from_numpy(w) if weighted else None)
    before = dict(_build.LAUNCHES)
    got = fd.shapenet_sobolev_grads(wt, xt, torch.from_numpy(tgt), torch.from_numpy(jt), cfg,
                                    "siren", **kw)
    assert _build.LAUNCHES == before
    ref = fd.shapenet_sobolev_grads_reference(wt, xt, torch.from_numpy(tgt),
                                              torch.from_numpy(jt), cfg, "siren", **kw)
    assert got[2].dtype == tdt
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------------------------- eager derivatives
def _models(cfg_s=None, cfg_p=None, policy="float32", seed=0):
    cfg_s = CFG_S if cfg_s is None else cfg_s
    cfg_p = CFG_P if cfg_p is None else cfg_p
    jm = nif_tpu.NIFMultiScale(cfg_s, cfg_p, mixed_policy=policy)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, mixed_policy=policy, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _batch(si=2, so=1, G_=2, P_=64, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G_, 1)).astype(np.float32),
            rng.standard_normal((G_, P_, si)).astype(np.float32),
            rng.standard_normal((G_, P_, so)).astype(np.float32),
            rng.standard_normal((G_, P_, so, si)).astype(np.float32),
            rng.uniform(0.5, 1.5, (G_, P_)).astype(np.float32))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree)


def _trees_close(mine, ref, atol=1e-5):
    def check(a, b):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)
    jax.tree_util.tree_map(check, _np_tree(mine), _np_tree(ref))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K5"])
def test_output_and_jacobian_grouped_matches_jax(fused):
    jm, params, tm = _models()
    t, x, *_ = _batch()
    y, jac = td.output_and_jacobian_grouped(tm, t, x, fused=fused)
    y_ref, jac_ref = jd.output_and_jacobian_grouped(jm, params, t, x, fused=False)
    assert tuple(jac.shape) == jac_ref.shape == (2, 64, 1, 2)
    _close(y, y_ref, "float32", atol=1e-5)
    _close(jac, jac_ref, "float32", atol=1e-5)
    ys, js = td.output_and_jacobian_grouped(tm, t, x, y_index=0, x_index=[1], fused=fused)
    _close(js, jac_ref[..., :1, 1:], "float32", atol=1e-5)


def test_output_jacobian_hessian_grouped_matches_jax_and_refuses_k7():
    jm, params, tm = _models()
    t, x, *_ = _batch()
    y, jac, hess = td.output_jacobian_hessian_grouped(tm, t, x, x_index=[0, 1], fused=False)
    _, _, h_ref = jd.output_jacobian_hessian_grouped(jm, params, t, x, x_index=[0, 1],
                                                     fused=False)
    assert tuple(hess.shape) == h_ref.shape == (2, 64, 1, 2, 2)
    _close(hess, h_ref, "float32", atol=1e-5)
    # fused=True takes plain K7 on the CPU (no launch) and agrees; auto off
    # the card is the eager path
    before = dict(_build.LAUNCHES)
    _, _, h_k7 = td.output_jacobian_hessian_grouped(tm, t, x, x_index=[0, 1], fused=True)
    _, _, h_auto = td.output_jacobian_hessian_grouped(tm, t, x, x_index=[0, 1])
    assert _build.LAUNCHES == before
    _close(h_k7, h_ref, "float32", atol=5e-5)
    assert torch.equal(h_auto, hess)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_sobolev_loss_grouped_and_grads_match_jax(weighted):
    jm, params, tm = _models()
    t, x, u, ju, w = _batch()
    w = w if weighted else None
    total, terms = td.sobolev_loss_grouped(tm, t, x, u, ju, w_jac=0.5, weight=w)
    (ref, ref_terms), g_ref = jax.value_and_grad(
        lambda p: jd.sobolev_loss_grouped(jm, p, t, x, u, ju, w_jac=0.5, weight=w),
        has_aux=True)(params)
    assert float(total) == pytest.approx(float(ref), rel=1e-5)
    for k in ("value_mse", "jacobian_mse"):
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=1e-5)
    params_t = [p for _, p in tm.param_items()]
    _trees_close(tm._grad_tree(torch.autograd.grad(total, params_t)), g_ref)


def test_pointwise_derivatives_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 2)).astype(np.float32)
    inputs = rng.standard_normal((16, 3)).astype(np.float32)
    tgt = rng.standard_normal((16, 2)).astype(np.float32)
    tj = rng.standard_normal((16, 2, 3)).astype(np.float32)
    th = rng.standard_normal((16, 2, 3, 3)).astype(np.float32)
    fn_t = lambda r: torch.sin(r @ torch.from_numpy(a)) * r[:, :1]  # noqa: E731
    fn_j = lambda r: jnp.sin(r @ jnp.asarray(a)) * r[:, :1]  # noqa: E731
    it = torch.from_numpy(inputs)
    y, jac, hess = td.output_jacobian_hessian(fn_t, it, y_index=[1], x_index=[0, 2])
    y_r, jac_r, hess_r = jd.output_jacobian_hessian(fn_j, inputs, y_index=[1], x_index=[0, 2])
    for mine, ref in ((y, y_r), (jac, jac_r), (hess, hess_r)):
        _close(mine, ref, "float32", atol=1e-6)
    assert float(td.jacobian_regularization(fn_t, it, 0.1)) == pytest.approx(
        float(jd.jacobian_regularization(fn_j, inputs, 0.1)), rel=1e-5)
    total, terms = td.sobolev_loss(fn_t, it, tgt, tj, th, w_jac=0.5, w_hess=0.25)
    ref, ref_terms = jd.sobolev_loss(fn_j, inputs, tgt, tj, th, w_jac=0.5, w_hess=0.25)
    assert float(total) == pytest.approx(float(ref), rel=1e-5)
    assert set(terms) == set(ref_terms)
    with pytest.raises(ValueError, match="does not match"):
        td.sobolev_loss(fn_t, it, tgt[:, :1], tj)


# ------------------------------------------------- sobolev_value_and_grad
SOB_CASES = {
    "full": dict(),
    "weights-terms": dict(w_value=0.7, w_jac=1.3, weighted=True),
    "y_index": dict(so=2, y_index=[1], x_index=None),
    "x_index": dict(so=2, y_index=None, x_index=[1]),
    "both-index-l2": dict(so=2, y_index=[0], x_index=[0], l2=True),
}


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K6"])
@pytest.mark.parametrize("case", sorted(SOB_CASES))
def test_sobolev_value_and_grad_matches_jax(case, fused):
    opts = dict(SOB_CASES[case])
    so = opts.pop("so", 1)
    cfg_p = {**CFG_P, "l2_reg": 1e-3} if opts.pop("l2", False) else CFG_P
    weighted = opts.pop("weighted", False)
    jm, params, tm = _models({**CFG_S, "output_dim": so}, cfg_p)
    t, x, u, ju, w = _batch(so=so)
    yi, xi = opts.get("y_index"), opts.get("x_index")
    if yi is not None:
        u = u[..., yi]
        ju = ju[:, :, yi]
    if xi is not None:
        ju = ju[..., xi]
    kw = dict(opts, target_jac=ju, weight=w if weighted else None)
    total, terms, grads = tm.sobolev_value_and_grad(t, x, u, fused=fused, **kw)
    ref, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, fused=fused, **kw)
    assert total.dim() == 0 and not total.requires_grad
    assert float(total) == pytest.approx(float(ref), rel=1e-5)
    for k in ("value_mse", "jacobian_mse"):
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=1e-5)
    _trees_close(grads, g_ref)


def test_sobolev_value_and_grad_bf16_fused_matches_jax():
    """mixed_bfloat16: plain K6 against the Pallas kernel in interpret mode
    behind the same bf16 ParameterNet. Terms rel 2e-3, each gradient leaf
    within 2e-2 relative L2 (as the MSE path's bf16 test)."""
    jm, params, tm = _models(policy="mixed_bfloat16")
    t, x, u, ju, w = _batch()
    _, terms, grads = tm.sobolev_value_and_grad(t, x, u, target_jac=ju, weight=w, fused=True)
    _, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, target_jac=ju, weight=w,
                                                    fused=True)
    for k in ("value_mse", "jacobian_mse"):
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=2e-3)

    def check(a, b):
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b) + 1e-12
    jax.tree_util.tree_map(check, _np_tree(grads), _np_tree(g_ref))


def test_sobolev_value_and_grad_routes_and_refuses():
    _, _, tm = _models()
    t, x, u, ju, _ = _batch()
    info = tm.sobolev_path_info(64, 2)
    assert info["path"] == "eager" and "not on CUDA" in info["reason"]
    assert "not on CUDA" in tm.sobolev_path_info(64, 2, hess=True)["reason"]
    before = dict(_build.LAUNCHES)
    total_a, _, _ = tm.sobolev_value_and_grad(t, x, u, target_jac=ju)
    total_e, _, _ = tm.sobolev_value_and_grad(t, x, u, target_jac=ju, fused=False)
    assert float(total_a) == float(total_e) and _build.LAUNCHES == before
    with pytest.raises(ValueError, match="target_jac shape"):
        tm.sobolev_value_and_grad(t, x, u, target_jac=ju[..., :1])
    with pytest.raises(ValueError, match="requires target_jac"):
        tm.sobolev_value_and_grad(t, x, u, fused=True)
    # Hessian targets: auto off the card is the eager path, launches nothing
    hess = np.zeros((2, 64, 1, 2, 2), np.float32)
    total_a, _, _ = tm.sobolev_value_and_grad(t, x, u, target_jac=ju, target_hess=hess)
    total_h, terms_h, _ = tm.sobolev_value_and_grad(t, x, u, target_jac=ju, target_hess=hess,
                                                    fused=False)
    assert float(total_a) == float(total_h) and _build.LAUNCHES == before
    assert set(terms_h) == {"value_mse", "jacobian_mse", "hessian_mse"}


# ----------------------------------------------------------- GroupedTrainer
def _wave(G_=5, P_=64, seed=7):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G_, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G_, P_, 2)).astype(np.float32)
    a = np.pi * x[..., 0] + t
    u = (np.sin(a) * np.cos(x[..., 1]))[..., None].astype(np.float32)
    ju = np.stack([np.pi * np.cos(a) * np.cos(x[..., 1]), -np.sin(a) * np.sin(x[..., 1])],
                  -1)[:, :, None, :].astype(np.float32)
    return t, x, u, ju


@pytest.mark.parametrize("fused", [None, True], ids=["auto", "plain-K6"])
def test_sobolev_fit_and_evaluate_match_jax(fused):
    """Four epochs, a tail batch of 1 group padded to 2, 32 of 64 points per
    step: the same batches (one numpy seed) and Adam in both packages."""
    t, x, u, ju = _wave()
    jm, _, tm = _models()
    jt = JaxGroupedTrainer(jm, optax.adam(1e-3), seed=3, w_jac=0.5, fused=fused)
    js = jt.init(jax.random.key(1))
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=1e-3), seed=3, w_jac=0.5,
                        fused=fused)
    ts = tt.init(1)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    kw = dict(epochs=4, group_batch=2, point_batch=32, target_jac=ju)
    js = jt.fit(js, t, x, u, **kw)
    ts = tt.fit(ts, t, x, u, **kw)
    assert ts.step == js.step == 12
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    assert tt.history["sobolev_path"] == "eager"
    mine = tt.evaluate_sobolev(ts, t, x, u, ju, group_batch=2)
    ref = jt.evaluate_sobolev(js, t, x, u, ju, group_batch=2)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-4)
    hu = np.zeros((5, 64, 1, 2, 2), np.float32)
    mine = tt.evaluate_sobolev(ts, t, x, u, ju, group_batch=2, target_hess=hu)
    ref = jt.evaluate_sobolev(js, t, x, u, ju, group_batch=2, target_hess=hu)
    assert mine.keys() == ref.keys() and "hessian_mse" in mine
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-4)


def test_sobolev_fit_lowers_both_terms():
    """A small CPU Sobolev fit through plain K6 lowers the value and the
    Jacobian term; the trainer's step takes target_jac and the MSE path
    stays untouched."""
    t, x, u, ju = _wave(G_=4, P_=128, seed=8)
    _, _, tm = _models(seed=2)
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=3e-3), seed=0, fused=True)
    ts = tt.init(2)
    before = tt.evaluate_sobolev(ts, t, x, u, ju)
    ts = tt.fit(ts, t, x, u, epochs=25, group_batch=2, point_batch=64, target_jac=ju)
    after = tt.evaluate_sobolev(ts, t, x, u, ju)
    assert after["value_mse"] < before["value_mse"]
    assert after["jacobian_mse"] < before["jacobian_mse"]
    assert tt.history["loss"][-1] < tt.history["loss"][0]
    assert "path" not in tt.history and tt.history["sobolev_path"] == "eager"


# Tutorial 8's model (examples/08_sobolev_training.py, _CFG_S / _CFG_P): a
# 1 -> 1 SIREN ShapeNet of width 30, two hidden layers, omega_0 = 30, whose
# Jacobian evaluation (so >= si) takes K5's tangent body.
TUTORIAL8_S = {"connectivity": "full", "input_dim": 1, "output_dim": 1, "units": 30,
               "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
               "activation": "sine", "use_resblock": False}
TUTORIAL8_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
               "activation": "swish", "use_resblock": False, "omega_0": 30.0}


def test_tutorial8_evaluate_sobolev_matches_jax():
    """The slice end to end on the CPU, float32: tutorial 8's model (the
    JAX model draws the parameters, ``from_jax_params`` carries them) under
    ``GroupedTrainer.evaluate_sobolev`` at G = 3, P = 256 in chunks of two
    groups, against the JAX package's, every term rel 1e-5; and its grouped
    ``(y, jac)`` through plain K5's tangent body (``fused=True``) against
    the JAX package's fused path, y and jac normalized by max|ref| atol
    2e-5 (K5's bound above)."""
    jm, _, tm = _models(TUTORIAL8_S, TUTORIAL8_P)
    cfg = tcfg.ShapeNetConfig.from_dict(TUTORIAL8_S)
    assert fd._jac_mode(cfg, cfg.input_dim) == "tangent"
    rng = np.random.default_rng(88)
    t = rng.uniform(-1, 1, (3, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, 256, 1)).astype(np.float32)
    u = rng.standard_normal((3, 256, 1)).astype(np.float32)
    ju = rng.standard_normal((3, 256, 1, 1)).astype(np.float32)
    jt = JaxGroupedTrainer(jm, optax.adam(1e-4), seed=0, w_jac=0.5)
    js = jt.init(jax.random.key(8))
    params = js.params
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=1e-4), seed=0, w_jac=0.5)
    ts = tt.init(0)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    mine = tt.evaluate_sobolev(ts, t, x, u, ju, group_batch=2)
    ref = jt.evaluate_sobolev(js, t, x, u, ju, group_batch=2)
    assert mine.keys() == ref.keys() == {"value_mse", "jacobian_mse", "total"}
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-5), k
    before = dict(_build.LAUNCHES)
    y, jac = td.output_and_jacobian_grouped(tm, torch.from_numpy(t), torch.from_numpy(x),
                                            fused=True)
    assert _build.LAUNCHES == before  # plain K5 on the CPU
    y_ref, jac_ref = jd.output_and_jacobian_grouped(jm, params, jnp.asarray(t), jnp.asarray(x),
                                                    fused=True)
    for mine_a, ref_a in ((y, y_ref), (jac, jac_ref)):
        ref_a = np.asarray(ref_a)
        assert mine_a.shape == ref_a.shape
        scale = np.abs(ref_a).max()
        np.testing.assert_allclose(mine_a.detach().numpy() / scale, ref_a / scale, atol=2e-5)
