"""The port's Hessian slice against the JAX package on the CPU: plain K7
(``shapenet_fwd_hess``) and plain K8 (``shapenet_hessian_grads``) against the
Pallas kernels in interpret mode, the polynomial's third derivative, the
kernels' gates, ``output_jacobian_hessian_grouped``,
``sobolev_value_and_grad(target_hess=...)``, and Hessian-target training and
evaluation under ``GroupedTrainer``.

Inputs are made with numpy from a seed and handed to both packages, with
SIREN-regime chain weights (0.3/omega_0) as the JAX kernel tests use; the
models' parameters are drawn by the JAX model and carried across with
``from_jax_params``. Tolerances:

* K7, float32: y, jac and hess normalized by max|ref| atol 5e-5 (the JAX
  package's own bound for its fused Hessian evaluation); bfloat16: max|d| <=
  2^-6 max|ref| (two bf16 ulps at the top of the range: an f32 last-bit
  difference can flip one bf16 rounding). The Hessian is exactly symmetric.
* K8, float32: the three terms rel 1e-5, ``d_wb`` normalized atol 1e-4 (the
  JAX package's bound for its fused Hessian train pass, whose stacked
  backward sums ten times the rows); bfloat16: terms rel 2e-3, ``d_wb``
  2^-6 max|ref|.
* The model and the trainer, float32: against the JAX package's fused
  (interpret-mode) path, the plain kernels hold terms rel 1e-5, the eager
  nested ``jacfwd`` path the JAX test's own rel 2e-4 (a different
  summation of the same derivatives); gradients normalized by each leaf's
  largest entry atol 1e-4 (K8's bound) on both. Four epochs of Adam:
  epoch losses rtol 1e-4, evaluation terms rel 1e-4.
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
from nif_tpu_torch.ops import fused_hessian as fh
from nif_tpu_torch.ops import fused_shapenet as fs
from nif_tpu_torch.training import GroupedTrainer

torch.set_num_threads(1)

# The SIREN configs of tests/test_pallas_kernel.py (the Hessian kernels run
# sine chains only), and one with so > si.
CASES = [
    (3, 1, 128, 2, "sine", False, 30.0),
    (2, 2, 64, 1, "sine", True, 10.0),
    (1, 1, 16, 3, "sine", False, 5.0),
    (2, 3, 64, 2, "sine", False, 30.0),
]
IDS = [f"{a[0]}to{a[1]}-{a[2]}x{a[3]}{'-res' if a[5] else ''}" for a in CASES]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
G, P = 2, 64


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
    npairs = si * (si + 1) // 2
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, jcfg.shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, si))
    tgt = rng.standard_normal((G, P, so))
    jt = rng.standard_normal((G, P, si * so))
    ht = rng.standard_normal((G, P, npairs * so))
    w = rng.uniform(0.5, 1.5, (G, P))
    return [a.astype(np.float32) for a in (wb, x, tgt, jt, ht, w)]


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


# ------------------------------------------------------------ plain K7, K8
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("args", CASES, ids=IDS)
def test_k7_plain_matches_pallas_interpret(args, dtype):
    wb, x, *_ = _chain_data(args, seed=1)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    before = dict(_build.LAUNCHES)
    y, jac, hess = fh.shapenet_fwd_hess(wt, xt, tcfg.ShapeNetConfig(*args))
    y_ref, jac_ref, hess_ref = jps.shapenet_fwd_hess(wj, xj, jcfg.ShapeNetConfig(*args),
                                                     "siren", True)
    assert _build.LAUNCHES == before  # a CPU tensor runs the plain version
    assert y.dtype == jac.dtype == hess.dtype == DTYPES[dtype][0]
    assert torch.equal(hess, hess.transpose(-1, -2))
    for mine, ref in ((y, y_ref), (jac, jac_ref), (hess, hess_ref)):
        _close(mine, ref, dtype, atol=5e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("args", CASES, ids=IDS)
def test_k8_plain_matches_pallas_interpret(args, dtype, weighted):
    """Term weights 0.7/1.3/0.4; on the multi-output configs a value mask
    (the first output), a Jacobian mask (every other flat entry) and a
    Hessian mask (two of every three flat entries)."""
    wb, x, tgt, jt, ht, w = _chain_data(args, seed=2)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    si, so = args[0], args[1]
    masks = {}
    if so > 1:
        npairs = si * (si + 1) // 2
        masks = dict(y_mask=np.eye(1, so, dtype=np.float32)[0],
                     jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                     hess_mask=(np.arange(npairs * so) % 3 != 1).astype(np.float32))
    lv, lj, lh, d_wb = fh.shapenet_hessian_grads(
        wt, xt, torch.from_numpy(tgt), torch.from_numpy(jt), torch.from_numpy(ht),
        tcfg.ShapeNetConfig(*args), "siren", 0.7, 1.3, 0.4,
        weight=torch.from_numpy(w) if weighted else None, **masks)
    rv, rj, rh, r_wb = jps.shapenet_hessian_grads(
        wj, xj, jnp.asarray(tgt), jnp.asarray(jt), jnp.asarray(ht), jcfg.ShapeNetConfig(*args),
        "siren", 0.7, 1.3, 0.4, masks.get("y_mask"), masks.get("jac_mask"),
        masks.get("hess_mask"), jnp.asarray(w) if weighted else None, True)
    rel = 1e-5 if dtype == "float32" else 2e-3
    for mine, ref in ((lv, rv), (lj, rj), (lh, rh)):
        assert float(mine) == pytest.approx(float(ref), rel=rel)
    assert d_wb.dtype == DTYPES[dtype][0]
    _close(d_wb, r_wb, dtype, atol=1e-4)


def test_k8_plain_matches_autograd_of_plain_k7_in_f64():
    """In float64 plain K8's hand-written backward through the second-order
    chain (act''' and the pairs' product-rule and seed terms) is the
    gradient of the same loss under autograd over plain K7's forward, on a
    resblock chain with two inputs."""
    args = (2, 2, 16, 2, "sine", True, 10.0)
    cfg = tcfg.ShapeNetConfig(*args)
    wb, x, tgt, jt, ht, w = _chain_data(args, seed=3)
    wt = torch.from_numpy(wb).double().requires_grad_()
    xt = torch.from_numpy(x).double()
    lv, lj, lh, d_wb = fh.shapenet_hessian_grads_reference(
        wt.detach(), xt, torch.from_numpy(tgt), torch.from_numpy(jt), torch.from_numpy(ht),
        cfg, "siren", w_value=0.5, w_jac=0.25, w_hess=2.0, weight=torch.from_numpy(w).double())
    y, jac, hess = fh.shapenet_fwd_hess_reference(wt, xt, cfg, "siren")
    wd = torch.from_numpy(w).double()
    pairs = fh._hess_pairs(2)
    h_pairs = torch.stack([hess[..., j, k] for j, k in pairs], dim=-1)  # [G, P, so, np]
    ht_t = torch.from_numpy(ht).double().reshape(G, P, len(pairs), 2).transpose(2, 3)
    mult = torch.tensor([1.0 if j == k else 2.0 for j, k in pairs], dtype=torch.float64)
    terms = (torch.mean(torch.square(y - torch.from_numpy(tgt).double()) * wd[..., None]),
             torch.mean(torch.square(jac - torch.from_numpy(jt).double().reshape(
                 G, P, 2, 2).transpose(2, 3)) * wd[..., None, None]),
             torch.sum(torch.square(h_pairs - ht_t) * mult * wd[..., None, None])
             / (G * P * 2 * 4))
    loss = 0.5 * terms[0] + 0.25 * terms[1] + 2.0 * terms[2]
    (grad,) = torch.autograd.grad(loss, wt)
    for mine, ref in zip((lv, lj, lh), terms):
        assert float(mine) == pytest.approx(float(ref.detach()), rel=1e-10)
    np.testing.assert_allclose(d_wb.numpy(), grad.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("degree", ["7", "9"])
def test_fast_sin_grad3_is_the_polynomial_third_derivative(degree, monkeypatch):
    """The exact third derivative of the polynomial sine (float64 autograd),
    and the JAX package's ``_fast_sin_grad3`` in float32 (rel 1e-6 of its
    largest value, about 8 pi^3 / (2 pi)^3 = 1); ``_act_quad`` hands the
    four functions out for a bf16 SIREN chain and the true sine's in f32."""
    monkeypatch.setenv("NIF_SIN_DEGREE", degree)
    z = torch.linspace(-40.0, 40.0, 2001, dtype=torch.float64)
    zz = z.clone().requires_grad_()
    (d1,) = torch.autograd.grad(fs.fast_sin(zz).sum(), zz, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), zz, create_graph=True)
    (d3,) = torch.autograd.grad(d2.sum(), zz)
    np.testing.assert_allclose(fs.fast_sin_grad3(z).numpy(), d3.numpy(), atol=1e-9)
    ref = np.asarray(jps._fast_sin_grad3(jnp.asarray(z.numpy(), jnp.float32)))
    np.testing.assert_allclose(fs.fast_sin_grad3(z.float()).numpy(), ref, atol=1e-6)
    cfg = tcfg.ShapeNetConfig(1, 1, 8, 1, "sine")
    assert fs._act_quad(cfg, "siren", torch.bfloat16)[3] is fs.fast_sin_grad3
    d3_f32 = fs._act_quad(cfg, "siren", torch.float32)[3]
    np.testing.assert_allclose(d3_f32(z).numpy(), -np.cos(z.numpy()), atol=1e-15)


def test_hessian_gates_match_jax():
    """The gates' reasons are the JAX package's strings (vanilla chains,
    si = 5, a P the tiles refuse) and both accept what its kernels take."""
    siren = (3, 1, 16, 2, "sine", False, 30.0)
    cases = [("vanilla", (2, 1, 16, 1, "tanh"), 64, 2), ("siren", siren, 64, 5),
             ("siren", siren, 100, 3), ("siren", siren, 64, 3), ("siren", siren, 256, 4)]
    for variant, args, P_, si in cases:
        mine_k7 = fh.fwd_hess_unsupported_reason(tcfg.ShapeNetConfig(*args), variant, P_, si)
        ref_k7 = jps.fwd_hess_unsupported_reason(jcfg.ShapeNetConfig(*args), variant, P_, si)
        mine_k8 = fh.hessian_fused_unsupported_reason(tcfg.ShapeNetConfig(*args), variant, P_,
                                                      si)
        ref_k8 = jps.hessian_fused_unsupported_reason(jcfg.ShapeNetConfig(*args), variant, P_,
                                                      si)
        assert (mine_k7, mine_k8) == (ref_k7, ref_k8)
    assert "sine chains only" in fh.fwd_hess_unsupported_reason(
        tcfg.ShapeNetConfig(2, 1, 16, 1, "tanh"), "vanilla", 64, 2)
    assert fh.hessian_fused_supported(tcfg.ShapeNetConfig(*siren), "siren", 64, 3)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tc"), (torch.float32, "simt"),
                                           (torch.float16, "simt")], ids=["bf16", "f32", "f16"])
def test_k8_variant_and_gate_per_dtype(dtype, variant):
    """bf16 K8 runs the tensor-core kernel, f32 (and any other dtype, which
    the wrapper refuses) the CUDA-core one; off the card the gate's reasons
    for each dtype are the JAX package's, byte for byte, and a dtype the
    wrapper refuses asks no kernel library for its limits."""
    assert fh.k8_variant(dtype) == variant
    siren = (3, 1, 16, 2, "sine", False, 30.0)
    cases = [("vanilla", (2, 1, 16, 1, "tanh"), 64, 2), ("siren", siren, 64, 5),
             ("siren", siren, 100, 3), ("siren", siren, 64, 3)]
    for variant_, args, P_, si in cases:
        mine = fh.hessian_fused_unsupported_reason(tcfg.ShapeNetConfig(*args), variant_, P_, si,
                                                   "cpu", dtype)
        assert mine == jps.hessian_fused_unsupported_reason(jcfg.ShapeNetConfig(*args), variant_,
                                                            P_, si)
    assert fh.hessian_fused_supported(tcfg.ShapeNetConfig(*siren), "siren", 64, 3, None, dtype)
    if dtype == torch.float16:
        assert fh.hessian_fused_unsupported_reason(tcfg.ShapeNetConfig(*siren), "siren", 64, 3,
                                                   "cuda", dtype) is None


def test_hessian_entries_route_by_device_and_refuse_off_cuda():
    cfg = tcfg.ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x, tgt, jt, ht, _ = _chain_data((2, 1, 16, 1, "sine"), seed=4)
    wt, xt = torch.from_numpy(wb), torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA"):
        fh.shapenet_fwd_hess_cuda(wt, xt, cfg, "siren")
    with pytest.raises(ValueError, match="CUDA"):
        fh.shapenet_hessian_grads_cuda(wt, xt, torch.from_numpy(tgt), torch.from_numpy(jt),
                                       torch.from_numpy(ht), cfg, "siren")
    with pytest.raises(ValueError, match="sine chains only"):
        fs._act_quad(tcfg.ShapeNetConfig(2, 1, 16, 1, "tanh"), "vanilla", torch.float32)
    pairs = fh._hess_pairs(3)
    assert pairs == jps._hess_pairs(3) and len(pairs) == 6
    hp = torch.arange(2 * 6, dtype=torch.float32).reshape(1, 1, 2, 6)
    hess = fh._mirror(hp, 3)
    assert hess.shape == (1, 1, 2, 3, 3) and torch.equal(hess, hess.transpose(-1, -2))
    assert float(hess[0, 0, 1, 2, 0]) == float(hp[0, 0, 1, pairs.index((0, 2))])


# ------------------------------------------------------ models and trainer
CFG_S = {"input_dim": 3, "output_dim": 2, "units": 16, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.1}
CFG_P = {"input_dim": 2, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0}
CFG_RES = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2,
           "activation": "sine", "use_resblock": True, "omega_0": 30.0,
           "connectivity": "full", "weight_init_factor": 0.1}


def _models(cfg_s=None, cfg_p=None, policy="float32", seed=1):
    cfg_s = CFG_S if cfg_s is None else cfg_s
    cfg_p = CFG_P if cfg_p is None else cfg_p
    jm = nif_tpu.NIFMultiScale(cfg_s, cfg_p, mixed_policy=policy)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, mixed_policy=policy, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree)


def _trees_close(mine, ref, atol):
    def check(a, b):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)
    jax.tree_util.tree_map(check, _np_tree(mine), _np_tree(ref))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K7"])
def test_output_jacobian_hessian_grouped_matches_jax(fused):
    """Against the JAX package's fused (interpret-mode) evaluation, whole and
    with index subsets; the fused Hessian is exactly symmetric."""
    jm, params, tm = _models()
    rng = np.random.default_rng(5)
    t = rng.standard_normal((G, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    atol = 5e-5 if fused else 1e-4
    for yi, xi in ((None, None), (1, [0, 2])):
        before = dict(_build.LAUNCHES)
        y, jac, hess = td.output_jacobian_hessian_grouped(tm, t, x, yi, xi, fused=fused)
        assert _build.LAUNCHES == before
        refs = jd.output_jacobian_hessian_grouped(jm, params, t, x, yi, xi, fused=True)
        for mine, ref in zip((y, jac, hess), refs):
            _close(mine, ref, "float32", atol=atol)
        if fused and xi is None:
            assert torch.equal(hess, hess.transpose(-1, -2))


HESS_CASES = {
    "jac+hess": dict(),
    "hess-only": dict(with_jac=False),
    "weighted-asym": dict(weighted=True, symmetric=False),
    "subset": dict(y_index=1, x_index=[0, 2], w_value=0.7, w_jac=2.5, w_hess=0.2),
    "resblock": dict(resblock=True),
}


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "plain-K8"])
@pytest.mark.parametrize("case", sorted(HESS_CASES))
def test_sobolev_value_and_grad_hessian_matches_jax(case, fused):
    """The cases of the JAX package's ``test_fused_hessian_grads_parity``
    against its fused (interpret-mode) Hessian train pass."""
    opts = dict(HESS_CASES[case])
    resblock = opts.pop("resblock", False)
    jm, params, tm = _models(CFG_RES if resblock else CFG_S)
    si, so = (2, 1) if resblock else (3, 2)
    yi, xi = opts.pop("y_index", None), opts.pop("x_index", None)
    n_y = so if yi is None else len(np.atleast_1d(yi))
    n_x = si if xi is None else len(np.atleast_1d(xi))
    rng = np.random.default_rng(17)
    t = rng.standard_normal((G, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, si)).astype(np.float32)
    u = rng.standard_normal((G, P, so)).astype(np.float32)
    jt = rng.standard_normal((G, P, n_y, n_x)).astype(np.float32)
    ht = rng.standard_normal((G, P, n_y, n_x, n_x)).astype(np.float32)
    if opts.pop("symmetric", True):
        ht = 0.5 * (ht + ht.transpose(0, 1, 2, 4, 3))
    w = rng.uniform(0.5, 1.5, (G, P)).astype(np.float32) if opts.pop("weighted", False) else None
    kw = dict(target_jac=jt if opts.pop("with_jac", True) else None, target_hess=ht,
              w_value=opts.pop("w_value", 1.0), w_jac=opts.pop("w_jac", 0.3),
              w_hess=opts.pop("w_hess", 0.05), y_index=yi, x_index=xi, weight=w)
    before = dict(_build.LAUNCHES)
    total, terms, grads = tm.sobolev_value_and_grad(t, x, u, fused=fused, **kw)
    assert _build.LAUNCHES == before
    ref, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, fused=True, **kw)
    rel = 1e-5 if fused else 2e-4
    assert total.dim() == 0 and not total.requires_grad
    assert float(total) == pytest.approx(float(ref), rel=rel)
    assert set(terms) == set(ref_terms)
    for k in ref_terms:
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=rel)
    _trees_close(grads, g_ref, atol=1e-4)


def test_sobolev_value_and_grad_hessian_bf16_fused_matches_jax():
    """mixed_bfloat16: plain K8 against the Pallas kernel in interpret mode
    behind the same bf16 ParameterNet. Terms rel 2e-3, each gradient leaf
    within 2e-2 relative L2 (as the Jacobian path's bf16 test)."""
    jm, params, tm = _models(policy="mixed_bfloat16")
    rng = np.random.default_rng(6)
    t = rng.standard_normal((G, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    u = rng.standard_normal((G, P, 2)).astype(np.float32)
    ht = rng.standard_normal((G, P, 2, 3, 3)).astype(np.float32)
    kw = dict(target_hess=0.5 * (ht + ht.transpose(0, 1, 2, 4, 3)), w_hess=0.05, fused=True)
    _, terms, grads = tm.sobolev_value_and_grad(t, x, u, **kw)
    _, ref_terms, g_ref = jm.sobolev_value_and_grad(params, t, x, u, **kw)
    for k in ref_terms:
        assert float(terms[k]) == pytest.approx(float(ref_terms[k]), rel=2e-3)

    def check(a, b):
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b) + 1e-12
    jax.tree_util.tree_map(check, _np_tree(grads), _np_tree(g_ref))


def test_hessian_routing_and_refusals():
    """Off the card the auto path is eager and launches nothing; fused=True
    on a vanilla chain refuses with the gate's reason; a mis-shaped
    Hessian target is loud."""
    _, _, tm = _models()
    rng = np.random.default_rng(7)
    t = rng.standard_normal((G, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    u = rng.standard_normal((G, P, 2)).astype(np.float32)
    ht = np.zeros((G, P, 2, 3, 3), np.float32)
    info = tm.sobolev_path_info(P, 3, hess=True)
    assert info["path"] == "eager" and "not on CUDA" in info["reason"]
    before = dict(_build.LAUNCHES)
    total_a, terms_a, _ = tm.sobolev_value_and_grad(t, x, u, target_hess=ht)
    total_e, _, _ = tm.sobolev_value_and_grad(t, x, u, target_hess=ht, fused=False)
    assert float(total_a) == float(total_e) and _build.LAUNCHES == before
    assert set(terms_a) == {"value_mse", "hessian_mse"}
    with pytest.raises(ValueError, match="target_hess shape"):
        tm.sobolev_value_and_grad(t, x, u, target_hess=ht[..., :2], fused=True)
    vanilla = nif_tpu_torch.NIF({"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
                                 "activation": "tanh"},
                                {"input_dim": 2, "latent_dim": 3, "units": 16, "nlayers": 1,
                                 "activation": "swish"}, device="cpu")
    with pytest.raises(ValueError, match="sine chains only"):
        vanilla.sobolev_value_and_grad(t, x[..., :2], u[..., :1],
                                       target_hess=np.zeros((G, P, 1, 2, 2), np.float32),
                                       fused=True)
    assert "sine chains" in vanilla.sobolev_path_info(P, 2, hess=True)["reason"]


def _wave(G_=4, P_=64, seed=8):
    """u = sin(pi x0 + t) cos(x1) with its analytic Jacobian and Hessian."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G_, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G_, P_, 2)).astype(np.float32)
    a = np.pi * x[..., 0] + t[:, :1]
    b = x[..., 1]
    u = (np.sin(a) * np.cos(b))[..., None]
    ju = np.stack([np.pi * np.cos(a) * np.cos(b), -np.sin(a) * np.sin(b)], -1)[:, :, None]
    h01 = -np.pi * np.cos(a) * np.sin(b)
    hu = np.stack([np.stack([-np.pi ** 2 * np.sin(a) * np.cos(b), h01], -1),
                   np.stack([h01, -np.sin(a) * np.cos(b)], -1)], -2)[:, :, None]
    return [v.astype(np.float32) for v in (t, x, u, ju, hu)]


@pytest.mark.parametrize("fused", [None, True], ids=["auto", "plain-K8"])
def test_hessian_fit_and_evaluate_match_jax(fused):
    """Four epochs with Jacobian and Hessian targets over three groups in
    batches of two (the tail of one padded), 32 of 64 points per step: the
    same batches (one numpy seed) and Adam in both packages; then
    ``evaluate_sobolev`` with the Hessian term."""
    t, x, u, ju, hu = _wave(G_=3)
    cfg_s = {**CFG_RES, "use_resblock": False}
    jm, _, tm = _models(cfg_s)
    jt = JaxGroupedTrainer(jm, optax.adam(1e-3), seed=3, w_jac=0.5, w_hess=0.05, fused=fused)
    js = jt.init(jax.random.key(1))
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=1e-3), seed=3, w_jac=0.5,
                        w_hess=0.05, fused=fused)
    ts = tt.init(1)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    kw = dict(epochs=4, group_batch=2, point_batch=32, target_jac=ju, target_hess=hu)
    js = jt.fit(js, t, x, u, **kw)
    ts = tt.fit(ts, t, x, u, **kw)
    assert ts.step == js.step == 8
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    # JAX's path keys: every step with Hessian targets under "sobolev_path"
    # (the port says "eager" where JAX says "xla"; the reasons name each
    # package's platform)
    mine = {k: v for k, v in tt.history.items() if "path" in k}
    ref = {k: v for k, v in jt.history.items() if "path" in k}
    assert mine.keys() == ref.keys() == {"sobolev_path", "sobolev_path_reason"}
    assert mine["sobolev_path"] == {"xla": "eager"}.get(ref["sobolev_path"], ref["sobolev_path"])
    mine = tt.evaluate_sobolev(ts, t, x, u, ju, group_batch=2, target_hess=hu)
    ref = jt.evaluate_sobolev(js, t, x, u, ju, group_batch=2, target_hess=hu)
    assert mine.keys() == ref.keys() and "hessian_mse" in mine
    for k in ref:
        assert mine[k] == pytest.approx(ref[k], rel=1e-4)


def test_hessian_fit_lowers_the_hessian_term():
    """A small CPU Hessian-target fit through plain K8 lowers the Hessian
    term that ``evaluate_sobolev`` reports; Hessian and Jacobian steps share
    one path record, ``history["sobolev_path"]``, whose first entry stands."""
    t, x, u, ju, hu = _wave(G_=4, P_=128, seed=9)
    _, _, tm = _models({**CFG_RES, "use_resblock": False, "omega_0": 3.0}, seed=2)
    tt = GroupedTrainer(tm, lambda p: torch.optim.Adam(p, lr=3e-3), seed=0, fused=True,
                        w_jac=0.1, w_hess=0.1)
    ts = tt.init(2)
    before = tt.evaluate_sobolev(ts, t, x, u, ju, target_hess=hu)
    ts = tt.fit(ts, t, x, u, epochs=20, group_batch=2, point_batch=64, target_jac=ju,
                target_hess=hu)
    after = tt.evaluate_sobolev(ts, t, x, u, ju, target_hess=hu)
    assert after["hessian_mse"] < before["hessian_mse"]
    assert after["total"] < before["total"]
    assert tt.history["sobolev_path"] == "eager" and "path" not in tt.history
    tt.fit(ts, t, x, u, epochs=1, group_batch=2, point_batch=64, target_jac=ju)
    assert tt.history["sobolev_path"] == "eager"
