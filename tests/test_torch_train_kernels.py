"""The port's train kernels' plain versions against the JAX package on the
CPU: plain K2 (``shapenet_mse_grads``) against the Pallas train kernel in
interpret mode, and the differentiable ``shapenet_grouped_fused`` (plain K1
forward, plain K3 backward) against ``jax.vjp`` of the Pallas kernel in
interpret mode.

Inputs are made with numpy from a seed and handed to both packages, with
SIREN-regime weights (0.3/omega_0) as the JAX kernel tests use. Tolerances:

* float32: loss rel 1e-5 and ``d_wb`` normalized by max|ref| atol 5e-6
  (K2), ``d_wb`` and ``dx`` normalized atol 5e-5 (K3): the JAX kernel
  tests' bounds. Both sides sum in f32 in different orders (the Pallas
  kernel per point tile, the plain version over all P at once).
* bfloat16: loss rel 2e-3 and max|d| <= 2^-6 max|ref| for the gradients
  (two bf16 ulps at the top of the range). Both round every layer input,
  activation derivative and dz to bf16 at the same points, but an f32
  last-bit difference can flip one such rounding, and the JAX kernel also
  rounds each tile's bias-gradient column sum to bf16 before it
  accumulates the tiles in f32, which the port does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nif_tpu.config as jcfg
import nif_tpu.ops.pallas_shapenet as jps
import nif_tpu_torch.config as tcfg
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_shapenet as fs

torch.set_num_threads(1)

# The chain configs of tests/test_pallas_kernel.py.
CASES = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0)),
    ("siren", (2, 2, 64, 1, "sine", True, 10.0)),
    ("siren", (1, 1, 16, 3, "sine", False, 5.0)),
    ("vanilla", (2, 3, 32, 2, "swish")),
    ("vanilla", (1, 1, 16, 1, "tanh")),
    ("vanilla", (2, 1, 64, 2, "relu")),
]
IDS = [f"{v}-{a[2]}x{a[3]}{'-res' if len(a) > 5 and a[5] else ''}-{a[4]}" for v, a in CASES]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
G, P = 3, 256


def _data(args, seed):
    cfg = jcfg.ShapeNetConfig(*args)
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, jcfg.shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    tgt = rng.standard_normal((G, P, cfg.output_dim))
    w = rng.uniform(0.5, 1.5, (G, P))
    g = rng.standard_normal((G, P, cfg.output_dim)) * 0.1
    return [a.astype(np.float32) for a in (wb, x, tgt, w, g)]


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(mine, ref, dtype, atol):
    mine, ref = _np(mine), _np(ref)
    scale = np.abs(ref).max() + 1e-9
    if dtype == "float32":
        np.testing.assert_allclose(mine / scale, ref / scale, atol=atol)
    else:
        assert np.abs(mine - ref).max() <= 2.0 ** -6 * scale


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_k2_plain_matches_pallas_interpret(variant, args, dtype, weighted):
    wb, x, tgt, w, _ = _data(args, seed=3)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    weight_t = torch.from_numpy(w) if weighted else None
    weight_j = jnp.asarray(w) if weighted else None
    loss, d_wb = fs.shapenet_mse_grads(wt, xt, torch.from_numpy(tgt),
                                       tcfg.ShapeNetConfig(*args), variant, weight_t)
    l_ref, g_ref = jps.shapenet_mse_grads(wj, xj, jnp.asarray(tgt), jcfg.ShapeNetConfig(*args),
                                          variant, weight_j, True)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert d_wb.dtype == DTYPES[dtype][0] and tuple(d_wb.shape) == g_ref.shape
    rel = 1e-5 if dtype == "float32" else 2e-3
    assert float(loss) == pytest.approx(float(l_ref), rel=rel)
    _close(d_wb, g_ref, dtype, atol=5e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_k3_autograd_matches_jax_vjp(variant, args, dtype):
    """The port's ``shapenet_grouped_fused`` under autograd (plain K1, plain
    K3) against ``jax.vjp`` of the Pallas kernel in interpret mode."""
    wb, x, _, _, g = _data(args, seed=1)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    _, gj = _pair(g, dtype)
    wt.requires_grad_()
    xt.requires_grad_()
    out = fs.shapenet_grouped_fused(wt, xt, tcfg.ShapeNetConfig(*args), variant)
    out.backward(torch.from_numpy(g).to(out.dtype))
    cfg_j = jcfg.ShapeNetConfig(*args)
    _, vjp = jax.vjp(lambda a, b: jps.shapenet_grouped_fused(a, b, cfg_j, variant, True), wj, xj)
    dwb_ref, dx_ref = vjp(gj)
    assert wt.grad.dtype == wt.dtype and xt.grad.dtype == xt.dtype
    _close(wt.grad, dwb_ref, dtype, atol=5e-5)
    _close(xt.grad, dx_ref, dtype, atol=5e-5)


def test_k3_matches_autograd_of_plain_k1_in_f32():
    """In f32 the rounding points change nothing, so plain K3 is the
    autograd gradient of plain K1 (resblock chain, every branch)."""
    args = (2, 2, 64, 1, "sine", True, 10.0)
    wb, x, _, _, g = _data(args, seed=7)
    cfg = tcfg.ShapeNetConfig(*args)
    wt = torch.from_numpy(wb).double().requires_grad_()
    xt = torch.from_numpy(x).double().requires_grad_()
    fs.shapenet_grouped_fused_reference(wt, xt, cfg, "siren").backward(
        torch.from_numpy(g).double())
    d_wb, dx = fs.shapenet_fused_bwd_reference(torch.from_numpy(wb), torch.from_numpy(x),
                                               torch.from_numpy(g), cfg, "siren")
    np.testing.assert_allclose(d_wb.numpy(), wt.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("degree", ["7", "9"])
def test_fast_sin_grad_matches_jax(degree, monkeypatch):
    monkeypatch.setenv("NIF_SIN_DEGREE", degree)
    y = np.linspace(-60.0, 60.0, 20001, dtype=np.float32)
    d = fs.fast_sin_grad(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(d, np.asarray(jps._fast_sin_grad(jnp.asarray(y))), atol=2e-6)
    s, d2 = fs.fast_sin_and_grad(torch.from_numpy(y))
    np.testing.assert_array_equal(d2.numpy(), d)
    np.testing.assert_array_equal(s.numpy(), fs.fast_sin(torch.from_numpy(y)).numpy())
    # the derivative of a polynomial within 2.5e-4 (1.7e-5) of sin is near cos
    assert np.abs(d - np.cos(y.astype(np.float64))).max() <= (1e-2 if degree == "7" else 1e-3)


@pytest.mark.parametrize("name", ["tanh", "relu", "swish", "silu", "sigmoid", "linear", "sine"])
def test_vanilla_derivatives_match_jax(name):
    z = np.linspace(-4.0, 4.0, 801, dtype=np.float32)
    mine = fs._VANILLA_DERIVS[name](torch.from_numpy(z)).numpy()
    ref = np.asarray(jps._act_pair(name)[1](jnp.asarray(z)))
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6)


def test_unscale_grads_matches_jax():
    cfg = tcfg.ShapeNetConfig(2, 1, 8, 2, "sine", True, 30.0)
    po = tcfg.shapenet_param_count(cfg, 0)
    d = torch.linspace(-1, 1, po)[None]
    out = fs._unscale_grads(d, cfg, "siren")
    k = 2 * 8 + 4 * 64
    assert torch.equal(out[0, :k], d[0, :k] * 30.0) and torch.equal(out[0, k:], d[0, k:])
    assert fs._unscale_grads(d, cfg, "vanilla") is d


def test_k2_unsupported_config_runs_eager_like_jax():
    """P=257 has no point tile: both packages take value_and_grad over the
    eager chain."""
    args = (1, 1, 16, 1, "sine", False, 30.0)
    rng = np.random.default_rng(4)
    cfg = tcfg.ShapeNetConfig(*args)
    wb = (rng.standard_normal((2, tcfg.shapenet_param_count(cfg, 0))) * 0.01).astype(np.float32)
    x = rng.standard_normal((2, 257, 1)).astype(np.float32)
    tgt = rng.standard_normal((2, 257, 1)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 257)).astype(np.float32)
    loss, d_wb = fs.shapenet_mse_grads(torch.from_numpy(wb), torch.from_numpy(x),
                                       torch.from_numpy(tgt), cfg, "siren", torch.from_numpy(w))
    l_ref, g_ref = jps.shapenet_mse_grads(jnp.asarray(wb), jnp.asarray(x), jnp.asarray(tgt),
                                          jcfg.ShapeNetConfig(*args), "siren", jnp.asarray(w),
                                          True)
    assert not loss.requires_grad and not d_wb.requires_grad
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    _close(d_wb, g_ref, "float32", atol=5e-6)


def test_cpu_tensors_never_reach_the_cuda_wrappers(monkeypatch):
    """On CPU tensors K2 and K3 run their plain versions; the CUDA wrappers
    (what a CUDA tensor reaches) are not called and count no launch."""
    called = []
    monkeypatch.setattr(fs, "shapenet_mse_grads_cuda", lambda *a: called.append("k2"))
    monkeypatch.setattr(fs, "shapenet_bwd_cuda", lambda *a: called.append("k3"))
    args = (2, 1, 16, 1, "sine", False, 30.0)
    wb, x, tgt, _, g = _data(args, seed=5)
    cfg = tcfg.ShapeNetConfig(*args)
    before = dict(_build.LAUNCHES)
    loss, _ = fs.shapenet_mse_grads(torch.from_numpy(wb), torch.from_numpy(x),
                                    torch.from_numpy(tgt), cfg, "siren")
    wt = torch.from_numpy(wb).requires_grad_()
    fs.shapenet_grouped_fused(wt, torch.from_numpy(x), cfg, "siren").backward(
        torch.from_numpy(g))
    assert not called and bool(torch.isfinite(loss)) and wt.grad is not None
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name", ["shapenet_mse_grads_cuda", "shapenet_bwd_cuda",
                                  "_shapenet_mse_grads_simt", "_shapenet_bwd_simt"])
def test_train_wrappers_refuse_cpu_tensors(name):
    cfg = tcfg.ShapeNetConfig(2, 1, 16, 1, "sine")
    wb = torch.zeros(2, tcfg.shapenet_param_count(cfg, 0))
    x, third = torch.zeros(2, 8, 2), torch.zeros(2, 8, 1)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(fs, name)(wb, x, third, cfg, "siren")
    assert _build.LAUNCHES == before


def test_no_grad_forward_skips_the_autograd_function(monkeypatch):
    """Without a gradient to take, the fused forward runs plain K1 directly;
    with one it goes through the autograd Function (K3 in its backward)."""
    seen = []
    real = fs._FusedShapeNet.apply
    monkeypatch.setattr(fs._FusedShapeNet, "apply", lambda *a: seen.append(1) or real(*a))
    args = (2, 1, 16, 1, "sine", False, 30.0)
    wb, x, _, _, _ = _data(args, seed=6)
    cfg = tcfg.ShapeNetConfig(*args)
    with torch.no_grad():
        a = fs.shapenet_grouped_fused(torch.from_numpy(wb).requires_grad_(),
                                      torch.from_numpy(x), cfg, "siren")
    assert not seen and not a.requires_grad
    b = fs.shapenet_grouped_fused(torch.from_numpy(wb).requires_grad_(),
                                  torch.from_numpy(x), cfg, "siren")
    assert seen == [1] and b.requires_grad
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
