"""The port's ShapeNet ops (``nif_tpu_torch.ops``) against the JAX package's
on the CPU: the weight unpacking, the eager grouped/point-wise chains, and
K1's plain version against the Pallas kernel run in interpret mode.

Inputs are made with numpy from a seed and handed to both packages, with
SIREN-regime weights (0.3/omega_0) as the JAX kernel tests use."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nif_tpu.config as jcfg
import nif_tpu.ops.pallas_shapenet as jps
import nif_tpu.ops.shapenet as jsn
import nif_tpu_torch.config as tcfg
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_shapenet as fs
from nif_tpu_torch.ops import shapenet as tsn

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


def _data(args, G=3, P=256, seed=0, pointwise=False):
    cfg = jcfg.ShapeNetConfig(*args)
    rng = np.random.default_rng(seed)
    po = jcfg.shapenet_param_count(cfg, 0)
    rows = (G * P,) if pointwise else (G,)
    wb = rng.standard_normal((*rows, po)) * (0.3 / cfg.omega_0)
    x = rng.standard_normal(((G * P,) if pointwise else (G, P)) + (cfg.input_dim,))
    return wb.astype(np.float32), x.astype(np.float32)


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulp_bf16(v):
    """The bf16 spacing at magnitude v."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_unpack_matches_jax(variant, args):
    wb, _ = _data(args)
    mine = tsn.unpack_shapenet_weights(torch.from_numpy(wb), tcfg.ShapeNetConfig(*args))
    ref = jsn.unpack_shapenet_weights(jnp.asarray(wb), jcfg.ShapeNetConfig(*args))
    assert set(mine) == set(ref)
    for k in ref:
        a, b = mine[k], ref[k]
        if not isinstance(b, list):
            a, b = [a], [b]
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def test_unpack_rejects_bad_sizes():
    cfg = tcfg.ShapeNetConfig(2, 1, 16, 1)
    with pytest.raises(ValueError, match="expected"):
        tsn.unpack_shapenet_weights(torch.zeros(2, 10), cfg)
    with pytest.raises(ValueError, match="connectivity"):
        tsn.unpack_shapenet_weights(
            torch.zeros(2, 10), tcfg.ShapeNetConfig(2, 1, 16, 1, connectivity="last_layer"))


@pytest.mark.parametrize("layout", ["grouped", "pointwise"])
@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_eager_f32_matches_jax(variant, args, layout):
    """f32: the same products summed in another order, rtol 1e-5."""
    wb, x = _data(args, G=3, P=16, seed=1, pointwise=layout == "pointwise")
    fn_t = getattr(tsn, f"shapenet_{layout}")
    fn_j = getattr(jsn, f"shapenet_{layout}")
    (wt, wj), (xt, xj) = _pair(wb, "float32"), _pair(x, "float32")
    out = fn_t(wt, xt, tcfg.ShapeNetConfig(*args), variant)
    ref = fn_j(wj, xj, jcfg.ShapeNetConfig(*args), variant)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_eager_bf16_matches_jax(variant, args):
    """bf16: both paths round every op's result to bf16 (matmul, omega
    scale, bias add, sine) but XLA and torch may fuse or accumulate before
    rounding in different places, so a last-bit flip in one activation can
    move the output by a few bf16 ulps: max|d| <= 8 ulps of max|out|."""
    wb, x = _data(args, seed=2)
    (wt, wj), (xt, xj) = _pair(wb, "bfloat16"), _pair(x, "bfloat16")
    out = tsn.shapenet_grouped(wt, xt, tcfg.ShapeNetConfig(*args), variant)
    ref = jsn.shapenet_grouped(wj, xj, jcfg.ShapeNetConfig(*args), variant)
    assert out.dtype == torch.bfloat16
    scale = np.abs(_np(ref)).max()
    assert np.abs(_np(out) - _np(ref)).max() <= 8 * _ulp_bf16(scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant,args", CASES, ids=IDS)
def test_k1_plain_matches_pallas_interpret(variant, args, dtype):
    """K1's plain version vs the Pallas kernel in interpret mode. f32: rtol
    2e-4, atol 1e-5 (the JAX kernel tests' bound). bf16: max|d| <= 2 bf16
    ulps of max|out| — both round the output to bf16 and both lift the
    activations to bf16 before each matmul; an f32 last-bit difference in
    the sum can flip one such rounding."""
    wb, x = _data(args, seed=3)
    (wt, wj), (xt, xj) = _pair(wb, dtype), _pair(x, dtype)
    out = fs.shapenet_grouped_fused(wt, xt, tcfg.ShapeNetConfig(*args), variant)
    ref = jps.shapenet_grouped_fused(wj, xj, jcfg.ShapeNetConfig(*args), variant, True)
    assert out.dtype == DTYPES[dtype][0] and tuple(out.shape) == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=1e-5)
    else:
        scale = np.abs(_np(ref)).max()
        assert np.abs(_np(out) - _np(ref)).max() <= 2 * _ulp_bf16(scale)


@pytest.mark.parametrize("degree", ["7", "9"])
def test_fast_sin_matches_jax(degree, monkeypatch):
    monkeypatch.setenv("NIF_SIN_DEGREE", degree)
    y = np.linspace(-60.0, 60.0, 20001, dtype=np.float32)
    out = fs.fast_sin(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, np.asarray(jps._fast_sin(jnp.asarray(y))), atol=2e-6)
    # the polynomials' own error, plus f32 evaluation at |y| up to 60
    err = 2.5e-4 if degree == "7" else 1.7e-5
    assert np.abs(out - np.sin(y.astype(np.float64))).max() <= err + 1e-5


REASON_CASES = [
    ("siren", jcfg.ShapeNetConfig(1, 1, 4, 1, "sine", connectivity="last_layer"), 256),
    ("vanilla", jcfg.ShapeNetConfig(2, 1, 16, 1, "gelu"), 256),
    ("vanilla", jcfg.ShapeNetConfig(2, 1, 16, 1, "softplus"), 256),
    ("siren", jcfg.ShapeNetConfig(2, 1, 4, 1, "sine"), 256),
    ("siren", jcfg.ShapeNetConfig(1, 1, 16, 1, "sine"), 257),
    ("siren", jcfg.ShapeNetConfig(3, 1, 128, 2, "sine"), 1000),
    ("siren", jcfg.ShapeNetConfig(3, 1, 128, 2, "sine"), 32768),
    ("siren", jcfg.ShapeNetConfig(3, 1, 256, 2, "sine", True), 1024),
    ("vanilla", jcfg.ShapeNetConfig(2, 3, 32, 2, "sine"), 8),
    ("vanilla", jcfg.ShapeNetConfig(2, 3, 32, 2, "silu"), 0),
]


@pytest.mark.parametrize("variant,cfg,P", REASON_CASES)
def test_unsupported_reason_matches_jax(variant, cfg, P):
    mine = fs.fused_unsupported_reason(tcfg.ShapeNetConfig(**cfg.to_dict()), variant, P)
    assert mine == jps.fused_unsupported_reason(cfg, variant, P)
    assert fs.fused_supported(tcfg.ShapeNetConfig(**cfg.to_dict()), variant, P) == (mine is None)


def test_unsupported_reason_past_the_kernel_width(monkeypatch):
    """The CUDA kernel's width limits come from its library and apply only
    on a CUDA device; the plain version elsewhere takes any width. Here the
    library's answer is stood in for, since building it needs nvcc."""
    asked = []

    def geometry(cfg, variant="siren", dtype=None):
        asked.append(cfg.units)
        return None, f"units={cfg.units} is wider than the CUDA kernel takes"

    monkeypatch.setattr(fs, "kernel_geometry", geometry)
    cfg = tcfg.ShapeNetConfig(3, 1, 1100, 1, "sine")
    assert fs.fused_unsupported_reason(cfg, "siren", 256) is None
    assert fs.fused_unsupported_reason(cfg, "siren", 256, torch.device("cpu")) is None
    assert not asked
    reason = fs.fused_unsupported_reason(cfg, "siren", 256, "cuda")
    assert "units=1100 is wider" in reason and asked == [1100]
    assert not fs.fused_supported(cfg, "siren", 256, "cuda")
    # the JAX package's config reasons come first and need no library
    cfg = tcfg.ShapeNetConfig(3, 1, 4, 1, "sine")
    assert "units=4 < 8" in fs.fused_unsupported_reason(cfg, "siren", 256, "cuda")
    assert asked == [1100, 1100]


def test_unsupported_config_runs_eager_like_jax():
    args = (1, 1, 16, 1, "sine", False, 30.0)
    wb, x = _data(args, P=257, seed=4)
    out = fs.shapenet_grouped_fused(torch.from_numpy(wb), torch.from_numpy(x),
                                    tcfg.ShapeNetConfig(*args), "siren")
    ref = jps.shapenet_grouped_fused(jnp.asarray(wb), jnp.asarray(x),
                                     jcfg.ShapeNetConfig(*args), "siren", True)
    assert tuple(out.shape) == (3, 257, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_prescale_rounds_at_the_compute_dtype():
    cfg = tcfg.ShapeNetConfig(2, 1, 8, 1, "sine", omega_0=30.0)
    wb = torch.linspace(-1, 1, tcfg.shapenet_param_count(cfg, 0)).to(torch.bfloat16)[None]
    out = fs._prescale(wb, cfg, "siren")
    k = 2 * 8 + 8 * 8
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0, :k], (wb[0, :k].float() * 30.0).to(torch.bfloat16))
    assert torch.equal(out[0, k:], wb[0, k:])
    assert fs._prescale(wb, cfg, "vanilla") is wb


def test_cuda_wrapper_refuses_cpu_tensors_and_grads():
    cfg = tcfg.ShapeNetConfig(2, 1, 16, 1, "sine")
    wb = torch.zeros(2, tcfg.shapenet_param_count(cfg, 0))
    x = torch.zeros(2, 8, 2)
    before = _build.LAUNCHES["shapenet_fwd"]
    with pytest.raises(ValueError, match="one CUDA device"):
        fs.shapenet_fwd_cuda(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd"] == before


def test_plain_version_is_taken_only_for_cpu_tensors(monkeypatch):
    """On a CPU tensor the public entry runs the plain version and never
    the kernel wrapper (which is what a CUDA tensor reaches)."""
    called = []
    monkeypatch.setattr(fs, "shapenet_fwd_cuda", lambda *a: called.append(a))
    args = (2, 1, 16, 1, "sine", False, 30.0)
    wb, x = _data(args, P=16)
    out = fs.shapenet_grouped_fused(torch.from_numpy(wb), torch.from_numpy(x),
                                    tcfg.ShapeNetConfig(*args), "siren")
    assert not called and tuple(out.shape) == (3, 16, 1)
