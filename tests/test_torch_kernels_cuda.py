"""The port's CUDA kernels on a card (marker ``cuda``; each test skips
without one). This file imports neither JAX nor ``nif_tpu``, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs are made with numpy from a seed. K1 is held against its plain
version on the same card: f32 rtol 2e-4 / atol 1e-5 (the JAX kernel tests'
bound; both sum in f32 in different orders); bf16 max|d| <= 1e-2 * max|plain|
(an f32 last-bit difference can flip the bf16 rounding of one activation).
K2 and K3 against their plain versions: f32 loss rel 1e-5 and gradients
max|d| <= 5e-6 (K2) / 5e-5 (K3) of max|plain| (the JAX kernel tests'
bounds); bf16 loss rel 1e-3 and max|d| <= 2^-6 of max|plain| (two bf16
ulps at the top of the range). K5 and K6 against theirs: f32 y and jac
rtol 2e-4 / atol 1e-5 of max|plain| (as K1), K6 terms rel 1e-5 and d_wb
max|d| <= 5e-5 of max|plain| (the fused-backward bound: the stacked
backward sums over (1 + si) times the rows); bf16 y, jac and d_wb within
2^-6 of max|plain| and the terms rel 1e-3. K7 and K8 against theirs, on
the SIREN configs (they take sine chains only): f32 y, jac and hess as K5,
K8 terms rel 1e-5 and d_wb max|d| <= 1e-4 of max|plain| (the JAX package's
bound for its fused Hessian train pass, whose backward sums ten times the
rows at si = 3); bf16 as K5/K6. K4 (the NIF-linear train pass) against its
plain version on SIREN trunks with so = 1, 2, 3: f32 loss rel 1e-5 and each
gradient max|d| <= 5e-5 of its max|plain| (the JAX package's bound for its
fused NIF-linear kernel: the trunk grads sum over every group); bf16 as K2.
bf16 K4 runs the tensor-core kernel (``shapenet_linear_tc.cu``), f32 K4 the
CUDA-core one (``shapenet_linear.cu``); both are held to the same bounds.
Likewise bf16 K7 and K8 run the tensor-core kernels (``shapenet_hess_tc.cu``),
f32 K7 and K8 the CUDA-core ones (``shapenet_hess.cu``); bf16 K6 on sine
chains the tensor-core kernel (``shapenet_jac_tc.cu``), f32 K6 and vanilla
chains the CUDA-core one (``shapenet_jac.cu``); bf16 K2 on sine chains the
tensor-core kernel (``shapenet_bwd_tc.cu``), f32 K2 and vanilla chains the
CUDA-core one (``shapenet_bwd.cu``), and K3 likewise (one body template
with K2 in each source); bf16 K1 and K5's reverse body on sine
chains the tensor-core kernels (``shapenet_fwd_wgmma.cu`` at widths 64 and
128, else ``shapenet_fwd_tc.cu``), K5's tangent body
(so >= si) the tensor-core one beside K6 (``shapenet_jac_tc.cu``), f32 and
vanilla chains the CUDA-core ones (``shapenet_fwd.cu``; ``shapenet_jac.cu``,
whose tangent body is K6's forward half, and the first port's stacked body
at si > 4); each checked by its launch counter and, for K5's tangent body,
the body its geometry names; the tensor-core
K6's terms within rel 1e-4 of the plain version's, the tensor-core K1, K2,
K3, K5 and K7 within the bf16 bounds above. A bf16 chain a tensor-core kernel
refuses for shared memory runs on the CUDA-core one."""
from pathlib import Path

import numpy as np
import pytest
import torch

import nif_tpu_torch
from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.ops import _build
from nif_tpu_torch.ops import fused_derivatives as fd
from nif_tpu_torch.ops import fused_hessian as fh
from nif_tpu_torch.ops import fused_linear as fl
from nif_tpu_torch.ops import fused_shapenet as fs

pytestmark = pytest.mark.cuda

# The chain configs of tests/test_pallas_kernel.py.
CASES = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0)),
    ("siren", (2, 2, 64, 1, "sine", True, 10.0)),
    ("siren", (1, 1, 16, 3, "sine", False, 5.0)),
    ("vanilla", (2, 3, 32, 2, "swish")),
    ("vanilla", (1, 1, 16, 1, "tanh")),
    ("vanilla", (2, 1, 64, 2, "relu")),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(cfg, G, P, dtype, seed):
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    return (torch.from_numpy(wb.astype(np.float32)).to("cuda", dtype),
            torch.from_numpy(x.astype(np.float32)).to("cuda", dtype))


def _max_diff(out, ref):
    """(max|out - ref|, max|ref|) in f32."""
    out, ref = out.float().cpu(), ref.float().cpu()
    return float((out - ref).abs().max()), float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", CASES)
def test_k1_matches_plain(card, variant, args, dtype):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 256, dtype, seed=5)
    # bf16 sine chains on a tensor-core K1 (wgmma at widths 64 and 128, else
    # mma.sync); f32 and vanilla chains on the CUDA-core one
    body = fs.k1_variant(dtype, cfg, variant)
    assert (body != "simt") == (dtype == torch.bfloat16 and variant == "siren")
    assert (body == "wgmma") == (body != "simt" and cfg.units in (64, 128))
    before = dict(_build.LAUNCHES)
    out = fs.shapenet_fwd_cuda(wb, x, cfg, variant)
    got, want = _launched("shapenet_fwd", before, body)
    assert got == want
    ref = fs.shapenet_grouped_fused_reference(wb, x, cfg, variant)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-4, atol=1e-5)
    else:
        err, scale = _max_diff(out, ref)
        assert err <= 1e-2 * scale


def test_k1_masks_a_ragged_tile_and_loops_groups(card):
    """P = 264 fills only 8 rows of the last 64-point tile: the kernel masks
    the rest. Five groups, one block row each."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 5, 264, torch.bfloat16, seed=6)
    out = fs.shapenet_fwd_cuda(wb, x, cfg, "siren")
    ref = fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren")
    err, scale = _max_diff(out, ref)
    assert bool(torch.isfinite(out).all()) and err <= 1e-2 * scale


def test_k1_refuses_what_it_cannot_take(card):
    cfg = ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x = _data(cfg, 2, 16, torch.float32, seed=7)
    with pytest.raises(TypeError):
        fs.shapenet_fwd_cuda(wb.double(), x.double(), cfg, "siren")
    with pytest.raises(RuntimeError, match="no backward"):
        fs.shapenet_fwd_cuda(wb.requires_grad_(), x, cfg, "siren")
    with pytest.raises(ValueError, match="pad P"):
        fs.shapenet_fwd_cuda(wb.detach(), x[:, :13], cfg, "siren")


def test_launch_shapes(card):
    """The kernel's library owns its launch geometry: points per tile by
    width (stack_simt.cuh's layouts: 128-point tiles up to width 64), and the
    widths it refuses."""
    mk = lambda n, si=3: ShapeNetConfig(si, 1, n, 2, "sine")  # noqa: E731
    assert fs.kernel_geometry(mk(128)) == (64, None)
    assert fs.kernel_geometry(mk(256)) == (32, None)
    assert fs.kernel_geometry(mk(16)) == (128, None)
    assert fs.kernel_geometry(mk(1024)) == (8, None)
    for n in (8, 30, 100, 500):
        assert fs.kernel_geometry(mk(n))[1] is None
    assert "units=1025 is wider" in fs.kernel_geometry(mk(1025))[1]
    assert "shared memory" in fs.kernel_geometry(mk(16, si=4000))[1]
    assert "units=1025" in fs.fused_unsupported_reason(mk(1025), "siren", 256, card)
    assert fs.fused_unsupported_reason(mk(1025), "siren", 256, "cpu") is None


def test_model_on_the_card_routes_through_k1(card):
    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
             "activation": "sine", "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "mixed_bfloat16", seed=0)
    assert model.device.type == "cuda" and model.fast_path_info(512)["path"] == "fused"
    rng = np.random.default_rng(8)
    t = rng.standard_normal((4, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32)
    before = _build.LAUNCHES["shapenet_fwd"]
    fwd = dict(_build.LAUNCHES)
    with torch.inference_mode():
        out = model.apply_grouped(t, x)
        wb = model.p_to_w(t)
        ref = fs.shapenet_grouped_fused_reference(
            wb, model.policy.cast_to_compute(x, device="cuda"), model.cfg_shape_net, "siren")
    # the flagship chain's bf16 K1 on the wgmma body
    assert fs.k1_variant(torch.bfloat16, model.cfg_shape_net, "siren") == "wgmma"
    got, want = _launched("shapenet_fwd", fwd, "wgmma")
    assert got == want
    err, scale = _max_diff(out, ref)
    assert out.dtype == torch.float32 and err <= 1e-2 * scale
    # with gradients needed, auto routing runs K1 forward and K3 backward;
    # fused=False is the eager autograd path and launches neither
    bwd = dict(_build.LAUNCHES)
    out = model.apply_grouped(t, x)
    assert out.requires_grad and _build.LAUNCHES["shapenet_fwd"] == before + 2
    out.sum().backward()
    # the bf16 K3 on the tensor-core body its routing picks
    body = fs.k3_variant(torch.bfloat16, model.cfg_shape_net, "siren")
    assert body in ("wgmma", "tc")
    got, want = _launched("shapenet_bwd", bwd, body)
    assert got == want
    out = model.apply_grouped(t, x, fused=False)
    assert out.requires_grad and _build.LAUNCHES["shapenet_fwd"] == before + 2


def _launched(base, before, body, n=1):
    """(launches of K1, base "shapenet_fwd", K2, "shapenet_mse_grads", K3,
    "shapenet_bwd", K5, "shapenet_fwd_jac", K7, "shapenet_fwd_hess", or K8,
    "shapenet_hessian_grads", since ``before`` under the kernel's counter and
    each bf16 body's, and what ``n`` launches on ``body`` ("wgmma", "tc" or
    "simt") add)."""
    names = (base, base + "_tc", base + "_wg")
    return ({k: _build.LAUNCHES[k] - before[k] for k in names},
            {base: n, base + "_tc": n * (body == "tc"), base + "_wg": n * (body == "wgmma")})


def _side(cfg, G, P, dtype, seed):
    rng = np.random.default_rng(seed + 1000)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (to(rng.standard_normal((G, P, cfg.output_dim))), to(rng.uniform(0.5, 1.5, (G, P))),
            to(rng.standard_normal((G, P, cfg.output_dim)) * 0.1).to(dtype))


def _bounds(dtype):
    """(loss rel, K2 gradient, K3 gradient) bounds, as the docstring says."""
    return (1e-5, 5e-6, 5e-5) if dtype == torch.float32 else (1e-3, 2.0 ** -6, 2.0 ** -6)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", CASES)
def test_k2_matches_plain(card, variant, args, dtype, weighted):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 256, dtype, seed=9)
    tgt, w, _ = _side(cfg, 3, 256, dtype, seed=9)
    w = w if weighted else None
    before = dict(_build.LAUNCHES)
    loss, d_wb = fs.shapenet_mse_grads(wb, x, tgt, cfg, variant, w)
    # bf16 sine chains on a tensor-core body (wgmma where its geometry takes
    # the chain), f32 and vanilla chains on the CUDA-core one
    body = fs.k2_geometry(cfg, variant, 3, 256, dtype)["kernel"]
    assert (body != "simt") == (dtype == torch.bfloat16 and variant == "siren")
    got, want = _launched("shapenet_mse_grads", before, body)
    assert got == want
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, variant, w)
    l_rel, g_bound, _ = _bounds(dtype)
    assert loss.dtype == torch.float32 and d_wb.dtype == dtype
    assert float(loss) == pytest.approx(float(l_ref), rel=l_rel)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= g_bound * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", CASES)
def test_k3_matches_plain(card, variant, args, dtype):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 256, dtype, seed=10)
    g = _side(cfg, 3, 256, dtype, seed=10)[2]
    before = dict(_build.LAUNCHES)
    d_wb, dx = fs.shapenet_bwd_cuda(wb, x, g, cfg, variant)
    # bf16 sine chains on a tensor-core K3 body; f32 and vanilla chains on the CUDA-core one
    body = fs.k3_geometry(cfg, variant, 3, 256, dtype)["kernel"]
    assert (body != "simt") == (dtype == torch.bfloat16 and variant == "siren")
    got, want = _launched("shapenet_bwd", before, body)
    assert got == want
    r_wb, r_dx = fs.shapenet_fused_bwd_reference(wb, x, g, cfg, variant)
    bound = _bounds(dtype)[2]
    assert d_wb.dtype == dtype and dx.dtype == dtype and dx.shape == x.shape
    for mine, ref in ((d_wb, r_wb), (dx, r_dx)):
        err, scale = _max_diff(mine, ref)
        assert err <= bound * scale


def test_k2_k3_ragged_tiles_and_determinism(card):
    """P = 264 leaves 8 rows in the last tile; K2 twice on one input gives
    the same bits (fixed P splits, no float atomics), and so does the
    tensor-core K3 (bf16), both within the bf16 bounds of their plain
    versions; the float32 K3 within 5e-5 of its plain version."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 5, 264, torch.bfloat16, seed=11)
    tgt, w, g = _side(cfg, 5, 264, torch.bfloat16, seed=11)
    runs = [fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, "siren", w) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    err, scale = _max_diff(runs[0][1], g_ref)
    assert float(runs[0][0]) == pytest.approx(float(l_ref), rel=1e-3) and err <= 2.0 ** -6 * scale
    before = dict(_build.LAUNCHES)
    bwd = [fs.shapenet_bwd_cuda(wb, x, g, cfg, "siren") for _ in range(2)]
    got, want = _launched("shapenet_bwd", before, fs.k3_variant(torch.bfloat16, cfg, "siren"), 2)
    assert got == want
    assert torch.equal(bwd[0][0], bwd[1][0]) and torch.equal(bwd[0][1], bwd[1][1])
    for mine, ref in zip(bwd[0], fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)
    d_wb, dx = fs.shapenet_bwd_cuda(wb.float(), x.float(), g.float(), cfg, "siren")
    r_wb, r_dx = fs.shapenet_fused_bwd_reference(wb.float(), x.float(), g.float(), cfg, "siren")
    for mine, ref in ((d_wb, r_wb), (dx, r_dx)):
        err, scale = _max_diff(mine, ref)
        assert err <= 5e-5 * scale


def test_train_geometry(card):
    """At the flagship width the f32 planes of a 64-point tile (the residuals
    of the CUDA-core K2/K3, in f32 for both dtypes) fit in shared memory
    beside the weight buffers, and the grid is one wave of one block per SM;
    a third hidden layer, or width 512, puts them in the per-block global
    scratch."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        geo = fs.train_geometry(cfg, 32, 32768, dtype)
        assert (geo["tile"], geo["splits"], geo["residuals"], geo["scratch_bytes"]) == (
            64, sms // 32, "shared", 0)
        assert geo["smem_bytes"] <= 232448
    assert fs.train_geometry(cfg, 2, 100, torch.bfloat16)["splits"] == 2
    deep = lambda n, l: ShapeNetConfig(3, 1, n, l, "sine", False, 30.0)  # noqa: E731
    geo = fs.train_geometry(deep(128, 3), 2, 64, torch.float32)
    assert geo["residuals"] == "global" and geo["scratch_bytes"] > 0
    assert fs.train_geometry(deep(512, 2), 2, 64, torch.float32)["residuals"] == "global"


def test_train_wrappers_refuse_what_they_cannot_take(card):
    cfg = ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x = _data(cfg, 2, 16, torch.float32, seed=12)
    tgt, w, g = _side(cfg, 2, 16, torch.float32, seed=12)
    with pytest.raises(RuntimeError, match="no backward"):
        fs.shapenet_mse_grads_cuda(wb.clone().requires_grad_(), x, tgt, cfg, "siren")
    with pytest.raises(ValueError, match="target"):
        fs.shapenet_mse_grads_cuda(wb, x, tgt[:, :8], cfg, "siren")
    with pytest.raises(ValueError, match="weight"):
        fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, "siren", w[:, :8])
    with pytest.raises(ValueError, match="g_out"):
        fs.shapenet_bwd_cuda(wb, x, g[:1], cfg, "siren")
    with pytest.raises(TypeError):
        fs.shapenet_bwd_cuda(wb, x.bfloat16(), g, cfg, "siren")


def test_model_train_step_on_the_card_launches_k2(card):
    """One GroupedTrainer step at a small shape: exactly one K2 launch, and
    the step's loss and grads match plain K2 + autograd through the
    ParameterNet on the same card."""
    from nif_tpu_torch.training import GroupedTrainer

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
             "activation": "sine", "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "mixed_bfloat16", seed=0)
    rng = np.random.default_rng(13)
    t = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.standard_normal((4, 512, 1)).astype(np.float32)).cuda()
    loss, grads = model.mse_value_and_grad(t, x, u)
    wb, _ = model.pnet(model._compute(t))
    l_ref, d_ref = fs.shapenet_mse_grads_reference(wb.detach(), model._compute(x), u,
                                                   model.cfg_shape_net, "siren")
    refs = torch.autograd.grad(wb, [p for _, p in model.param_items()], d_ref)
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
    for (path, _), ref in zip(model.param_items(), refs):
        mine = grads
        for key in path:
            mine = mine[key]
        assert float((mine - ref).norm()) <= 1e-2 * float(ref.norm()) + 1e-12
    trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4))
    state = trainer.init(0)
    before = dict(_build.LAUNCHES)
    state, loss = trainer.step(state, t, x, u)
    got, want = _launched("shapenet_mse_grads", before,
                          fs.k2_variant(torch.bfloat16, model.cfg_shape_net, "siren"))
    assert got == want and want["shapenet_mse_grads_tc"] + want["shapenet_mse_grads_wg"] == 1
    assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"]
    assert bool(torch.isfinite(loss)) and trainer.history["path"] == "fused"
    # the float32 policy runs the CUDA-core K2
    f32 = GroupedTrainer(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "float32", seed=0),
                         lambda p: torch.optim.Adam(p, lr=1e-4))
    before = dict(_build.LAUNCHES)
    _, loss = f32.step(f32.init(0), t, x, u)
    got, want = _launched("shapenet_mse_grads", before, "simt")
    assert got == want
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("policy", ["mixed_bfloat16", "float32"])
@pytest.mark.parametrize("capturable", [True, False], ids=["whole-step", "opt-after-replay"])
def test_fit_resident_replays_match_the_eager_loop(card, policy, capturable):
    """``fit_resident``'s CUDA-graph replays against a loop of
    ``GroupedTrainer.step`` on a copy of the model over the same batches
    (re-drawn from the seed): the same losses and parameters, bit for bit;
    the whole step captured with a capturable Adam, else ``opt.step()``
    after each replay."""
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.training.resident import ResidentData

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
             "activation": "sine", "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    rng = np.random.default_rng(17)
    t = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (8, 1024, 3)).astype(np.float32)
    u = rng.standard_normal((8, 1024, 1)).astype(np.float32)

    def trainer():
        tr = GroupedTrainer(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, seed=0),
                            lambda p: torch.optim.Adam(p, lr=1e-4, capturable=capturable))
        return tr, tr.init(0)

    tr, st = trainer()
    st = tr.fit_resident(st, t, x, u, epochs=3, group_batch=4, point_batch=512, seed=2)
    assert tr.history["resident_graph"] == ("step" if capturable else "forward_backward")
    assert len(tr.history["resident_capture_ms"]) == 1 and st.step == 6
    ref, rst = trainer()
    data = ResidentData(t, x, u, group_batch=4, point_batch=512, seed=2, device="cuda")
    losses = []
    for i in range(6):
        rst, loss = ref.step(rst, **data.batch())
        losses.append(loss)
    eager = torch.stack(losses).double().cpu().numpy().reshape(3, 2).mean(axis=1)
    assert tr.history["loss"] == list(eager)
    for a, b in zip(tr.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("residual", [False, True], ids=["uniform", "residual"])
def test_resident_draws_replay_as_drawn_eagerly(card, residual):
    """The resident sampler's batches, replayed as a CUDA graph with its
    generator registered (after one eager draw, as ``fit_resident`` warms
    up, and under ``torch.profiler``), are the batches an eager twin draws
    from the same seed, in the same order, bit for bit."""
    from nif_tpu_torch.training.resident import ResidentData

    rng = np.random.default_rng(3)
    G, P = 16, 4096
    t = rng.standard_normal((G, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    u = rng.standard_normal((G, P, 1)).astype(np.float32)
    kw = dict(group_batch=8, point_batch=1024, seed=2**63 - 5, residual=residual)
    eager, graphed = ResidentData(t, x, u, **kw), ResidentData(t, x, u, **kw)
    assert eager.device.type == "cuda"
    if residual:
        probs = rng.uniform(0.1, 1.0, (G, P))
        eager.set_probs(probs)
        graphed.set_probs(probs)
    want = [eager.batch() for _ in range(4)]
    got = [graphed.batch()]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(graphed.generator)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with torch.cuda.graph(graph):
            out = graphed.batch()
        for _ in range(3):
            graph.replay()
            got.append({k: None if v is None else v.clone() for k, v in out.items()})
    for a, b in zip(want, got):
        for k in ("t", "x", "u"):
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(want[0]["x"], want[1]["x"])


# Widths past the flagship run the wider template instances (8, 16 and 32
# columns per thread; TP = 32, 16 and 8 points per tile); the last two
# chains keep the CUDA-core K2/K3's residuals in the global scratch in both
# dtypes (bf16 K3 on both, the bf16 CUDA-core K2 on the vanilla chain).
WIDE = [
    ("siren", (3, 1, 256, 2, "sine", False, 30.0)),
    ("siren", (3, 1, 128, 2, "sine", True, 30.0)),
    ("siren", (2, 2, 512, 1, "sine", False, 30.0)),
    ("vanilla", (3, 2, 1024, 1, "tanh")),
    ("siren", (3, 1, 128, 3, "sine", False, 30.0)),
    ("vanilla", (3, 2, 1024, 2, "tanh")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", WIDE)
def test_wide_chains_match_plain(card, variant, args, dtype):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 2, 200, dtype, seed=14)
    tgt, w, g = _side(cfg, 2, 200, dtype, seed=14)
    l_rel, g_bound, k3_bound = _bounds(dtype)
    out = fs.shapenet_fwd_cuda(wb, x, cfg, variant)
    err, scale = _max_diff(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, variant))
    assert err <= (1e-5 + 2e-4 * scale if dtype == torch.float32 else 1e-2 * scale)
    loss, d_wb = fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, variant, w)
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, variant, w)
    assert float(loss) == pytest.approx(float(l_ref), rel=l_rel)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= g_bound * scale
    d_wb, dx = fs.shapenet_bwd_cuda(wb, x, g, cfg, variant)
    r_wb, r_dx = fs.shapenet_fused_bwd_reference(wb, x, g, cfg, variant)
    for mine, ref in ((d_wb, r_wb), (dx, r_dx)):
        err, scale = _max_diff(mine, ref)
        assert err <= k3_bound * scale


# K5's tangent body runs where so >= si; the configs with so < si (and the
# flagship) take the reverse body.
JAC_EXTRA = [("siren", (2, 3, 64, 2, "sine", False, 30.0))]


def _close_rel(mine, ref, dtype):
    err, scale = _max_diff(mine, ref)
    bound = 2e-4 * scale + 1e-5 if dtype == torch.float32 else 2.0 ** -6 * scale
    assert err <= bound, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", CASES + JAC_EXTRA)
def test_k5_matches_plain(card, variant, args, dtype):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 264, dtype, seed=15)
    # both bodies of bf16 sine chains on a tensor-core K5 (the reverse body
    # for so < si, on wgmma at widths 64 and 128; the tangent body otherwise)
    body = fd.k5_variant(dtype, cfg, variant)
    assert (body != "simt") == (dtype == torch.bfloat16 and variant == "siren")
    reverse = fd._jac_mode(cfg, cfg.input_dim) == "reverse"
    assert (body == "wgmma") == (body != "simt" and reverse and cfg.units in (64, 128))
    before = dict(_build.LAUNCHES)
    y, jac = fd.shapenet_fwd_jac(wb, x, cfg, variant)
    got, want = _launched("shapenet_fwd_jac", before, body)
    assert got == want
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, variant)
    assert y.dtype == jac.dtype == dtype and jac.shape == (3, 264, cfg.output_dim, cfg.input_dim)
    _close_rel(y, y_ref, dtype)
    _close_rel(jac, jac_ref, dtype)


# K5's tangent body (so >= si) beyond CASES: tutorial 8's chain (1 -> 1,
# width 30), si = so = 2 on a resblock chain, si = so = 4 at widths 16 and
# 192 (two column blocks a warp in the tensor-core body), and a vanilla
# chain, which bf16 runs on the CUDA-core body; si = so = 5 takes the
# stacked body in both dtypes. (variant, args, body in f32, body in bf16)
TANGENT_CASES = [
    ("siren", (1, 1, 30, 2, "sine", False, 30.0), "simt", "tc"),
    ("siren", (2, 2, 64, 2, "sine", True, 10.0), "simt", "tc"),
    ("siren", (4, 4, 16, 2, "sine", False, 30.0), "simt", "tc"),
    ("siren", (4, 4, 192, 1, "sine", False, 30.0), "simt", "tc"),
    ("vanilla", (2, 3, 48, 2, "swish"), "simt", "simt"),
    ("siren", (5, 5, 32, 1, "sine", False, 30.0), "stacked", "stacked"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args,f32_body,bf16_body", TANGENT_CASES,
                         ids=["tutorial8", "si2-res", "si4-n16", "si4-n192", "vanilla", "si5"])
def test_k5_tangent_bodies_match_plain(card, variant, args, f32_body, bf16_body, dtype):
    """K5's tangent body at P = 200 (a ragged last tile) against plain K5,
    through the body its geometry names: the tensor-core one (counted under
    ``shapenet_fwd_jac_tc`` too), the CUDA-core K6's forward half ("simt")
    or, for si > 4, the first port's "stacked" body; y and jac within K5's
    bounds."""
    cfg = ShapeNetConfig(*args)
    body = f32_body if dtype == torch.float32 else bf16_body
    geo = fd.derivative_geometry("tangent", cfg, variant, 3, 200, dtype)
    assert geo["body"] == body and fd.k5_variant(dtype, cfg, variant) == (
        "tc" if body == "tc" else "simt")
    wb, x = _data(cfg, 3, 200, dtype, seed=48)
    before = dict(_build.LAUNCHES)
    y, jac = fd.shapenet_fwd_jac(wb, x, cfg, variant)
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
    assert (_build.LAUNCHES["shapenet_fwd_jac_tc"]
            == before["shapenet_fwd_jac_tc"] + int(body == "tc"))
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, variant)
    assert y.dtype == jac.dtype == dtype and jac.shape == (3, 200, cfg.output_dim, cfg.input_dim)
    _close_rel(y, y_ref, dtype)
    _close_rel(jac, jac_ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_tangent_body_flagship_width_is_deterministic(card, dtype):
    """si = so = 3 at the flagship width, G=4, P=8192: float32 on the
    CUDA-core body (K6's forward half), bf16 on the tensor-core one; two
    runs give the same bits and agree with plain K5; the CUDA-core body on
    the same bf16 inputs agrees too."""
    cfg = ShapeNetConfig(3, 3, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 4, 8192, dtype, seed=49)
    before = dict(_build.LAUNCHES)
    runs = [fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren") for _ in range(2)]
    tc = 2 * int(dtype == torch.bfloat16)
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 2
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"] + tc
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _close_rel(runs[0][0], y_ref, dtype)
    _close_rel(runs[0][1], jac_ref, dtype)
    if dtype == torch.bfloat16:
        y, jac = fd._shapenet_fwd_jac_simt(wb, x, cfg, "siren")
        _close_rel(y, y_ref, dtype)
        _close_rel(jac, jac_ref, dtype)


def _sobolev_side(cfg, G, P, seed):
    rng = np.random.default_rng(seed + 2000)
    si, so = cfg.input_dim, cfg.output_dim
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (to(rng.standard_normal((G, P, so))), to(rng.standard_normal((G, P, si * so))),
            to(rng.uniform(0.5, 1.5, (G, P))))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", CASES)
def test_k6_matches_plain(card, variant, args, dtype, weighted):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 264, dtype, seed=16)
    tgt, jt, w = _sobolev_side(cfg, 3, 264, seed=16)
    w = w if weighted else None
    si, so = cfg.input_dim, cfg.output_dim
    # masks on the multi-output configs: the first output, every other jac entry
    y_mask = np.eye(1, so, dtype=np.float32)[0] if so > 1 else None
    jac_mask = (np.arange(si * so) % 2 == 0).astype(np.float32) if so > 1 else None
    kw = dict(w_value=0.7, w_jac=1.3, y_mask=y_mask, jac_mask=jac_mask, weight=w)
    before = dict(_build.LAUNCHES)
    lv, lj, d_wb = fd.shapenet_sobolev_grads(wb, x, tgt, jt, cfg, variant, **kw)
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 1
    # bf16 sine chains on the tensor-core K6; f32 and vanilla chains on the CUDA-core one
    tc = dtype == torch.bfloat16 and variant == "siren"
    assert (_build.LAUNCHES["shapenet_sobolev_grads_tc"]
            == before["shapenet_sobolev_grads_tc"] + int(tc))
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, variant, **kw)
    rel = 1e-5 if dtype == torch.float32 else (1e-4 if tc else 1e-3)
    assert float(lv) == pytest.approx(float(rv), rel=rel)
    assert float(lj) == pytest.approx(float(rj), rel=rel)
    assert d_wb.dtype == dtype
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= (5e-5 if dtype == torch.float32 else 2.0 ** -6) * scale, (err, scale)


def test_k6_flagship_width_is_deterministic(card):
    """G=4, P=2048 at the flagship width in bf16, on the tensor-core kernel:
    two runs give the same bits (fixed P splits, an ordered reduce) and
    agree with plain K6."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 4, 2048, torch.bfloat16, seed=17)
    tgt, jt, _ = _sobolev_side(cfg, 4, 2048, seed=17)
    before = _build.LAUNCHES["shapenet_sobolev_grads_tc"]
    runs = [fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren") for _ in range(2)]
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before + 2
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, "siren")
    assert float(runs[0][0]) == pytest.approx(float(rv), rel=1e-4)
    assert float(runs[0][1]) == pytest.approx(float(rj), rel=1e-4)
    err, scale = _max_diff(runs[0][2], r_wb)
    assert err <= 2.0 ** -6 * scale


def test_derivative_geometry(card):
    """At the flagship width bf16 K6 takes the tensor-core kernel: 32-point
    tiles (128 stacked rows) with every S plane and the staged W in shared
    memory, and one wave of SMs / G splits per group; f32 K6 takes the
    CUDA-core kernel, its residuals in the global scratch. The reverse K5
    body in bf16 takes the wgmma body, and the mma.sync body by name, both
    on 128-point tiles, their act' and both W in shared memory, one wave of
    SMs / G splits; the CUDA-core
    reverse body (float32's, shapenet_fwd.cu's, one body with the CUDA-core
    K1) takes K2's 64-point tile, its four planes in shared memory (bf16's
    in the global scratch), and one wave of one block per SM over every
    group's tiles. f32 K6
    takes the CUDA-core body on the f32 tile machinery: 16-point tiles (64
    stacked rows), its planes in shared memory, one wave of SMs / G splits
    per group; at width 1024 its planes go to the global scratch; si > 4
    keeps the stacked_kernel body."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    sob = fd.derivative_geometry("sobolev", cfg, "siren", 32, 32768, torch.bfloat16)
    assert (sob["kernel"], sob["tile"], sob["residuals"], sob["weights"]) == (
        "tc", 32, "shared", "shared")
    assert sob["splits"] == max(1, min(64, sms // 32))
    f32 = fd.derivative_geometry("sobolev", cfg, "siren", 32, 32768, torch.float32)
    assert f32["kernel"] == "simt" and fd.k6_variant(torch.float32, cfg) == "simt"
    assert (f32["tile"], f32["residuals"], f32["scratch_bytes"]) == (16, "shared", 0)
    assert f32["splits"] == max(1, min(64, sms // 32))
    assert f32["partial_floats"] == 32 * f32["splits"] * (-(-33665 // 4) * 4 + 2)
    wide = fd.derivative_geometry("sobolev", ShapeNetConfig(3, 1, 1024, 1, "sine"), "siren",
                                  4, 256, torch.float32)
    assert wide["residuals"] == "global" and wide["scratch_bytes"] > 0
    si5 = fd.derivative_geometry("sobolev", ShapeNetConfig(5, 1, 64, 1, "sine"), "siren", 4,
                                 256, torch.float32)
    assert si5["tile"] == 64 // 6 and si5["kernel"] == "simt"
    for G in (1, 4, 32):
        rev = fd.derivative_geometry("reverse", cfg, "siren", G, 32768, torch.bfloat16)
        assert (rev["kernel"], rev["tile"], rev["residuals"], rev["weights"]) == (
            "wgmma", 128, "shared", "shared")
        assert rev["splits"] == min(256, max(1, sms // G))
        rev = fd._geometry("reverse", cfg, "siren", G, 32768, torch.bfloat16, kernel="tc")
        assert (rev["kernel"], rev["tile"], rev["residuals"], rev["weights"]) == (
            "tc", 128, "shared", "shared")
        assert rev["splits"] == min(256, max(1, sms // G))
        for dtype in (torch.float32, torch.bfloat16):
            rev = fd._geometry("reverse", cfg, "siren", G, 32768, dtype, kernel="simt")
            assert (rev["kernel"], rev["body"]) == ("simt", "simt")
            # bf16 (the shapes the tensor-core K5 refuses) keeps its planes
            # in the global scratch
            planes = "shared" if dtype == torch.float32 else "global"
            assert (rev["tile"], rev["residuals"], rev["blocks_per_sm"]) == (64, planes, 1)
            assert rev["blocks"] == min(sms, G * 512)
    assert fd.derivative_geometry("reverse", cfg, "siren", 4, 32768,
                                  torch.float32)["kernel"] == "simt"
    # K5's tangent body at si = so = 3: float32 on K6's forward half, 16-point
    # tiles, its two planes in shared memory, two blocks per SM in one wave;
    # bf16 on the tensor-core body, 32-point tiles, two blocks per SM
    tan = ShapeNetConfig(3, 3, 128, 2, "sine", False, 30.0)
    t32 = fd.derivative_geometry("tangent", tan, "siren", 32, 32768, torch.float32)
    assert (t32["kernel"], t32["body"], t32["tile"], t32["residuals"]) == (
        "simt", "simt", 16, "shared")
    assert t32["blocks"] == t32["blocks_per_sm"] * sms and t32["blocks_per_sm"] == 2
    t16 = fd.derivative_geometry("tangent", tan, "siren", 32, 32768, torch.bfloat16)
    assert (t16["kernel"], t16["body"], t16["tile"], t16["blocks_per_sm"]) == ("tc", "tc", 32, 2)
    assert t16["blocks"] == 2 * sms and t16["scratch_bytes"] == 0
    si5 = fd.derivative_geometry("tangent", ShapeNetConfig(5, 5, 64, 1, "sine"), "siren", 4,
                                 256, torch.float32)
    assert si5["body"] == "stacked" and si5["tile"] == 64 // 6
    assert "streams" in fd.sobolev_fused_unsupported_reason(
        ShapeNetConfig(9, 1, 1024, 1, "sine"), "siren", 256, 9, card)


def test_derivative_wrappers_refuse_what_they_cannot_take(card):
    cfg = ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x = _data(cfg, 2, 16, torch.float32, seed=18)
    tgt, jt, w = _sobolev_side(cfg, 2, 16, seed=18)
    with pytest.raises(RuntimeError, match="no backward"):
        fd.shapenet_fwd_jac_cuda(wb.clone().requires_grad_(), x, cfg, "siren")
    with pytest.raises(ValueError, match="jac_target"):
        fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt[..., :1], cfg, "siren")
    with pytest.raises(ValueError, match="weight"):
        fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", weight=w[:, :8])
    with pytest.raises(TypeError):
        fd.shapenet_sobolev_grads_cuda(wb, x.bfloat16(), tgt, jt, cfg, "siren")


# Shapes the tensor-core K1 pads, tiles raggedly or lays out otherwise: the
# tensor-core K2's (widths 24 and 40, si = 1 and 4, resblock chains, width 256
# with W read from global memory, width 384) and NIF-linear's trunk, whose
# last product has 128 columns.
K1_TC_SHAPES = [
    (3, 1, 24, 2, "sine", False, 30.0),
    (2, 2, 40, 2, "sine", True, 10.0),
    (1, 1, 64, 2, "sine", False, 30.0),
    (4, 1, 128, 2, "sine", False, 30.0),
    (3, 1, 128, 2, "sine", True, 30.0),
    (3, 1, 256, 2, "sine", True, 30.0),
    (1, 1, 384, 1, "sine", False, 30.0),
    (3, 128, 128, 2, "sine", False, 30.0),
]


@pytest.mark.parametrize("args", K1_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4", "n128-res",
                                                    "n256-res", "n384", "so128"])
def test_k1_tc_padded_and_ragged_shapes(card, args):
    """The tensor-core (mma.sync) K1 at P = 200 (a ragged last tile) and
    four groups, against plain K1: within 1e-2 of max|plain|. The chains at
    widths 64 and 128 route to the wgmma body, so the mma.sync body runs by
    name."""
    cfg = ShapeNetConfig(*args)
    assert fs.k1_variant(torch.bfloat16, cfg, "siren") == (
        "wgmma" if cfg.units in (64, 128) and cfg.output_dim <= 4 else "tc")
    wb, x = _data(cfg, 4, 200, torch.bfloat16, seed=40)
    before = dict(_build.LAUNCHES)
    out = fs._shapenet_fwd_on("tc", wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"] + 1
    assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 1
    err, scale = _max_diff(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert err <= 1e-2 * scale, (err, scale)


def test_k1_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K1 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K1 within the bf16 bound."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=41)
    before = dict(_build.LAUNCHES)
    out = fs._shapenet_fwd_simt(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 1
    assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"]
    err, scale = _max_diff(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    assert err <= 1e-2 * scale


def test_k1_flagship_is_deterministic(card):
    """The flagship chain at G=8, P=32768 in bf16 on the tensor-core
    (mma.sync) K1, by name (64-point tiles, both W staged, two blocks per
    SM: 2 SMs / G splits): two runs give the same bits and agree with plain
    K1."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    status, geo = fs._k1_tc_status(cfg, "siren", 8, 32768)
    assert (status, geo["tile"], geo["weights"]) == (0, 64, "shared")
    assert geo["splits"] == min(512, 2 * sms // 8)
    wb, x = _data(cfg, 8, 32768, torch.bfloat16, seed=42)
    before = _build.LAUNCHES["shapenet_fwd_tc"]
    runs = [fs._shapenet_fwd_on("tc", wb, x, cfg, "siren") for _ in range(2)]
    assert _build.LAUNCHES["shapenet_fwd_tc"] == before + 2
    assert torch.equal(runs[0], runs[1])
    err, scale = _max_diff(runs[0], fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    assert err <= 1e-2 * scale


# Reverse-body shapes (so < si) of the tensor-core K5: si = 3 with so = 2 on a
# resblock chain, si = 4 at width 16, width 40 (no multiple of 16), width 192
# (two column blocks a warp, W from global memory).
K5_TC_SHAPES = [
    (3, 2, 64, 1, "sine", True, 10.0),
    (4, 1, 16, 2, "sine", False, 30.0),
    (3, 1, 40, 2, "sine", False, 30.0),
    (3, 1, 192, 1, "sine", False, 30.0),
]


@pytest.mark.parametrize("args", K5_TC_SHAPES, ids=["si3-so2-res", "si4-n16", "n40", "n192"])
def test_k5_tc_reverse_shapes(card, args):
    """The tensor-core (mma.sync) K5 reverse body at P = 200 (a ragged last
    tile), against plain K5: y and jac within 2^-6 of max|plain|. A chain
    at width 64 or 128 routes to the wgmma body, so this one runs by name."""
    cfg = ShapeNetConfig(*args)
    assert fd.k5_variant(torch.bfloat16, cfg, "siren") == (
        "wgmma" if cfg.units in (64, 128) else "tc")
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=43)
    before = dict(_build.LAUNCHES)
    y, jac = fd._shapenet_fwd_jac_on("tc", wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"] + 1
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    assert jac.shape == (3, 200, cfg.output_dim, cfg.input_dim)
    _close_rel(y, y_ref, torch.bfloat16)
    _close_rel(jac, jac_ref, torch.bfloat16)


def test_k5_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K5 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K5 within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=44)
    before = dict(_build.LAUNCHES)
    y, jac = fd._shapenet_fwd_jac_simt(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"]
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _close_rel(y, y_ref, torch.bfloat16)
    _close_rel(jac, jac_ref, torch.bfloat16)


def test_k5_flagship_is_deterministic(card):
    """The flagship chain at G=8, P=32768 in bf16 on the tensor-core
    (mma.sync) K5 reverse body, by name: two runs give the same bits and
    agree with plain K5."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 8, 32768, torch.bfloat16, seed=45)
    before = _build.LAUNCHES["shapenet_fwd_jac_tc"]
    runs = [fd._shapenet_fwd_jac_on("tc", wb, x, cfg, "siren") for _ in range(2)]
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before + 2
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _close_rel(runs[0][0], y_ref, torch.bfloat16)
    _close_rel(runs[0][1], jac_ref, torch.bfloat16)


# The wgmma K1 and K5 reverse body (csrc/shapenet_fwd_wgmma.cu): bf16 sine
# chains at widths 64 and 128 with si and so <= 4 (K5: so < si). K1: the
# flagship, resblock chains at both widths, width 64 at four hidden layers,
# si = 1, si = 4 with so = 3, so = 4; K5: the flagship, a resblock chain at
# each width (so = 2 at width 128), si = 4 with so = 3 at three hidden layers.
WG_K1_SHAPES = [
    (3, 1, 128, 2, "sine", False, 30.0),
    (2, 2, 64, 1, "sine", True, 10.0),
    (3, 2, 128, 1, "sine", True, 30.0),
    (3, 1, 64, 4, "sine", False, 30.0),
    (1, 1, 64, 2, "sine", False, 30.0),
    (4, 3, 128, 2, "sine", False, 30.0),
    (2, 4, 128, 2, "sine", False, 30.0),
]
WG_K1_IDS = ["flagship", "res-w64", "res-w128", "w64-d4", "si1", "si4-so3", "so4"]
WG_K5_SHAPES = [
    (3, 1, 128, 2, "sine", False, 30.0),
    (3, 2, 128, 1, "sine", True, 30.0),
    (2, 1, 64, 2, "sine", True, 10.0),
    (4, 3, 64, 3, "sine", False, 30.0),
]
WG_K5_IDS = ["flagship", "res-w128-so2", "res-w64", "si4-so3-d3"]


@pytest.mark.parametrize("args", WG_K1_SHAPES, ids=WG_K1_IDS)
def test_k1_wgmma_matches_plain_and_the_mma_sync_body(card, args):
    """The wgmma K1, where k1_variant routes these chains, at five groups of
    P = 200 (a ragged last tile): within 1e-2 of max|plain| of plain K1, and
    within 1e-2 of max|mma.sync| of the mma.sync body on the same inputs
    (both sum exact bf16 products in f32, in other orders)."""
    cfg = ShapeNetConfig(*args)
    assert fs.k1_variant(torch.bfloat16, cfg, "siren") == "wgmma"
    wb, x = _data(cfg, 5, 200, torch.bfloat16, seed=48)
    before = dict(_build.LAUNCHES)
    out = fs.shapenet_fwd_cuda(wb, x, cfg, "siren")
    got, want = _launched("shapenet_fwd", before, "wgmma")
    assert got == want
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    err, scale = _max_diff(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    assert err <= 1e-2 * scale, (err, scale)
    err, scale = _max_diff(out, fs._shapenet_fwd_on("tc", wb, x, cfg, "siren"))
    assert err <= 1e-2 * scale, (err, scale)


@pytest.mark.parametrize("args", WG_K5_SHAPES, ids=WG_K5_IDS)
def test_k5_wgmma_reverse_matches_plain_and_the_mma_sync_body(card, args):
    """The wgmma K5 reverse body, where k5_variant routes these chains, at
    three groups of P = 200: y and jac within 2^-6 of max|plain| of plain
    K5, and of the mma.sync body's on the same inputs."""
    cfg = ShapeNetConfig(*args)
    assert fd.k5_variant(torch.bfloat16, cfg, "siren") == "wgmma"
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=49)
    before = dict(_build.LAUNCHES)
    y, jac = fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren")
    got, want = _launched("shapenet_fwd_jac", before, "wgmma")
    assert got == want
    assert jac.shape == (3, 200, cfg.output_dim, cfg.input_dim)
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _close_rel(y, y_ref, torch.bfloat16)
    _close_rel(jac, jac_ref, torch.bfloat16)
    y_tc, jac_tc = fd._shapenet_fwd_jac_on("tc", wb, x, cfg, "siren")
    _close_rel(y, y_tc, torch.bfloat16)
    _close_rel(jac, jac_tc, torch.bfloat16)


def test_k1_k5_wgmma_flagship_is_deterministic(card):
    """The flagship chain at G=8, P=32768 in bf16 on the wgmma K1 and K5
    reverse body (128-point tiles, every W_m staged, no scratch, SMs / G
    splits): two runs of each give the same bits and agree with their plain
    versions."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    geo = fs.k1_geometry(cfg, "siren", 8, 32768, torch.bfloat16)
    rev = fd.derivative_geometry("reverse", cfg, "siren", 8, 32768, torch.bfloat16)
    for g in (geo, rev):
        assert (g["body"], g["tile"], g["weights"], g["scratch_bytes"]) == (
            "wgmma", 128, "shared", 0)
        assert g["splits"] == sms // 8
    wb, x = _data(cfg, 8, 32768, torch.bfloat16, seed=50)
    before = dict(_build.LAUNCHES)
    runs = [fs.shapenet_fwd_cuda(wb, x, cfg, "siren") for _ in range(2)]
    jacs = [fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren") for _ in range(2)]
    for base in ("shapenet_fwd", "shapenet_fwd_jac"):
        got, want = _launched(base, before, "wgmma", 2)
        assert got == want, base
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(jacs[0][0], jacs[1][0]) and torch.equal(jacs[0][1], jacs[1][1])
    err, scale = _max_diff(runs[0], fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    assert err <= 1e-2 * scale
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _close_rel(jacs[0][0], y_ref, torch.bfloat16)
    _close_rel(jacs[0][1], jac_ref, torch.bfloat16)


def test_k1_k5_wgmma_geometry_takes_and_refuses(card):
    """The wgmma library's own geometry: the flagship at G = 1 and 32 (its
    splits SMs / G, at most the group's tiles); status 3 for si = 5, so = 5
    and K5 with so >= si; status 2 past its shared memory (K1: seven hidden
    matrices at width 128; K5: three), where K1 and K5 route to the mma.sync
    body: bench.py's w128_d4_resblock chain (eight matrices) for K1, a
    resblock chain of two blocks for K5, each against its plain version."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for G in (1, 32):
        for status in (fs._k1_wg_status(cfg, "siren", G, 32768),
                       fd._k5_wg_status(cfg, "siren", 3, G, 32768)):
            assert status[0] == 0 and status[1]["splits"] == min(256, max(1, sms // G))
    assert fs._k1_wg_status(ShapeNetConfig(5, 1, 64, 2, "sine"), "siren", 2, 64)[0] == 3
    assert fs._k1_wg_status(ShapeNetConfig(3, 5, 64, 2, "sine"), "siren", 2, 64)[0] == 3
    assert fd._k5_wg_status(ShapeNetConfig(2, 2, 64, 2, "sine"), "siren", 2, 2, 64)[0] == 3
    deep = ShapeNetConfig(3, 1, 128, 7, "sine", False, 30.0)
    assert fs._k1_wg_status(deep, "siren", 2, 64)[0] == 2
    assert fs._k1_wg_status(ShapeNetConfig(3, 1, 128, 6, "sine"), "siren", 2, 64)[0] == 0
    assert fd._k5_wg_status(ShapeNetConfig(3, 1, 128, 3, "sine"), "siren", 3, 2, 64)[0] == 2
    res_d4 = ShapeNetConfig(3, 1, 128, 4, "sine", True, 30.0)
    res_d2 = ShapeNetConfig(3, 1, 128, 2, "sine", True, 30.0)
    assert fs._k1_wg_status(res_d4, "siren", 2, 64)[0] == 2
    assert fd._k5_wg_status(res_d2, "siren", 3, 2, 64)[0] == 2
    assert fs.k1_variant(torch.bfloat16, res_d4, "siren") == "tc"
    assert fd.k5_variant(torch.bfloat16, res_d2, "siren") == "tc"
    wb, x = _data(res_d4, 2, 96, torch.bfloat16, seed=51)
    before = dict(_build.LAUNCHES)
    err, scale = _max_diff(fs.shapenet_fwd_cuda(wb, x, res_d4, "siren"),
                           fs.shapenet_grouped_fused_reference(wb, x, res_d4, "siren"))
    assert err <= 1e-2 * scale
    wb, x = _data(res_d2, 2, 96, torch.bfloat16, seed=52)
    y, jac = fd.shapenet_fwd_jac_cuda(wb, x, res_d2, "siren")
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, res_d2, "siren")
    _close_rel(y, y_ref, torch.bfloat16)
    _close_rel(jac, jac_ref, torch.bfloat16)
    for base in ("shapenet_fwd", "shapenet_fwd_jac"):
        got, want = _launched(base, before, "tc")
        assert got == want, base
    with pytest.raises(ValueError, match="wgmma K1 cannot take"):
        fs.k1_geometry(deep, "siren", 2, 96, torch.bfloat16, kernel="wgmma")


def test_bf16_chains_the_tensor_core_k1_and_k5_refuse_run_on_the_cuda_core_kernels(card):
    """Width 1024 (two working planes of 64 points exceed shared memory) and
    si = 5 send bf16 K1 to the CUDA-core kernel, and K5 at width 256 with two
    hidden layers (four planes of 128 points) too; a vanilla bf16 chain
    takes the CUDA-core kernels. Each agrees with its plain version within
    the bf16 bounds."""
    cases = [("siren", (3, 1, 1024, 1, "sine", False, 30.0), "simt", "simt"),
             ("siren", (5, 1, 64, 2, "sine", False, 30.0), "simt", "simt"),
             ("siren", (3, 1, 256, 2, "sine", False, 30.0), "tc", "simt"),
             ("vanilla", (2, 1, 64, 2, "tanh"), "simt", "simt")]
    for variant, args, k1, k5 in cases:
        cfg = ShapeNetConfig(*args)
        assert fs.k1_variant(torch.bfloat16, cfg, variant) == k1
        assert fd.k5_variant(torch.bfloat16, cfg, variant) == k5
        assert fd.fwd_jac_unsupported_reason(cfg, variant, 96, cfg.input_dim, card) is None
        wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=46)
        before = dict(_build.LAUNCHES)
        out = fs.shapenet_grouped_fused(wb, x, cfg, variant)
        y, jac = fd.shapenet_fwd_jac(wb, x, cfg, variant)
        assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 1
        assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"] + int(k1 == "tc")
        assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
        assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"]
        err, scale = _max_diff(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, variant))
        assert err <= 1e-2 * scale, (args, err, scale)
        y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, variant)
        _close_rel(y, y_ref, torch.bfloat16)
        _close_rel(jac, jac_ref, torch.bfloat16)


def test_model_jacobian_evaluation_launches_one_tc_k5_per_chunk(card):
    """``evaluate_sobolev`` on the card launches the tensor-core K5 (its
    wgmma reverse body at the flagship width) once per chunk under the bf16
    policy, and the CUDA-core K5 once per chunk under float32;
    ``output_and_jacobian_grouped`` agrees with plain K5."""
    from nif_tpu_torch.ops.derivatives import output_and_jacobian_grouped
    from nif_tpu_torch.training import GroupedTrainer

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
             "activation": "sine", "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    rng = np.random.default_rng(47)
    t = rng.standard_normal((4, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32)
    u = rng.standard_normal((4, 512, 1)).astype(np.float32)
    jt = rng.standard_normal((4, 512, 1, 3)).astype(np.float32)
    for policy, body in (("mixed_bfloat16", "wgmma"), ("float32", "simt")):
        model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, seed=0)
        trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4))
        before = dict(_build.LAUNCHES)
        out = trainer.evaluate_sobolev(trainer.init(0), t, x, u, jt, group_batch=2)
        got, want = _launched("shapenet_fwd_jac", before, body, 2)
        assert got == want
        assert all(np.isfinite(v) for v in out.values())
    tt, xt = torch.from_numpy(t).cuda(), torch.from_numpy(x).cuda()
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "mixed_bfloat16", seed=0)
    with torch.inference_mode():
        y, jac = output_and_jacobian_grouped(model, tt, xt)
        wb = model._derivative_weights(tt)
        y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, model._compute(xt),
                                                       model.cfg_shape_net, "siren")
    _close_rel(y, y_ref, torch.bfloat16)
    _close_rel(jac, jac_ref, torch.bfloat16)


def test_tutorial8_jacobian_evaluation_launches_one_tangent_body_per_chunk(card):
    """Tutorial 8's model (1 -> 1, width 30, two hidden layers) under
    ``evaluate_sobolev``: the tensor-core tangent body once per chunk under
    the bf16 policy, the CUDA-core one (K6's forward half) once per chunk
    under float32; its grouped ``(y, jac)`` agrees with plain K5."""
    from nif_tpu_torch.ops.derivatives import output_and_jacobian_grouped
    from nif_tpu_torch.training import GroupedTrainer

    cfg_s = {"connectivity": "full", "input_dim": 1, "output_dim": 1, "units": 30,
             "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
             "activation": "sine", "use_resblock": False}
    cfg_p = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
             "activation": "swish", "use_resblock": False, "omega_0": 30.0}
    rng = np.random.default_rng(50)
    t = rng.uniform(-1, 1, (6, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (6, 1024, 1)).astype(np.float32)
    u = rng.standard_normal((6, 1024, 1)).astype(np.float32)
    jt = rng.standard_normal((6, 1024, 1, 1)).astype(np.float32)
    for policy, dtype in (("mixed_bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, seed=0)
        body = fd.derivative_geometry("tangent", model.cfg_shape_net, "siren", 2, 1024,
                                      dtype)["body"]
        assert body == ("tc" if dtype == torch.bfloat16 else "simt")
        trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4))
        before = dict(_build.LAUNCHES)
        out = trainer.evaluate_sobolev(trainer.init(0), t, x, u, jt, group_batch=2)
        assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 3
        assert (_build.LAUNCHES["shapenet_fwd_jac_tc"]
                == before["shapenet_fwd_jac_tc"] + 3 * int(body == "tc"))
        assert all(np.isfinite(v) for v in out.values())
        tt, xt = torch.from_numpy(t).cuda(), torch.from_numpy(x).cuda()
        with torch.inference_mode():
            y, jac = output_and_jacobian_grouped(model, tt, xt)
            wb = model._derivative_weights(tt)
            y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, model._compute(xt),
                                                           model.cfg_shape_net, "siren")
        _close_rel(y, y_ref, dtype)
        _close_rel(jac, jac_ref, dtype)


# The Hessian kernels take sine chains only: the SIREN configs, and one with
# so > si.
HESS_CASES = [c for c in CASES if c[0] == "siren"] + JAC_EXTRA


def _hessian_side(cfg, G, P, seed):
    rng = np.random.default_rng(seed + 3000)
    si, so = cfg.input_dim, cfg.output_dim
    npairs = si * (si + 1) // 2
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (to(rng.standard_normal((G, P, so))), to(rng.standard_normal((G, P, si * so))),
            to(rng.standard_normal((G, P, npairs * so))), to(rng.uniform(0.5, 1.5, (G, P))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", HESS_CASES)
def test_k7_matches_plain(card, variant, args, dtype):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 264, dtype, seed=19)
    # bf16 on the body k7_variant routes to (wgmma at si = 3, widths 64 and
    # 128; else mma.sync), f32 on the CUDA-core one
    body = fh.k7_variant(dtype, cfg, variant)
    assert (body == "simt") == (dtype == torch.float32)
    before = dict(_build.LAUNCHES)
    y, jac, hess = fh.shapenet_fwd_hess(wb, x, cfg, variant)
    got, want = _launched("shapenet_fwd_hess", before, body)
    assert got == want
    refs = fh.shapenet_fwd_hess_reference(wb, x, cfg, variant)
    si, so = cfg.input_dim, cfg.output_dim
    assert y.dtype == jac.dtype == hess.dtype == dtype and hess.shape == (3, 264, so, si, si)
    assert torch.equal(hess, hess.transpose(-1, -2))
    for mine, ref in zip((y, jac, hess), refs):
        _close_rel(mine, ref, dtype)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,args", HESS_CASES)
def test_k8_matches_plain(card, variant, args, dtype, weighted):
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 264, dtype, seed=20)
    tgt, jt, ht, w = _hessian_side(cfg, 3, 264, seed=20)
    si, so = cfg.input_dim, cfg.output_dim
    npairs = si * (si + 1) // 2
    kw = dict(w_value=0.7, w_jac=1.3, w_hess=0.4, weight=w if weighted else None)
    if so > 1:  # the first output, every other jac entry, two of three hess entries
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                  hess_mask=(np.arange(npairs * so) % 3 != 1).astype(np.float32))
    body = fh.k8_variant(dtype, cfg, variant)
    assert (body == "simt") == (dtype == torch.float32)
    before = dict(_build.LAUNCHES)
    *terms, d_wb = fh.shapenet_hessian_grads(wb, x, tgt, jt, ht, cfg, variant, **kw)
    got, want = _launched("shapenet_hessian_grads", before, body)
    assert got == want
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, variant, **kw)
    rel = 1e-5 if dtype == torch.float32 else 1e-3
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=rel)
    assert d_wb.dtype == dtype
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale, (err, scale)


@pytest.mark.parametrize("body", ["tc", "wgmma"])
def test_k8_flagship_width_is_deterministic(card, body):
    """G=4, P=2048 at the flagship width in bf16, on each tensor-core body
    (mma.sync and wgmma): two runs give the same bits (fixed P splits,
    ordered partials and reduce) and agree with plain K8."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 4, 2048, torch.bfloat16, seed=21)
    tgt, jt, ht, w = _hessian_side(cfg, 4, 2048, seed=21)
    before = dict(_build.LAUNCHES)
    runs = [fh._shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, cfg, "siren", weight=w)
            for _ in range(2)]
    got, want = _launched("shapenet_hessian_grads", before, body, 2)
    assert got == want
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren",
                                                      weight=w)
    for mine, ref in zip(runs[0][:3], refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-3)
    err, scale = _max_diff(runs[0][3], r_wb)
    assert err <= 2.0 ** -6 * scale


def test_hessian_geometry(card):
    """At the flagship width (si = 3: ten streams) bf16 K7 and K8 take the
    tensor-core kernels: 16-point tiles (160 stacked rows) with every S plane
    (K8) or both working planes (K7) and the staged W in shared memory, and
    one wave of SMs / G splits per group; their f32 bodies (the CUDA-core
    kernels) take 8-point tiles (80 stacked rows, a thread's ten rows one
    point's streams), f32 K8's five planes and f32 K7's two in shared memory,
    with the same splits. At si = 4 (15 streams) the tensor-core K8's S
    planes go to the global scratch. At width 1024 the tensor-core kernels'
    two planes exceed shared memory, so bf16 takes the CUDA-core kernels,
    which loop over 128-column blocks and keep their planes in the global
    scratch; so does f32 there."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    train = fh.hessian_geometry("train", cfg, "siren", 32, 32768, torch.bfloat16, kernel="tc")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (train["kernel"], train["tile"], train["residuals"], train["weights"]) == (
        "tc", 16, "shared", "shared")
    assert train["splits"] == max(1, min(64, sms // 32))
    f32 = fh.hessian_geometry("train", cfg, "siren", 32, 32768, torch.float32)
    assert (f32["kernel"], f32["tile"], f32["splits"]) == ("simt", 8, train["splits"])
    assert f32["residuals"] == "shared" and f32["scratch_bytes"] == 0
    ev = fh.hessian_geometry("eval", cfg, "siren", 32, 32768, torch.bfloat16, kernel="tc")
    assert (ev["kernel"], ev["tile"], ev["weights"], ev["partial_floats"]) == (
        "tc", 16, "shared", 0)
    assert ev["splits"] == train["splits"]
    ev32 = fh.hessian_geometry("eval", cfg, "siren", 32, 32768, torch.float32)
    assert (ev32["kernel"], ev32["tile"], ev32["residuals"]) == ("simt", 8, "shared")
    si4 = fh.hessian_geometry("train", ShapeNetConfig(4, 1, 128, 2, "sine"), "siren", 2, 64,
                              torch.bfloat16)
    assert (si4["tile"], si4["residuals"]) == (16, "global")
    wide = ShapeNetConfig(4, 1, 1024, 1, "sine")
    # bf16 runs the CUDA-core kernel, which takes it with its planes in the
    # global scratch, as f32 does
    assert "tensor-core" in fh._cuda_reason("train", wide, "siren", 4, torch.bfloat16, "tc")
    assert fh.k8_variant(torch.bfloat16, wide, "siren", 4) == "simt"
    assert fh.k7_variant(torch.bfloat16, wide, "siren", 4) == "simt"
    assert fh.hessian_fused_unsupported_reason(wide, "siren", 256, 4, card) is None
    assert fh.hessian_fused_unsupported_reason(wide, "siren", 256, 4, card,
                                               torch.float32) is None
    assert fh.fwd_hess_unsupported_reason(wide, "siren", 256, 4, card) is None
    for mode in ("train", "eval"):
        for dtype in (torch.float32, torch.bfloat16):
            geo = fh.hessian_geometry(mode, wide, "siren", 2, 256, dtype, si=4)
            assert (geo["kernel"], geo["tile"], geo["residuals"]) == ("simt", 8, "global")


# The float32 K7/K8 body (csrc/shapenet_hess.cu on stack_simt.cuh) on what
# sets it apart: si = 1-4 (3, 6, 10 and 15 streams a point), resblock
# chains, widths 24 and 40 (part of a 128-column block), 256 and 512 (two
# and four column blocks, the planes in the global scratch), so = 2, at P =
# 200 (a ragged last 8-point tile): (ShapeNetConfig args, where the planes
# sit in f32).
SIMT_HESS_F32 = [
    ((3, 1, 24, 2, "sine", False, 30.0), "shared"),
    ((2, 2, 40, 2, "sine", True, 10.0), "shared"),
    ((1, 1, 64, 2, "sine", False, 30.0), "shared"),
    ((4, 1, 128, 2, "sine", False, 30.0), "global"),
    ((3, 1, 128, 2, "sine", True, 30.0), "global"),
    ((3, 1, 128, 2, "sine", False, 30.0), "shared"),
    ((3, 1, 256, 2, "sine", True, 30.0), "global"),
    ((2, 1, 512, 1, "sine", False, 30.0), "global"),
]


@pytest.mark.parametrize("args,residuals", SIMT_HESS_F32,
                         ids=["n24", "n40-res-so2", "si1", "si4", "n128-res", "n128",
                              "n256-res", "n512"])
def test_simt_k7_k8_float32_shapes(card, args, residuals):
    """The float32 K7 and K8 (the CUDA-core body, full f32 FMAs) on each
    shape, weighted, masked where so > 1, at P = 200: one launch each of the
    CUDA-core kernel, K7's y, jac and hess within 2e-4 of max|plain| + 1e-5
    (the Hessian exactly symmetric), K8's terms within rel 1e-5 and d_wb
    within 1e-4 of max|plain|; the planes in shared memory or in the global
    scratch as the geometry says (both instances of the body)."""
    cfg = ShapeNetConfig(*args)
    si, so = cfg.input_dim, cfg.output_dim
    for mode in ("eval", "train"):
        geo = fh.hessian_geometry(mode, cfg, "siren", 3, 200, torch.float32)
        assert (geo["kernel"], geo["tile"]) == ("simt", 8)
        if mode == "train":
            assert geo["residuals"] == residuals
    wb, x = _data(cfg, 3, 200, torch.float32, seed=38)
    before = dict(_build.LAUNCHES)
    outs = fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"]
    assert torch.equal(outs[2], outs[2].transpose(-1, -2))
    for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        assert mine.dtype == torch.float32 and mine.shape == ref.shape
        _close_rel(mine, ref, torch.float32)
    tgt, jt, ht, w = _hessian_side(cfg, 3, 200, seed=38)
    kw = dict(w_value=0.7, w_jac=1.3, w_hess=0.4, weight=w)
    if so > 1:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                  hess_mask=(np.arange(si * (si + 1) // 2 * so) % 3 != 1).astype(np.float32))
    before = dict(_build.LAUNCHES)
    *terms, d_wb = fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren", **kw)
    assert _build.LAUNCHES["shapenet_hessian_grads"] == before["shapenet_hessian_grads"] + 1
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before["shapenet_hessian_grads_tc"]
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren", **kw)
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-5)
    err, scale = _max_diff(d_wb, r_wb)
    assert d_wb.dtype == torch.float32 and err <= 1e-4 * scale, (err, scale)


def test_simt_k7_k8_float32_flagship_is_deterministic(card):
    """The float32 K7 and K8 at the flagship shape (G=32, P=32768, the
    float32 policy's Hessian step and evaluation): two runs each give the
    same bits (fixed splits, an ordered reduce), finite and of the expected
    shapes, each one launch of the CUDA-core kernel."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 32, 32768, torch.float32, seed=39)
    tgt, jt, ht, w = _hessian_side(cfg, 32, 32768, seed=39)
    before = dict(_build.LAUNCHES)
    evals = [fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren") for _ in range(2)]
    trains = [fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren", w_jac=0.1,
                                             w_hess=0.01, weight=w) for _ in range(2)]
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 2
    assert _build.LAUNCHES["shapenet_hessian_grads"] == before["shapenet_hessian_grads"] + 2
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"]
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before["shapenet_hessian_grads_tc"]
    assert [tuple(t.shape) for t in evals[0]] == [(32, 32768, 1), (32, 32768, 1, 3),
                                                 (32, 32768, 1, 3, 3)]
    for a, b in zip(evals[0] + tuple(trains[0]), evals[1] + tuple(trains[1])):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert trains[0][3].shape == wb.shape


# Shapes the tensor-core K8 pads, tiles raggedly or lays out otherwise
# (ShapeNetConfig args): widths 24 and 40, si = 1, 2, 4, resblock chains, and
# widths whose S planes go to the global scratch or whose W is read from
# global memory.
K8_TC_SHAPES = [
    (3, 1, 24, 2, "sine", False, 30.0),
    (2, 2, 40, 2, "sine", True, 10.0),
    (1, 1, 64, 2, "sine", False, 30.0),
    (4, 1, 128, 2, "sine", False, 30.0),
    (3, 1, 128, 2, "sine", True, 30.0),
    (3, 1, 256, 2, "sine", True, 30.0),
    (1, 1, 512, 1, "sine", False, 30.0),
]


@pytest.mark.parametrize("args", K8_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4",
                                                    "n128-res", "n256-res", "n512"])
def test_k8_tc_padded_and_ragged_shapes(card, args):
    """The tensor-core K8 on shapes it pads or lays out otherwise, at P =
    200 (a ragged last tile), weighted, masked where so > 1, against plain
    K8 within the bf16 bounds."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=24)
    tgt, jt, ht, w = _hessian_side(cfg, 3, 200, seed=24)
    si, so = cfg.input_dim, cfg.output_dim
    kw = dict(w_value=0.7, w_jac=1.3, w_hess=0.4, weight=w)
    if so > 1:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                  hess_mask=(np.arange(si * (si + 1) // 2 * so) % 3 != 1).astype(np.float32))
    geo = fh.hessian_geometry("train", cfg, "siren", 3, 200, torch.bfloat16, kernel="tc")
    assert geo["kernel"] == "tc"
    before = _build.LAUNCHES["shapenet_hessian_grads_tc"]
    *terms, d_wb = fh._shapenet_hessian_grads_on("tc", wb, x, tgt, jt, ht, cfg, "siren", **kw)
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before + 1
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren", **kw)
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-3)
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)


def test_k8_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K8 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K8 within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=25)
    tgt, jt, ht, _ = _hessian_side(cfg, 2, 256, seed=25)
    before = dict(_build.LAUNCHES)
    *terms, d_wb = fh._shapenet_hessian_grads_simt(wb, x, tgt, jt, ht, cfg, "siren")
    assert _build.LAUNCHES["shapenet_hessian_grads"] == before["shapenet_hessian_grads"] + 1
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before["shapenet_hessian_grads_tc"]
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren")
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-3)
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)


@pytest.mark.parametrize("args", K8_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4",
                                                    "n128-res", "n256-res", "n512"])
def test_k6_tc_padded_and_ragged_shapes(card, args):
    """The tensor-core K6 on the shapes K8's is checked on (padded widths,
    si = 1, 2, 4, resblock chains, S planes in the global scratch, W from
    global memory), at P = 200 (a ragged last tile), weighted, masked where
    so > 1, against plain K6: d_wb within 2^-6 of max|plain|, terms rel
    1e-4."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=26)
    tgt, jt, w = _sobolev_side(cfg, 3, 200, seed=26)
    si, so = cfg.input_dim, cfg.output_dim
    kw = dict(w_value=0.7, w_jac=1.3, weight=w)
    if so > 1:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32))
    assert fd.derivative_geometry("sobolev", cfg, "siren", 3, 200, torch.bfloat16)["kernel"] == "tc"
    before = _build.LAUNCHES["shapenet_sobolev_grads_tc"]
    lv, lj, d_wb = fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", **kw)
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before + 1
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, "siren", **kw)
    assert float(lv) == pytest.approx(float(rv), rel=1e-4)
    assert float(lj) == pytest.approx(float(rj), rel=1e-4)
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)


def test_k6_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K6 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K6 within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=27)
    tgt, jt, _ = _sobolev_side(cfg, 2, 256, seed=27)
    before = dict(_build.LAUNCHES)
    lv, lj, d_wb = fd._shapenet_sobolev_grads_simt(wb, x, tgt, jt, cfg, "siren")
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 1
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before["shapenet_sobolev_grads_tc"]
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, "siren")
    assert float(lv) == pytest.approx(float(rv), rel=1e-3)
    assert float(lj) == pytest.approx(float(rj), rel=1e-3)
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)


@pytest.mark.parametrize("args", K8_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4",
                                                    "n128-res", "n256-res", "n512"])
def test_k7_tc_padded_and_ragged_shapes(card, args):
    """The tensor-core K7 on the shapes the tensor-core K8 is checked on
    (padded widths, si = 1, 2, 4, resblock chains, widths whose W is staged
    one at a time or read from global memory), at P = 200 (a ragged last
    tile), against plain K7: y, jac and hess within 2^-6 of max|plain|, the
    Hessian exactly symmetric."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=30)
    geo = fh.hessian_geometry("eval", cfg, "siren", 3, 200, torch.bfloat16, kernel="tc")
    assert geo["kernel"] == "tc"
    before = dict(_build.LAUNCHES)
    y, jac, hess = fh._shapenet_fwd_hess_on("tc", wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"] + 1
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert torch.equal(hess, hess.transpose(-1, -2))
    for mine, ref in zip((y, jac, hess), fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        assert mine.dtype == torch.bfloat16 and mine.shape == ref.shape
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_k7_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K7 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K7 within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=31)
    before = dict(_build.LAUNCHES)
    outs = fh._shapenet_fwd_hess_simt(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"]
    for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


@pytest.mark.parametrize("body", ["tc", "wgmma"])
def test_k7_flagship_is_deterministic(card, body):
    """The flagship chain at G=8, P=32768 in bf16 on each tensor-core K7
    body (mma.sync and wgmma): two runs give the same bits and agree with
    plain K7 within 2^-6 of max|plain|."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 8, 32768, torch.bfloat16, seed=32)
    before = dict(_build.LAUNCHES)
    runs = [fh._shapenet_fwd_hess_on(body, wb, x, cfg, "siren") for _ in range(2)]
    got, want = _launched("shapenet_fwd_hess", before, body, 2)
    assert got == want
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for mine, ref in zip(runs[0], fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


# K8's shapes for the tensor-core K2, whose two working planes of 128 rows
# exceed shared memory at width 512: width 384 (three column blocks a warp)
# takes that case's place. At width 256 (resblock) its S planes go to the
# global scratch and W is read from global memory.
K2_TC_SHAPES = K8_TC_SHAPES[:-1] + [(1, 1, 384, 1, "sine", False, 30.0)]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("args", K2_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4",
                                                    "n128-res", "n256-res", "n384"])
def test_k2_tc_padded_and_ragged_shapes(card, args, weighted):
    """The tensor-core K2 on the shapes the tensor-core K6 and K8 are checked
    on, at P = 200 (a ragged last tile of its 128-point tiles), weighted or
    not, against plain K2: loss rel 1e-3, d_wb within 2^-6 of max|plain|."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=33)
    tgt, w, _ = _side(cfg, 3, 200, torch.bfloat16, seed=33)
    w = w if weighted else None
    assert fs.k2_geometry(cfg, "siren", 3, 200, torch.bfloat16, kernel="tc")["kernel"] == "tc"
    before = dict(_build.LAUNCHES)
    loss, d_wb = fs._shapenet_mse_grads_on("tc", wb, x, tgt, cfg, "siren", w)
    got, want = _launched("shapenet_mse_grads", before, "tc")
    assert got == want
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert loss.dtype == torch.float32 and d_wb.dtype == torch.bfloat16
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)


# The float32 K2/K3 body (csrc/shapenet_bwd.cu on stack_simt.cuh) on what
# sets its tile apart: the flagship width with a ragged last tile (P = 200,
# and P = 32768 + 40 at the flagship's scale), width 512 (the planes in the
# global scratch), 1024 (the widest), resblock and vanilla chains, so = 3,
# and width 50 (no multiple of 4: 4-byte weight copies, scalar partials).
SIMT_F32 = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0), 3, 200),
    ("siren", (3, 1, 128, 2, "sine", False, 30.0), 2, 32768 + 40),
    ("siren", (3, 1, 512, 2, "sine", False, 30.0), 2, 200),
    ("vanilla", (3, 2, 1024, 1, "tanh"), 2, 200),
    ("siren", (3, 1, 128, 2, "sine", True, 30.0), 3, 200),
    ("vanilla", (2, 3, 128, 2, "swish"), 3, 200),
    ("siren", (3, 3, 128, 2, "sine", False, 30.0), 3, 200),
    ("siren", (2, 1, 50, 2, "sine", False, 30.0), 3, 200),
]


@pytest.mark.parametrize("variant,args,G,P", SIMT_F32,
                         ids=["n128-p200", "n128-flagship-p", "n512-global", "n1024-vanilla",
                              "n128-res", "n128-vanilla-so3", "n128-so3", "n50"])
def test_simt_k2_k3_float32_shapes(card, variant, args, G, P):
    """The float32 K2 (with point weights) and K3 against their plain
    versions: loss rel 1e-5, d_wb and dx within 5e-6 of max|plain| at P =
    200 and 5e-5 at the flagship's 32808 points (f32 sums over that many
    terms in another order); one CUDA-core launch a call; two runs give the
    same bits."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, G, P, torch.float32, seed=36)
    tgt, w, g = _side(cfg, G, P, torch.float32, seed=36)
    bound = 5e-6 if P <= 200 else 5e-5
    before = dict(_build.LAUNCHES)
    runs = [fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, variant, w) for _ in range(2)]
    assert _build.LAUNCHES["shapenet_mse_grads"] == before["shapenet_mse_grads"] + 2
    assert _build.LAUNCHES["shapenet_mse_grads_tc"] == before["shapenet_mse_grads_tc"]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, variant, w)
    assert float(runs[0][0]) == pytest.approx(float(l_ref), rel=1e-5)
    err, scale = _max_diff(runs[0][1], g_ref)
    assert err <= bound * scale, (err, scale)
    before = _build.LAUNCHES["shapenet_bwd"]
    bwd = [fs.shapenet_bwd_cuda(wb, x, g, cfg, variant) for _ in range(2)]
    assert _build.LAUNCHES["shapenet_bwd"] == before + 2
    assert torch.equal(bwd[0][0], bwd[1][0]) and torch.equal(bwd[0][1], bwd[1][1])
    r_wb, r_dx = fs.shapenet_fused_bwd_reference(wb, x, g, cfg, variant)
    for mine, ref in ((bwd[0][0], r_wb), (bwd[0][1], r_dx)):
        err, scale = _max_diff(mine, ref)
        assert err <= bound * scale, (err, scale)


def test_simt_geometry_by_width(card):
    """Every width the CUDA-core K2/K3 took before runs on it: 8 rows a
    thread up to width 128 (128- and 64-point tiles), then 32, 16 and 8
    points up to width 1024; 1025 is refused."""
    tiles = {16: 128, 32: 128, 64: 128, 128: 64, 256: 32, 512: 16, 1024: 8}
    for n, tile in tiles.items():
        cfg = ShapeNetConfig(3, 1, n, 1, "sine", False, 30.0)
        assert fs.train_geometry(cfg, 2, 1000, torch.float32)["tile"] == tile, n
    with pytest.raises(ValueError, match="status 1"):
        fs.train_geometry(ShapeNetConfig(3, 1, 1025, 1, "sine", False, 30.0), 2, 1000,
                          torch.float32)


def test_k2_cuda_core_kernel_on_bf16_inputs(card):
    """The private launcher that times the CUDA-core K2 beside the
    tensor-core one on the same bf16 inputs: it launches the CUDA-core
    kernel and agrees with plain K2 within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 256, torch.bfloat16, seed=34)
    tgt, w, _ = _side(cfg, 2, 256, torch.bfloat16, seed=34)
    before = dict(_build.LAUNCHES)
    loss, d_wb = fs._shapenet_mse_grads_simt(wb, x, tgt, cfg, "siren", w)
    assert _build.LAUNCHES["shapenet_mse_grads"] == before["shapenet_mse_grads"] + 1
    assert _build.LAUNCHES["shapenet_mse_grads_tc"] == before["shapenet_mse_grads_tc"]
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)


def test_k2_flagship_is_deterministic(card):
    """The flagship chain at G=8, P=32768 in bf16, weighted, on the
    tensor-core K2: 128-point tiles with every S plane, D and both hidden W
    in shared memory; two runs give the same bits (fixed P splits, an
    ordered reduce) and agree with plain K2."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    geo = fs.k2_geometry(cfg, "siren", 8, 32768, torch.bfloat16, kernel="tc")
    assert (geo["kernel"], geo["tile"], geo["residuals"], geo["weights"]) == (
        "tc", 128, "shared", "shared")
    wb, x = _data(cfg, 8, 32768, torch.bfloat16, seed=35)
    tgt, w, _ = _side(cfg, 8, 32768, torch.bfloat16, seed=35)
    before = dict(_build.LAUNCHES)
    runs = [fs._shapenet_mse_grads_on("tc", wb, x, tgt, cfg, "siren", w) for _ in range(2)]
    got, want = _launched("shapenet_mse_grads", before, "tc", 2)
    assert got == want
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert float(runs[0][0]) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(runs[0][1], g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)


# The tensor-core K3 (K2's body with g_out in place of the loss, and dx) on
# K2's shapes, and so = 2 and 3 at si = 4 and 2 (a resblock chain).
K3_TC_SHAPES = K2_TC_SHAPES + [(4, 3, 64, 2, "sine", False, 30.0),
                               (2, 2, 96, 2, "sine", True, 10.0)]


@pytest.mark.parametrize("args", K3_TC_SHAPES, ids=["n24", "n40-res", "si1", "si4", "n128-res",
                                                    "n256-res", "n384", "si4-so3",
                                                    "si2-so2-res"])
def test_k3_tc_padded_and_ragged_shapes(card, args):
    """The tensor-core K3 at P = 200 (a ragged last tile of its 128-point
    tiles) against plain K3: d_wb and dx within 2^-6 of max|plain|; one
    tensor-core launch a call, and two runs give the same bits."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=38)
    g = _side(cfg, 3, 200, torch.bfloat16, seed=38)[2]
    assert fs.k3_geometry(cfg, "siren", 3, 200, torch.bfloat16, kernel="tc")["kernel"] == "tc"
    before = dict(_build.LAUNCHES)
    runs = [fs._shapenet_bwd_on("tc", wb, x, g, cfg, "siren") for _ in range(2)]
    got, want = _launched("shapenet_bwd", before, "tc", 2)
    assert got == want
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    d_wb, dx = runs[0]
    assert d_wb.dtype == dx.dtype == torch.bfloat16 and dx.shape == x.shape
    for mine, ref in zip(runs[0], fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_k3_tensor_cores_against_the_cuda_core_kernel(card):
    """The tensor-core K3 and the CUDA-core K3 (the private launcher
    ``chip_smoke.py`` times beside it) on the same bf16 inputs of the
    flagship chain at G=8, P=32768 + 40: each launches its own kernel, both
    are within 2^-6 of max|plain|, and within 2^-6 of max|CUDA-core| of each
    other; two tensor-core runs give the same bits."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 8, 32768 + 40, torch.bfloat16, seed=39)
    g = _side(cfg, 8, 32768 + 40, torch.bfloat16, seed=39)[2]
    geo = fs._k3_tc_status(cfg, "siren", 8, 32768 + 40)[1]
    assert (geo["tile"], geo["residuals"], geo["weights"]) == (128, "shared", "shared")
    before = dict(_build.LAUNCHES)
    tc = [fs._shapenet_bwd_on("tc", wb, x, g, cfg, "siren") for _ in range(2)]
    simt = fs._shapenet_bwd_simt(wb, x, g, cfg, "siren")
    got, want = _launched("shapenet_bwd", before, "tc", 2)
    assert got == {**want, "shapenet_bwd": 3}
    assert torch.equal(tc[0][0], tc[1][0]) and torch.equal(tc[0][1], tc[1][1])
    ref = fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")
    for mine, other, plain in zip(tc[0], simt, ref):
        for a, b in ((mine, plain), (other, plain), (mine, other)):
            err, scale = _max_diff(a, b)
            assert err <= 2.0 ** -6 * scale, (err, scale)


def test_bf16_chains_the_tensor_core_k2_and_k7_refuse_run_on_the_cuda_core_kernels(card):
    """Width 384 at si = 3 with two hidden layers: the tensor-core K7's two
    working planes of ten streams exceed shared memory, so bf16 K7 takes the
    CUDA-core kernel; the tensor-core K2's two planes of one stream still
    fit there, and at width 512 they do not, so bf16 K2 takes the CUDA-core
    kernel; a vanilla bf16 chain and si = 5 take it too. Each agrees with
    its plain version within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 384, 2, "sine", False, 30.0)
    assert fh.k7_variant(torch.bfloat16, cfg, "siren") == "simt"
    assert fh.fwd_hess_unsupported_reason(cfg, "siren", 96, 3, card) is None
    wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=36)
    before = dict(_build.LAUNCHES)
    outs = fh.shapenet_fwd_hess(wb, x, cfg, "siren")
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"]
    for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)
    cases = [("siren", (3, 1, 384, 2, "sine", False, 30.0), "tc"),
             ("siren", (3, 1, 512, 2, "sine", False, 30.0), "simt"),
             ("siren", (5, 1, 64, 2, "sine", False, 30.0), "simt"),
             ("vanilla", (2, 1, 64, 2, "sine"), "simt")]
    for variant, args, kernel in cases:
        cfg = ShapeNetConfig(*args)
        assert fs.k2_variant(torch.bfloat16, cfg, variant) == kernel
        # the tensor-core K3 (K2's body) takes and refuses the same chains
        assert fs.k3_variant(torch.bfloat16, cfg, variant) == kernel
        wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=37)
        tgt, w, g = _side(cfg, 2, 96, torch.bfloat16, seed=37)
        before = dict(_build.LAUNCHES)
        for mine, ref in zip(fs.shapenet_bwd_cuda(wb, x, g, cfg, variant),
                             fs.shapenet_fused_bwd_reference(wb, x, g, cfg, variant)):
            err, scale = _max_diff(mine, ref)
            assert err <= 2.0 ** -6 * scale, (err, scale)
        assert _build.LAUNCHES["shapenet_bwd"] == before["shapenet_bwd"] + 1
        assert (_build.LAUNCHES["shapenet_bwd_tc"]
                == before["shapenet_bwd_tc"] + int(kernel == "tc"))
        before = dict(_build.LAUNCHES)
        loss, d_wb = fs.shapenet_mse_grads(wb, x, tgt, cfg, variant, w)
        assert _build.LAUNCHES["shapenet_mse_grads"] == before["shapenet_mse_grads"] + 1
        assert (_build.LAUNCHES["shapenet_mse_grads_tc"]
                == before["shapenet_mse_grads_tc"] + int(kernel == "tc"))
        l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, variant, w)
        assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
        err, scale = _max_diff(d_wb, g_ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_bf16_chains_the_tensor_core_kernels_refuse_train_on_the_cuda_core_kernels(card):
    """Width 384 at si = 3 with two hidden layers: the tensor-core K8's two
    working planes of ten streams exceed shared memory, so bf16 K8 takes the
    CUDA-core kernel (one launch, none of the tensor-core one) and the
    Sobolev path of a model at that width says so; K6's four streams still
    fit the tensor-core kernel there, and at width 512 they do not, so bf16
    K6 takes the CUDA-core kernel. Each agrees with its plain version."""
    cfg = ShapeNetConfig(3, 1, 384, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=28)
    tgt, jt, ht, w = _hessian_side(cfg, 2, 96, seed=28)
    assert fh.k8_variant(torch.bfloat16, cfg, "siren") == "simt"
    assert fh.hessian_geometry("train", cfg, "siren", 2, 96, torch.bfloat16)["kernel"] == "simt"
    assert fh.hessian_fused_unsupported_reason(cfg, "siren", 96, 3, card) is None
    before = dict(_build.LAUNCHES)
    *terms, d_wb = fh.shapenet_hessian_grads(wb, x, tgt, jt, ht, cfg, "siren", weight=w)
    assert _build.LAUNCHES["shapenet_hessian_grads"] == before["shapenet_hessian_grads"] + 1
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before["shapenet_hessian_grads_tc"]
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren", weight=w)
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-3)
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)
    cfg_p = {"input_dim": 2, "latent_dim": 4, "units": 16, "nlayers": 1, "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale({"input_dim": 3, "output_dim": 1, "units": 384,
                                         "nlayers": 2, "activation": "sine", "omega_0": 30.0},
                                        cfg_p, "mixed_bfloat16", seed=0)
    info = model.sobolev_path_info(96, 3, hess=True)
    assert (info["path"], info["kernel"]) == ("fused", "simt")
    assert model.sobolev_path_info(96, 3)["kernel"] == "tc"
    for units, kernel in ((384, "tc"), (512, "simt")):
        cfg = ShapeNetConfig(3, 1, units, 2, "sine", False, 30.0)
        wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=29)
        tgt, jt, w = _sobolev_side(cfg, 2, 96, seed=29)
        assert fd.k6_variant(torch.bfloat16, cfg, "siren") == kernel
        assert fd.sobolev_fused_unsupported_reason(cfg, "siren", 96, 3, card) is None
        before = dict(_build.LAUNCHES)
        lv, lj, d_wb = fd.shapenet_sobolev_grads(wb, x, tgt, jt, cfg, "siren", weight=w)
        assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 1
        assert (_build.LAUNCHES["shapenet_sobolev_grads_tc"]
                == before["shapenet_sobolev_grads_tc"] + int(kernel == "tc"))
        rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, "siren",
                                                           weight=w)
        rel = 1e-4 if kernel == "tc" else 1e-3
        assert float(lv) == pytest.approx(float(rv), rel=rel)
        assert float(lj) == pytest.approx(float(rj), rel=rel)
        err, scale = _max_diff(d_wb, r_wb)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_hessian_wrappers_refuse_what_they_cannot_take(card):
    cfg = ShapeNetConfig(2, 1, 16, 1, "sine")
    wb, x = _data(cfg, 2, 16, torch.float32, seed=22)
    tgt, jt, ht, w = _hessian_side(cfg, 2, 16, seed=22)
    with pytest.raises(RuntimeError, match="no backward"):
        fh.shapenet_fwd_hess_cuda(wb.clone().requires_grad_(), x, cfg, "siren")
    with pytest.raises(ValueError, match="hess_target"):
        fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht[..., :1], cfg, "siren")
    with pytest.raises(ValueError, match="weight"):
        fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren", weight=w[:, :8])
    with pytest.raises(ValueError, match="sine chains only"):
        fh.shapenet_fwd_hess_cuda(wb, x, ShapeNetConfig(2, 1, 16, 1, "tanh"), "vanilla")


def test_model_hessian_step_on_the_card_launches_k8(card):
    """One GroupedTrainer step with Jacobian and Hessian targets at a small
    shape: exactly one K8 launch (no K6, no K2), of the tensor-core body
    k8_variant routes the chain to under the bf16 policy and of the
    CUDA-core one under float32, recorded as the Sobolev path;
    evaluate_sobolev with Hessian targets launches K7 once per chunk, on the
    body k7_variant routes to."""
    from nif_tpu_torch.training import GroupedTrainer

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
             "activation": "sine", "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "mixed_bfloat16", seed=0)
    rng = np.random.default_rng(23)
    t = rng.standard_normal((4, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32)
    u = rng.standard_normal((4, 512, 1)).astype(np.float32)
    jt = rng.standard_normal((4, 512, 1, 3)).astype(np.float32)
    ht = rng.standard_normal((4, 512, 1, 3, 3)).astype(np.float32)
    ht = 0.5 * (ht + ht.transpose(0, 1, 2, 4, 3))
    trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4), w_jac=0.1,
                             w_hess=0.01)
    state = trainer.init(0)
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    k8_body = fh.k8_variant(torch.bfloat16, cfg, "siren")
    k7_body = fh.k7_variant(torch.bfloat16, cfg, "siren")
    assert "simt" not in (k7_body, k8_body)
    before = dict(_build.LAUNCHES)
    state, loss = trainer.step(state, *(torch.from_numpy(a).cuda() for a in (t, x, u)),
                               target_jac=torch.from_numpy(jt).cuda(),
                               target_hess=torch.from_numpy(ht).cuda())
    after = dict(_build.LAUNCHES)
    got, want = _launched("shapenet_hessian_grads", before, k8_body)
    assert got == want
    assert after["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"]
    assert after["shapenet_mse_grads"] == before["shapenet_mse_grads"]
    assert bool(torch.isfinite(loss)) and trainer.history["sobolev_path"] == "fused"
    out = trainer.evaluate_sobolev(state, t, x, u, jt, group_batch=2, target_hess=ht)
    got, want = _launched("shapenet_fwd_hess", after, k7_body, 2)
    assert got == want
    assert all(np.isfinite(v) for v in out.values()) and "hessian_mse" in out
    f32 = GroupedTrainer(nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "float32", seed=0),
                         lambda p: torch.optim.Adam(p, lr=1e-4), w_jac=0.1, w_hess=0.01)
    before = dict(_build.LAUNCHES)
    _, loss = f32.step(f32.init(0), *(torch.from_numpy(a).cuda() for a in (t, x, u)),
                       target_jac=torch.from_numpy(jt).cuda(),
                       target_hess=torch.from_numpy(ht).cuda())
    assert _build.LAUNCHES["shapenet_hessian_grads"] == before["shapenet_hessian_grads"] + 1
    assert _build.LAUNCHES["shapenet_hessian_grads_tc"] == before["shapenet_hessian_grads_tc"]
    assert bool(torch.isfinite(loss))


def test_hessian_evaluation_routing_logs_eager_fallbacks(card, caplog):
    """Auto routing on the card: a vanilla chain's ``(y, jac, hess)`` goes
    eager with one WARNING (per model and shape) naming K7 and the gate's
    reason, and launches nothing; a sine chain takes K7."""
    import logging

    from nif_tpu_torch.ops.derivatives import output_jacobian_hessian_grouped

    cfg_p = {"input_dim": 2, "latent_dim": 3, "units": 16, "nlayers": 1, "activation": "swish"}
    rng = np.random.default_rng(24)
    t = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 2)).astype(np.float32)).cuda()
    vanilla = nif_tpu_torch.NIF({"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
                                 "activation": "tanh"}, cfg_p, seed=0)
    before = dict(_build.LAUNCHES)
    with caplog.at_level(logging.WARNING, logger="nif_tpu_torch"):
        for _ in range(2):
            output_jacobian_hessian_grouped(vanilla, t, x)
    assert _build.LAUNCHES == before
    msgs = [r.getMessage() for r in caplog.records if "K7 path FALLING BACK" in r.getMessage()]
    assert len(msgs) == 1 and "sine chains only" in msgs[0]
    siren = nif_tpu_torch.NIFMultiScale({"input_dim": 2, "output_dim": 1, "units": 16,
                                         "nlayers": 1, "activation": "sine"}, cfg_p, seed=0)
    _, _, hess = output_jacobian_hessian_grouped(siren, t, x)
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert hess.shape == (2, 64, 1, 2, 2) and bool(torch.isfinite(hess).all())


def test_hessian_evaluation_is_gated_on_the_compute_dtypes_kernel(card, caplog):
    """A model's ``(y, jac, hess)`` is gated on the limits of the K7 its
    compute dtype runs. At width 1032 (si = 1) the tensor-core K7 takes
    bfloat16, while the CUDA-core K7, which float32 runs, refuses the width
    (a thread keeps its columns of a layer in registers): the float32 model
    goes eager with one WARNING and launches nothing, the bfloat16 model
    launches the tensor-core K7."""
    import logging

    from nif_tpu_torch.ops.derivatives import output_jacobian_hessian_grouped

    wide = ShapeNetConfig(1, 1, 1032, 1, "sine")
    assert fh.fwd_hess_unsupported_reason(wide, "siren", 64, 1, card, torch.bfloat16) is None
    assert "wider" in fh.fwd_hess_unsupported_reason(wide, "siren", 64, 1, card, torch.float32)
    cfg_s = {"input_dim": 1, "output_dim": 1, "units": 1032, "nlayers": 1, "activation": "sine"}
    cfg_p = {"input_dim": 2, "latent_dim": 3, "units": 16, "nlayers": 1, "activation": "swish"}
    rng = np.random.default_rng(25)
    t = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 1)).astype(np.float32)).cuda()
    f32 = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "float32", seed=0)
    before = dict(_build.LAUNCHES)
    with caplog.at_level(logging.WARNING, logger="nif_tpu_torch"):
        _, _, hess = output_jacobian_hessian_grouped(f32, t, x)
    assert _build.LAUNCHES == before
    msgs = [r.getMessage() for r in caplog.records if "K7 path FALLING BACK" in r.getMessage()]
    assert len(msgs) == 1 and "wider" in msgs[0]
    assert hess.shape == (2, 64, 1, 1, 1) and bool(torch.isfinite(hess).all())
    bf16 = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, "mixed_bfloat16", seed=0)
    _, _, hess = output_jacobian_hessian_grouped(bf16, t, x)
    assert _build.LAUNCHES["shapenet_fwd_hess_tc"] == before["shapenet_fwd_hess_tc"] + 1
    assert _build.LAUNCHES["shapenet_fwd_hess"] == before["shapenet_fwd_hess"] + 1
    assert hess.shape == (2, 64, 1, 1, 1) and bool(torch.isfinite(hess).all())


# K4's trunks: the SIREN configs above with a bottleneck of so * K outputs,
# so in {1, 2, 3}, resblock and plain, K chosen so that so * K stays within
# the kernel's width.
LINEAR_CASES = [
    # (si, so, K, units, nlayers, resblock, omega_0)
    (3, 1, 128, 128, 2, False, 30.0),
    (2, 2, 32, 64, 1, True, 10.0),
    (1, 3, 8, 16, 3, False, 5.0),
]


def _linear_data(case, G, P, dtype, seed):
    """The trunk's chain-order weights and biases (SIREN-regime, 0.3/omega_0),
    a, bias, x, target and point weights, made with numpy from a seed."""
    si, so, K, n, l, res, om = case
    cfg = ShapeNetConfig(si, so * K, n, l, "sine", res, om)
    n_mats = 2 * l if res else l
    w_shapes = [(si, n)] + [(n, n)] * n_mats + [(n, so * K)]
    b_shapes = [(n,)] * (n_mats + 1) + [(so * K,)]
    rng = np.random.default_rng(seed)
    to = lambda a, dt=dtype: torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)  # noqa: E731
    ws = [to(rng.standard_normal(s) * (0.3 / om)) for s in w_shapes]
    bs = [to(rng.standard_normal(s) * (0.3 / om)) for s in b_shapes]
    a = to(rng.standard_normal((G, K)) * 0.5)
    bias = to(rng.standard_normal(so) * 0.1)
    x = to(rng.standard_normal((G, P, si)))
    tgt = to(rng.standard_normal((G, P, so)), torch.float32)
    w = to(rng.uniform(0.5, 1.5, (G, P)), torch.float32)
    return cfg, so, ws, bs, a, bias, x, tgt, w


def _k4_close(outs, refs, dtype):
    """K4's outputs against plain K4's, with the bounds of the docstring."""
    l_rel, bound = (1e-5, 5e-5) if dtype == torch.float32 else (1e-3, 2.0 ** -6)
    loss, *grads = outs
    l_ref, *g_refs = refs
    assert loss.dtype == torch.float32 and float(loss) == pytest.approx(float(l_ref), rel=l_rel)
    flat = lambda gs: [g for x in gs for g in (x if isinstance(x, list) else [x])]  # noqa: E731
    for mine, ref in zip(flat(grads), flat(g_refs)):
        assert mine.dtype == torch.float32 and mine.shape == ref.shape
        err, scale = _max_diff(mine, ref)
        assert err <= bound * scale + 1e-12


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LINEAR_CASES, ids=["so1", "so2-res", "so3"])
def test_k4_matches_plain(card, case, dtype, weighted):
    """Each dtype's variant against plain K4; the tensor-core counter moves
    for bf16 only."""
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(case, 3, 256, dtype, seed=30)
    w = w if weighted else None
    before = dict(_build.LAUNCHES)
    outs = fl.niflinear_mse_grads(ws, bs, a, bias, x, tgt, cfg, so, w)
    assert _build.LAUNCHES["niflinear_mse_grads"] == before["niflinear_mse_grads"] + 1
    tc = 1 if dtype == torch.bfloat16 else 0
    assert _build.LAUNCHES["niflinear_mse_grads_tc"] == before["niflinear_mse_grads_tc"] + tc
    refs = fl.niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w)
    _k4_close(outs, refs, dtype)


def test_k4_ragged_tiles_and_determinism(card):
    """The flagship trunk in bf16 at P = 264 (8 rows in the last tile), G=5,
    weighted: two runs give the same bits and agree with plain K4."""
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(LINEAR_CASES[0], 5, 264, torch.bfloat16,
                                                       seed=31)
    runs = [fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so, w) for _ in range(2)]
    flat = lambda r: [r[0], *r[1], *r[2], r[3], r[4]]  # noqa: E731
    assert all(torch.equal(p, q) for p, q in zip(flat(runs[0]), flat(runs[1])))
    _k4_close(runs[0], fl.niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w),
              torch.bfloat16)


# Trunks the tensor-core K4 zero-pads (n or so * K not a multiple of 16, nk
# == 1) or tiles with 32 or 16 points (widths of 256).
PADDED_CASES = [
    # (si, so, K, units, nlayers, resblock, omega_0)
    (2, 1, 20, 24, 1, False, 5.0),
    (3, 3, 5, 40, 2, True, 10.0),
    (2, 1, 1, 16, 1, False, 5.0),
    (3, 1, 256, 256, 1, False, 30.0),
    (3, 2, 128, 256, 2, False, 30.0),
]


@pytest.mark.parametrize("case", PADDED_CASES, ids=["n24-nk20", "n40-nk15-res", "nk1",
                                                    "n256-tile32", "n256-tile16"])
def test_k4_tc_padded_widths_and_ragged_tile(card, case):
    """The tensor-core K4 on widths it pads, at P = 200 (a ragged last tile),
    weighted, against plain K4; its tile is the largest that fits."""
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(case, 3, 200, torch.bfloat16, seed=34)
    geo = fl.linear_geometry(cfg, so, 3, 200, torch.bfloat16)
    assert geo["variant"] == "tc"
    assert geo["tile"] == {256: 32 if case[4] == 1 else 16}.get(case[3], 64)
    before = _build.LAUNCHES["niflinear_mse_grads_tc"]
    outs = fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so, w)
    assert _build.LAUNCHES["niflinear_mse_grads_tc"] == before + 1
    _k4_close(outs, fl.niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w),
              torch.bfloat16)


def test_linear_geometry(card):
    """At the flagship trunk bf16 takes the tensor-core kernel with 64-point
    tiles in shared memory and one wave of SMs / G splits per group; f32
    takes the CUDA-core kernel with 64-point tiles, its planes in shared
    memory, one wave of one block per SM over all the groups' tiles; at
    width 1024 its planes go to the per-block global scratch."""
    cfg = ShapeNetConfig(3, 128, 128, 2, "sine", False, 30.0)
    bf16 = fl.linear_geometry(cfg, 1, 32, 32768, torch.bfloat16)
    f32 = fl.linear_geometry(cfg, 1, 32, 32768, torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (bf16["variant"], bf16["tile"], bf16["residuals"]) == ("tc", 64, "shared")
    assert bf16["splits"] == max(1, min(64, sms // 32))
    assert (f32["variant"], f32["tile"], f32["residuals"]) == ("simt", 64, "shared")
    assert f32["blocks"] == sms and f32["scratch_bytes"] == 0
    wide = fl.linear_geometry(ShapeNetConfig(3, 128, 1024, 1, "sine"), 1, 2, 256,
                              torch.float32)
    assert wide["residuals"] == "global" and wide["scratch_bytes"] > 0
    assert fl.linear_geometry(cfg, 1, 1, 64, torch.float32)["blocks"] == 1
    too_wide = ShapeNetConfig(3, 2048, 128, 2, "sine", False, 30.0)
    assert "wider" in fl.linear_fused_unsupported_reason(too_wide, 1, 256, "cuda")


def test_k4_wrapper_refuses_what_it_cannot_take(card):
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(LINEAR_CASES[2], 2, 16, torch.float32,
                                                       seed=32)
    with pytest.raises(RuntimeError, match="no backward"):
        fl.niflinear_mse_grads_cuda(ws, bs, a.clone().requires_grad_(), bias, x, tgt, cfg, so)
    with pytest.raises(ValueError, match="shapes"):
        fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt[:, :8], cfg, so)
    with pytest.raises(ValueError, match="shapes"):
        fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so, w[:, :8])
    with pytest.raises(TypeError):
        fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x.bfloat16(), tgt, cfg, so)
    with pytest.raises(ValueError, match="point tile"):
        fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x[:, :13], tgt[:, :13], cfg, so)


def test_linear_model_on_the_card_launches_k4_and_k6(card):
    """NIF-linear on the card: one GroupedTrainer step launches K4 once (no
    K2), with its loss and grads against plain K4 + autograd through the
    ParameterNet; apply_grouped(fused=True) launches K1 once; a Sobolev step
    launches the tensor-core K6 once on the effective chain."""
    from nif_tpu_torch.training import GroupedTrainer

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2, "activation": "sine",
             "omega_0": 30.0, "connectivity": "last_layer", "weight_init_factor": 1.0}
    cfg_p = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
             "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(cfg_s, cfg_p, "mixed_bfloat16",
                                                              seed=0)
    assert model.fast_path_info(512)["path"] == "fused"
    rng = np.random.default_rng(33)
    t = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 512, 3)).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.standard_normal((4, 512, 1)).astype(np.float32)).cuda()
    jt = torch.from_numpy(rng.standard_normal((4, 512, 1, 3)).astype(np.float32)).cuda()
    loss, grads = model.mse_value_and_grad(t, x, u)
    a = model.pnet(model._compute(t))[0]
    ws, bs = model._trunk_lists()
    cdt = torch.bfloat16
    ref = fl.niflinear_mse_grads_reference(
        [w.detach().to(cdt) for w in ws], [b.detach().to(cdt) for b in bs], a.detach().to(cdt),
        model.snet.bias.detach().to(cdt), model._compute(x), u, model._trunk_cfg, 1)
    pnet = list(model.pnet.params.parameters())
    refs = dict(zip(map(id, pnet), torch.autograd.grad(a, pnet, ref[3].to(a.dtype))))
    refs.update(zip(map(id, [*ws, *bs, model.snet.bias]), [*ref[1], *ref[2], ref[4]]))
    assert float(loss) == pytest.approx(float(ref[0]), rel=1e-3)
    for path, p in model.param_items():
        mine = grads
        for key in path:
            mine = mine[key]
        assert float((mine - refs[id(p)]).norm()) <= 1e-2 * float(refs[id(p)].norm()) + 1e-12
    trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4))
    state = trainer.init(0)
    before = dict(_build.LAUNCHES)
    state, loss = trainer.step(state, t, x, u)
    after = dict(_build.LAUNCHES)
    assert after["niflinear_mse_grads"] == before["niflinear_mse_grads"] + 1
    assert after["niflinear_mse_grads_tc"] == before["niflinear_mse_grads_tc"] + 1
    assert sum(after.values()) == sum(before.values()) + 2
    assert bool(torch.isfinite(loss)) and trainer.history["path"] == "fused"
    with torch.inference_mode():
        out = model.apply_grouped(t, x, fused=True)
    assert _build.LAUNCHES["shapenet_fwd"] == after["shapenet_fwd"] + 1
    assert tuple(out.shape) == (4, 512, 1) and bool(torch.isfinite(out).all())
    state, loss = trainer.step(state, t, x, u, target_jac=jt)
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == after["shapenet_sobolev_grads"] + 1
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == after["shapenet_sobolev_grads_tc"] + 1
    assert bool(torch.isfinite(loss)) and trainer.history["sobolev_path"] == "fused"


# The float32 K6 body (csrc/shapenet_jac.cu on stack_simt.cuh, si <= 4) on
# what sets it apart: si = 1-4 (2-5 streams a point, 32- or 16-point tiles),
# resblock and vanilla chains, widths 24 and 40 (part of a 128-column block),
# 256, 512 and 1024 (two to eight column blocks), so = 2 and 3, at P = 200 (a
# ragged last tile) and P = 256: (ShapeNetConfig args, variant, where the
# planes sit).
SIMT_SOB_F32 = [
    ((3, 1, 24, 2, "sine", False, 30.0), "siren", "shared"),
    ((2, 2, 40, 2, "sine", True, 10.0), "siren", "shared"),
    ((1, 1, 64, 2, "sine", False, 30.0), "siren", "shared"),
    ((4, 1, 128, 2, "sine", False, 30.0), "siren", "shared"),
    ((3, 1, 128, 2, "sine", True, 30.0), "siren", "global"),
    ((2, 3, 32, 2, "swish"), "vanilla", "shared"),
    ((1, 1, 16, 1, "tanh"), "vanilla", "shared"),
    ((3, 1, 256, 1, "sine", False, 30.0), "siren", "shared"),
    ((2, 1, 512, 1, "sine", False, 30.0), "siren", "global"),
    ((1, 1, 1024, 1, "sine", False, 30.0), "siren", "global"),
]


@pytest.mark.parametrize("P", [200, 256])
@pytest.mark.parametrize("args,variant,residuals", SIMT_SOB_F32,
                         ids=["n24", "n40-res-so2", "si1", "si4", "n128-res", "vanilla-so3",
                              "vanilla-tanh", "n256", "n512", "n1024"])
def test_simt_k6_float32_shapes(card, args, variant, residuals, P):
    """The float32 K6 (the CUDA-core body, full f32 FMAs) on each shape,
    weighted, masked where so > 1: one launch of the CUDA-core kernel a
    call, terms within rel 1e-5 and d_wb within 5e-5 of max|plain|, two
    runs bitwise equal; the planes in shared memory or in the global
    scratch as the geometry says (both instances of the body)."""
    cfg = ShapeNetConfig(*args)
    si, so = cfg.input_dim, cfg.output_dim
    geo = fd.derivative_geometry("sobolev", cfg, variant, 3, P, torch.float32)
    assert (geo["kernel"], geo["tile"], geo["residuals"]) == (
        "simt", 32 if si == 1 else 16, residuals)
    wb, x = _data(cfg, 3, P, torch.float32, seed=40)
    tgt, jt, w = _sobolev_side(cfg, 3, P, seed=40)
    kw = dict(w_value=0.7, w_jac=1.3, weight=w)
    if so > 1:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32))
    before = dict(_build.LAUNCHES)
    runs = [fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, variant, **kw)
            for _ in range(2)]
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 2
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before["shapenet_sobolev_grads_tc"]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    lv, lj, d_wb = runs[0]
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, variant, **kw)
    assert float(lv) == pytest.approx(float(rv), rel=1e-5)
    assert float(lj) == pytest.approx(float(rj), rel=1e-5)
    err, scale = _max_diff(d_wb, r_wb)
    assert d_wb.dtype == torch.float32 and err <= 5e-5 * scale, (err, scale)


SOB_WIDE_SI = [
    ((5, 1, 64, 1, "sine", False, 30.0), "siren"),
    ((6, 2, 40, 2, "sine", True, 10.0), "siren"),
    ((5, 2, 24, 2, "swish"), "vanilla"),
    ((7, 1, 1024, 1, "sine", False, 30.0), "siren"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("args,variant", SOB_WIDE_SI,
                         ids=["si5-n64", "si6-n40-res-so2", "si5-vanilla-so2", "si7-n1024"])
def test_k6_above_four_inputs_matches_plain(card, args, variant, dtype):
    """K6 for si > 4 (the first port's stacked body, which reads the f32 wb'
    at its row stride ldwb), weighted, masked where so > 1, at P = 200: one
    launch of the CUDA-core kernel in both dtypes, terms within the dtype's
    rel bound and d_wb within 5e-5 (f32) or 2^-6 (bf16) of max|plain|."""
    cfg = ShapeNetConfig(*args)
    si, so = cfg.input_dim, cfg.output_dim
    geo = fd.derivative_geometry("sobolev", cfg, variant, 3, 200, dtype)
    assert geo["kernel"] == "simt" and geo["tile"] < 16
    wb, x = _data(cfg, 3, 200, dtype, seed=45)
    tgt, jt, w = _sobolev_side(cfg, 3, 200, seed=45)
    kw = dict(w_value=0.7, w_jac=1.3, weight=w)
    if so > 1:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32))
    before = dict(_build.LAUNCHES)
    lv, lj, d_wb = fd.shapenet_sobolev_grads(wb, x, tgt, jt, cfg, variant, **kw)
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 1
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before["shapenet_sobolev_grads_tc"]
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, variant, **kw)
    rel = 1e-5 if dtype == torch.float32 else 1e-3
    assert float(lv) == pytest.approx(float(rv), rel=rel)
    assert float(lj) == pytest.approx(float(rj), rel=rel)
    err, scale = _max_diff(d_wb, r_wb)
    bound = 5e-5 if dtype == torch.float32 else 2.0 ** -6
    assert d_wb.dtype == dtype and err <= bound * scale, (err, scale)


def test_simt_k6_runs_bf16_chains_the_tensor_core_k6_refuses(card):
    """A bf16 sine chain whose planes the tensor-core K6 cannot hold (width
    512) trains on the CUDA-core body, one launch, within the bf16 bounds."""
    cfg = ShapeNetConfig(3, 1, 512, 1, "sine", False, 30.0)
    assert fd.k6_variant(torch.bfloat16, cfg, "siren") == "simt"
    wb, x = _data(cfg, 2, 200, torch.bfloat16, seed=41)
    tgt, jt, w = _sobolev_side(cfg, 2, 200, seed=41)
    before = dict(_build.LAUNCHES)
    lv, lj, d_wb = fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", weight=w)
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 1
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before["shapenet_sobolev_grads_tc"]
    rv, rj, r_wb = fd.shapenet_sobolev_grads_reference(wb, x, tgt, jt, cfg, "siren", weight=w)
    assert float(lv) == pytest.approx(float(rv), rel=1e-3)
    assert float(lj) == pytest.approx(float(rj), rel=1e-3)
    err, scale = _max_diff(d_wb, r_wb)
    assert d_wb.dtype == torch.bfloat16 and err <= 2.0 ** -6 * scale, (err, scale)


def test_simt_k6_float32_flagship_is_deterministic(card):
    """The float32 K6 at the flagship shape (G=32, P=32768, the float32
    policy's Sobolev step): two runs give the same bits (fixed splits, an
    ordered reduce), finite and of the expected shapes, each one launch of
    the CUDA-core kernel."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 32, 32768, torch.float32, seed=42)
    tgt, jt, w = _sobolev_side(cfg, 32, 32768, seed=42)
    before = dict(_build.LAUNCHES)
    runs = [fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", w_jac=0.1, weight=w)
            for _ in range(2)]
    assert _build.LAUNCHES["shapenet_sobolev_grads"] == before["shapenet_sobolev_grads"] + 2
    assert _build.LAUNCHES["shapenet_sobolev_grads_tc"] == before["shapenet_sobolev_grads_tc"]
    assert tuple(runs[0][2].shape) == tuple(wb.shape)
    for a, b in zip(runs[0], runs[1]):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


# The float32 K4 body (csrc/shapenet_linear.cu on stack_simt.cuh) on what
# sets it apart: trunk widths 24 and 40 and bottlenecks of 20, 15 and 1
# columns (part of a column block, 4-byte weight copies where nk % 4 != 0),
# so = 2 and 3, resblocks, widths 256 (nk or n), 512 and 1024 (fewer rows a
# thread, more column blocks), at P = 200 (a ragged last tile): ((si, so, K,
# units, nlayers, resblock, omega_0), points per tile, where the planes sit).
SIMT_LINEAR_F32 = [
    ((2, 1, 20, 24, 1, False, 5.0), 128, "shared"),
    ((3, 3, 5, 40, 2, True, 10.0), 128, "global"),
    ((2, 1, 1, 16, 1, False, 5.0), 128, "shared"),
    ((3, 2, 128, 128, 2, False, 30.0), 32, "global"),
    ((3, 1, 128, 128, 2, True, 30.0), 64, "global"),
    ((3, 1, 256, 256, 1, False, 30.0), 32, "shared"),
    ((2, 1, 128, 512, 1, False, 30.0), 16, "shared"),
    ((1, 1, 64, 1024, 1, False, 30.0), 8, "global"),
]


@pytest.mark.parametrize("case,tile,residuals", SIMT_LINEAR_F32,
                         ids=["n24-nk20", "n40-nk15-res-so3", "nk1", "so2-nk256", "n128-res",
                              "n256", "n512", "n1024"])
def test_simt_k4_float32_shapes(card, case, tile, residuals):
    """The float32 K4 (the CUDA-core body, full f32 FMAs) on each trunk,
    weighted, at G=3, P=200: one launch of the CUDA-core kernel a call, the
    loss within rel 1e-5 and every gradient within 5e-5 of its max|plain|,
    two runs bitwise equal; the planes where the geometry says."""
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(case, 3, 200, torch.float32, seed=43)
    geo = fl.linear_geometry(cfg, so, 3, 200, torch.float32)
    assert (geo["variant"], geo["tile"], geo["residuals"]) == ("simt", tile, residuals)
    before = dict(_build.LAUNCHES)
    runs = [fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so, w) for _ in range(2)]
    assert _build.LAUNCHES["niflinear_mse_grads"] == before["niflinear_mse_grads"] + 2
    assert _build.LAUNCHES["niflinear_mse_grads_tc"] == before["niflinear_mse_grads_tc"]
    flat = lambda r: [r[0], *r[1], *r[2], r[3], r[4]]  # noqa: E731
    assert all(torch.equal(p, q) for p, q in zip(flat(runs[0]), flat(runs[1])))
    _k4_close(runs[0], fl.niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w),
              torch.float32)


def test_k4_bf16_trunk_the_tensor_core_k4_refuses_runs_on_the_cuda_core_k4(card):
    """A bf16 trunk the tensor-core K4 does not take (width 288 at si = 3,
    K = 128, two hidden layers) trains on the CUDA-core K4, not eager: one
    launch, within the bf16 bounds of plain K4."""
    case = (3, 1, 128, 288, 2, False, 30.0)
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(case, 2, 200, torch.bfloat16, seed=44)
    assert fl._tc_status(cfg, so, 1, 1)[0] != 0
    assert fl.k4_variant(torch.bfloat16, cfg, so) == "simt"
    assert fl.linear_fused_unsupported_reason(cfg, so, 256, card, torch.bfloat16) is None
    before = dict(_build.LAUNCHES)
    outs = fl.niflinear_mse_grads(ws, bs, a, bias, x, tgt, cfg, so, w)
    assert _build.LAUNCHES["niflinear_mse_grads"] == before["niflinear_mse_grads"] + 1
    assert _build.LAUNCHES["niflinear_mse_grads_tc"] == before["niflinear_mse_grads_tc"]
    _k4_close(outs, fl.niflinear_mse_grads_reference(ws, bs, a, bias, x, tgt, cfg, so, w),
              torch.bfloat16)


def test_simt_k4_float32_flagship_is_deterministic(card):
    """The float32 K4 at the flagship NIF-linear shape (G=32, P=32768, the
    float32 policy's NIF-linear step): two runs give the same bits (fixed
    runs of tiles, ordered reduces), finite and of the expected shapes, each
    one launch of the CUDA-core kernel."""
    cfg, so, ws, bs, a, bias, x, tgt, w = _linear_data(LINEAR_CASES[0], 32, 32768,
                                                       torch.float32, seed=45)
    before = dict(_build.LAUNCHES)
    runs = [fl.niflinear_mse_grads_cuda(ws, bs, a, bias, x, tgt, cfg, so) for _ in range(2)]
    assert _build.LAUNCHES["niflinear_mse_grads"] == before["niflinear_mse_grads"] + 2
    assert _build.LAUNCHES["niflinear_mse_grads_tc"] == before["niflinear_mse_grads_tc"]
    flat = lambda r: [r[0], *r[1], *r[2], r[3], r[4]]  # noqa: E731
    assert tuple(runs[0][3].shape) == (32, 128)
    for p, q in zip(flat(runs[0]), flat(runs[1])):
        assert bool(torch.isfinite(p).all()) and torch.equal(p, q)


# The CUDA-core K1 and K5's CUDA-core reverse body (one body, shapenet_fwd.cu)
# in float32 over the shapes they take: widths 24, 40, 128, 256 and 1024 (the
# five register tiles of stack_simt.cuh), si 1-7 (x tiles of round4(si)
# columns), so 1-3 (so < si for K5), plain, resblock and vanilla chains;
# W_last, the biases and W0' in shared memory or read from global memory, and
# (K5 at width 1024 with four hidden matrices) the planes in the global
# scratch. (ShapeNetConfig args, variant, where K5's planes sit.)
SIMT_K1_F32 = [
    ((1, 1, 24, 2, "sine", False, 30.0), "siren"),
    ((2, 3, 40, 2, "sine", True, 10.0), "siren"),
    ((3, 1, 128, 2, "sine", False, 30.0), "siren"),
    ((4, 2, 256, 2, "sine", True, 30.0), "siren"),
    ((7, 1, 1024, 1, "sine", False, 30.0), "siren"),
    ((5, 2, 40, 2, "swish"), "vanilla"),
    ((6, 3, 256, 1, "tanh"), "vanilla"),
]
SIMT_K5_F32 = [
    ((2, 1, 24, 2, "sine", False, 30.0), "siren", "shared"),
    ((3, 2, 40, 2, "sine", True, 10.0), "siren", "shared"),
    ((3, 1, 128, 2, "sine", False, 30.0), "siren", "shared"),
    ((4, 3, 256, 2, "sine", True, 30.0), "siren", "shared"),
    ((7, 2, 1024, 2, "sine", True, 30.0), "siren", "global"),
    ((5, 2, 40, 2, "swish"), "vanilla", "shared"),
    ((6, 3, 128, 1, "relu"), "vanilla", "shared"),
]


def _simt_bound(mine, ref):
    """float32: max|d| <= 2e-4 max|plain| + 1e-5 (the K1/K5 bound)."""
    err, scale = _max_diff(mine, ref)
    assert bool(torch.isfinite(mine.float()).all()) and err <= 2e-4 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("P", [200, 256])
@pytest.mark.parametrize("args,variant", SIMT_K1_F32,
                         ids=["n24-si1", "n40-res-si2-so3", "n128", "n256-res-si4",
                              "n1024-si7", "van-n40-si5", "van-n256-si6-so3"])
def test_simt_k1_float32_shapes(card, args, variant, P):
    """The float32 K1 on the CUDA-core body at P = 200 (a ragged last tile)
    and 256 over three groups: one launch, the geometry's body "simt", within
    2e-4 max|plain| + 1e-5 of plain K1."""
    cfg = ShapeNetConfig(*args)
    geo = fs.k1_geometry(cfg, variant, 3, P, torch.float32)
    assert (geo["kernel"], geo["body"]) == ("simt", "simt")
    wb, x = _data(cfg, 3, P, torch.float32, seed=60)
    before = dict(_build.LAUNCHES)
    out = fs.shapenet_fwd_cuda(wb, x, cfg, variant)
    assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 1
    assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"]
    assert out.dtype == torch.float32 and out.shape == (3, P, cfg.output_dim)
    _simt_bound(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, variant))


@pytest.mark.parametrize("P", [200, 256])
@pytest.mark.parametrize("args,variant,residuals", SIMT_K5_F32,
                         ids=["n24-si2", "n40-res-si3-so2", "n128", "n256-res-si4-so3",
                              "n1024-res-si7-so2", "van-n40-si5-so2", "van-n128-si6-so3"])
def test_simt_k5_reverse_float32_shapes(card, args, variant, residuals, P):
    """K5's float32 reverse body (so < si) on the CUDA-core body at P = 200
    and 256: one launch, the geometry's body "simt" with its planes where
    expected, y and jac within 2e-4 max|plain| + 1e-5 of plain K5."""
    cfg = ShapeNetConfig(*args)
    assert fd._jac_mode(cfg, cfg.input_dim) == "reverse"
    geo = fd.derivative_geometry("reverse", cfg, variant, 3, P, torch.float32)
    assert (geo["kernel"], geo["body"], geo["residuals"]) == ("simt", "simt", residuals)
    wb, x = _data(cfg, 3, P, torch.float32, seed=61)
    before = dict(_build.LAUNCHES)
    y, jac = fd.shapenet_fwd_jac_cuda(wb, x, cfg, variant)
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"]
    assert jac.shape == (3, P, cfg.output_dim, cfg.input_dim)
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, variant)
    _simt_bound(y, y_ref)
    _simt_bound(jac, jac_ref)


# bf16 shapes the tensor-core K1 and K5 refuse, on the CUDA-core body: a
# vanilla chain, si > 4, K1 above width 800, K5 above 208.
SIMT_BF16 = [
    ("k1", "vanilla", (2, 1, 64, 2, "sigmoid")),
    ("k1", "siren", (6, 2, 128, 2, "sine", True, 30.0)),
    ("k1", "siren", (3, 1, 1024, 1, "sine", False, 30.0)),
    ("k5", "vanilla", (3, 2, 64, 2, "swish")),
    ("k5", "siren", (6, 2, 128, 2, "sine", True, 30.0)),
    ("k5", "siren", (3, 1, 256, 2, "sine", False, 30.0)),
]


@pytest.mark.parametrize("kernel,variant,args", SIMT_BF16,
                         ids=["k1-vanilla", "k1-si6-res", "k1-n1024", "k5-vanilla",
                              "k5-si6-res", "k5-n256"])
def test_simt_k1_k5_bf16_shapes_the_tensor_core_kernels_refuse(card, kernel, variant, args):
    """bf16 chains the tensor-core K1 or K5 refuses run on the CUDA-core body
    (geometry body "simt", one launch, no tensor-core launch), within 2^-6
    of max|plain| (the bf16 bound)."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 2, 200, torch.bfloat16, seed=62)
    before = dict(_build.LAUNCHES)
    if kernel == "k1":
        assert fs.k1_variant(torch.bfloat16, cfg, variant) == "simt"
        assert fs.k1_geometry(cfg, variant, 2, 200, torch.bfloat16)["body"] == "simt"
        out = fs.shapenet_fwd_cuda(wb, x, cfg, variant)
        assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 1
        assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"]
        pairs = [(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, variant))]
    else:
        assert fd.k5_variant(torch.bfloat16, cfg, variant) == "simt"
        geo = fd.derivative_geometry("reverse", cfg, variant, 2, 200, torch.bfloat16)
        assert geo["body"] == "simt"
        outs = fd.shapenet_fwd_jac_cuda(wb, x, cfg, variant)
        assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 1
        assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"]
        pairs = list(zip(outs, fd.shapenet_fwd_jac_reference(wb, x, cfg, variant)))
    for mine, ref in pairs:
        assert mine.dtype == torch.bfloat16 and bool(torch.isfinite(mine.float()).all())
        _close_rel(mine, ref, torch.bfloat16)


def test_simt_k1_k5_float32_flagship_is_deterministic(card):
    """The float32 K1 and K5 reverse body at the flagship chain (G=8,
    P=32768): two runs of each give the same bits (per-point outputs, fixed
    row sums), one launch each of the CUDA-core body, within the float32
    bound of their plain versions."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    wb, x = _data(cfg, 8, 32768, torch.float32, seed=63)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k1 = fs.k1_geometry(cfg, "siren", 8, 32768, torch.float32)
    assert (k1["body"], k1["tile"], k1["blocks_per_sm"], k1["blocks"]) == ("simt", 64, 2, 2 * sms)
    before = dict(_build.LAUNCHES)
    outs = [fs.shapenet_fwd_cuda(wb, x, cfg, "siren") for _ in range(2)]
    jacs = [fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren") for _ in range(2)]
    assert _build.LAUNCHES["shapenet_fwd"] == before["shapenet_fwd"] + 2
    assert _build.LAUNCHES["shapenet_fwd_jac"] == before["shapenet_fwd_jac"] + 2
    assert _build.LAUNCHES["shapenet_fwd_tc"] == before["shapenet_fwd_tc"]
    assert _build.LAUNCHES["shapenet_fwd_jac_tc"] == before["shapenet_fwd_jac_tc"]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(jacs[0][0], jacs[1][0]) and torch.equal(jacs[0][1], jacs[1][1])
    _simt_bound(outs[0], fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren"))
    y_ref, jac_ref = fd.shapenet_fwd_jac_reference(wb, x, cfg, "siren")
    _simt_bound(jacs[0][0], y_ref)
    _simt_bound(jacs[0][1], jac_ref)


# ------------------------------------------- GroupedLBFGS on the fused kernels
LBFGS_S = {"input_dim": 2, "output_dim": 1, "units": 64, "nlayers": 2, "activation": "sine",
           "use_resblock": False, "omega_0": 10.0, "connectivity": "full",
           "weight_init_factor": 0.01}
LBFGS_P = {"input_dim": 1, "latent_dim": 8, "units": 32, "nlayers": 1, "activation": "swish"}


def _lbfgs_problem(G=6, P=2048, seed=40):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h = f(G, P, 1, 2, 2)
    return (f(G, 1), f(G, P, 2), f(G, P, 1), rng.uniform(0.5, 1.5, (G, P)).astype(np.float32),
            f(G, P, 1, 2), 0.5 * (h + h.transpose(0, 1, 2, 4, 3)))


def _flat(grads):
    return torch.cat([g.reshape(-1).float() for g in grads])


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
@pytest.mark.parametrize("kind,wrapper", [("mse", "shapenet_mse_grads"),
                                          ("sobolev", "shapenet_sobolev_grads"),
                                          ("hessian", "shapenet_hessian_grads")])
@pytest.mark.parametrize("chunk_groups", [None, 4])
def test_grouped_lbfgs_fused_objective_matches_eager(card, policy, kind, wrapper,
                                                     chunk_groups):
    """The fused objective (one K2, K6 or K8 launch an evaluation, or a
    chunk) against the eager one on the same card: float32 value rel 1e-5
    and gradient max|d| <= 1e-4 of max|eager| (K8's bound, the loosest of
    the three passes'); bf16 value rel 1e-2 and gradient rel-L2 <= 0.15
    (``chip_smoke.py``'s bound for bf16 fused against eager ParameterNet
    gradients: the eager chain rounds omega*(u@W) to bf16 and takes the
    exact sine, the kernels their own rounding points and polynomial sine)."""
    from nif_tpu_torch.optimizers import GroupedLBFGS

    t, x, u, w, tj, th = _lbfgs_problem()
    extra = {"mse": {}, "sobolev": {"target_jac": tj},
             "hessian": {"target_jac": tj, "target_hess": th}}[kind]
    model = nif_tpu_torch.NIFMultiScale(LBFGS_S, LBFGS_P, policy, device="cuda", seed=2)
    kw = dict(weight=w, w_jac=0.3, w_hess=0.1, chunk_groups=chunk_groups, **extra)
    _build.reset_launches()
    v_f, g_f = GroupedLBFGS(model, t, x, u, fused=True, **kw)._value_and_grads()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    v_e, g_e = GroupedLBFGS(model, t, x, u, fused=False, **kw)._value_and_grads()
    chunks = 1 if chunk_groups is None else -(-t.shape[0] // chunk_groups)
    assert launches[wrapper] == chunks
    assert sum(v for k, v in launches.items() if not k.startswith(wrapper)) == 0
    g_f, g_e = _flat(g_f), _flat(g_e)
    if policy == "float32":
        assert float(v_f) == pytest.approx(float(v_e), rel=1e-5)
        assert float(torch.max(torch.abs(g_f - g_e))) <= 1e-4 * float(torch.max(torch.abs(g_e)))
    else:
        assert float(v_f) == pytest.approx(float(v_e), rel=1e-2)
        assert float(torch.linalg.vector_norm(g_f - g_e)) <= 0.15 * float(
            torch.linalg.vector_norm(g_e))


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_grouped_lbfgs_launches_k2_once_an_evaluation(card, policy):
    from nif_tpu_torch.optimizers import GroupedLBFGS

    t, x, u, w, _, _ = _lbfgs_problem()
    model = nif_tpu_torch.NIFMultiScale(LBFGS_S, LBFGS_P, policy, device="cuda", seed=3)
    opt = GroupedLBFGS(model, t, x, u, weight=w)
    _build.reset_launches()
    opt.minimize(max_iter=8)
    torch.cuda.synchronize()
    evaluations = opt.counts["evaluations"]
    assert evaluations >= 8 and _build.LAUNCHES["shapenet_mse_grads"] == evaluations
    # bf16: the tensor-core body K2's routing picks for the chain
    body = fs.k2_variant(model.policy.compute_dtype, model.cfg_shape_net, "siren")
    assert (body == "simt") == (policy == "float32")
    got, want = _launched("shapenet_mse_grads", {k: 0 for k in _build.LAUNCHES}, body,
                          evaluations)
    assert got == want
    h = opt.history["loss"]
    assert all(b <= a for a, b in zip(h, h[1:])) and h[-1] < h[0]
    _build.reset_launches()
    opt.minimize(max_iter=3, dtype="float64")
    assert not any(_build.LAUNCHES.values()) and model._any_f64()


# ------------------------------------- the int8 ROM decode and the export
@pytest.mark.parametrize("G,P,so,K", [(6, 97, 1, 8), (6, 50, 3, 8), (20, 33, 1, 5),
                                      (256, 4096, 1, 128)])
def test_int8_product_padded_to_int_mm_rules_is_exact(card, G, P, so, K):
    """``torch._int_mm`` on the card through the decode's padding, at shapes
    that break its rules (at most 16 rows, P * so or K no multiple of 8) and
    at the flagship's K: the int32 result equals the float64 product of the
    same int8 values (exact: |sum| <= 127^2 K < 2^53)."""
    from nif_tpu_torch.compression import quantization as tq

    rng = np.random.default_rng(G * P + K)
    q_a = torch.from_numpy(rng.integers(-127, 128, (G, K)).astype(np.int8)).to(card)
    q_phi = torch.from_numpy(rng.integers(-127, 128, (P * so, K)).astype(np.int8)).to(card)
    acc = tq._int8_product(q_a, tq._mm_operand(q_phi), P * so)
    assert acc.is_cuda and acc.dtype == torch.int32 and acc.shape == (G, P * so)
    assert torch.equal(acc.double(), q_a.double() @ q_phi.double().T)


def test_rom_decode_int8_on_the_card_tracks_the_float32_decode(card):
    from nif_tpu_torch.compression import quantize_shared_mesh, rom_decode_int8
    from nif_tpu_torch.serving import predict_shared_mesh

    cfg_s = {"input_dim": 1, "output_dim": 2, "units": 16, "nlayers": 1, "activation": "sine",
             "omega_0": 30.0, "connectivity": "last_layer", "weight_init_factor": 0.1}
    cfg_p = {"input_dim": 1, "latent_dim": 8, "units": 16, "nlayers": 1, "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(cfg_s, cfg_p, device="cuda")
    rng = np.random.default_rng(0)
    t = rng.standard_normal((6, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (97, 1)).astype(np.float32)
    pack = quantize_shared_mesh(model, x)
    u8 = rom_decode_int8(model, pack, t)
    with torch.no_grad():
        uf = model.apply_shared_mesh(t, x)
    assert u8.is_cuda and u8.shape == uf.shape == (6, 97, 2)
    assert float(torch.linalg.vector_norm(u8 - uf) / torch.linalg.vector_norm(uf)) < 1e-2
    out = predict_shared_mesh(model, t, int8_pack=pack, group_batch=4)
    assert np.array_equal(out[:4], rom_decode_int8(model, pack, t[:4]).cpu().numpy())


@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_exported_grouped_artifact_launches_k1(card, policy):
    """The ``grouped`` artifact holds one call of K1's registered op, which
    launches K1 once a call (the tensor-core one under bf16), bit for bit
    ``apply_grouped``."""
    from nif_tpu_torch.serving import export_apply, load_exported

    cfg_s = {"input_dim": 3, "output_dim": 1, "units": 64, "nlayers": 2, "activation": "sine",
             "omega_0": 30.0}
    cfg_p = {"input_dim": 4, "latent_dim": 16, "units": 32, "nlayers": 1, "activation": "swish"}
    model = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, policy, device="cuda", seed=0)
    G, P = 4, 512
    assert model.fast_path_info(P)["path"] == "fused"
    fn = load_exported(export_apply(model, batch_size=P, layout="grouped", group_batch=G))
    ops = [n.target for n in fn.program.graph.nodes
           if n.op == "call_function" and "nif_tpu_torch" in str(n.target)]
    assert ops == [torch.ops.nif_tpu_torch.shapenet_fwd.default]
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((G, 4)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)).to(card)
    with torch.inference_mode():
        ref = model.apply_grouped(t, x)
    _build.reset_launches()
    out = fn(t, x)
    torch.cuda.synchronize()
    # bf16 on the body K1 routes the width-64 chain to (wgmma), f32 on the CUDA cores
    body = fs.k1_variant(model.policy.compute_dtype, model.cfg_shape_net, "siren")
    assert body == ("wgmma" if policy == "mixed_bfloat16" else "simt")
    got, want = _launched("shapenet_fwd", {k: 0 for k in _build.LAUNCHES}, body)
    assert got == want
    assert sum(_build.LAUNCHES.values()) == 1 + int(body != "simt")
    assert torch.equal(out, ref)


# The wgmma K2/K3 body (csrc/shapenet_bwd_wgmma.cu): the CASES chains it
# takes (sine chains at widths 64 and 128), then what sets it apart: si and
# so from 1 to 4, a resblock chain of two blocks, width 64 with four hidden
# layers, and P of one partial tile (8 points), one ragged tile (56), eight
# points past a tile (72) and a ragged run (200); P stays a multiple of 8,
# the fused path's rule.
WG_CASES = [args for variant, args in CASES if variant == "siren" and args[2] in (64, 128)]
WG_SHAPES = [((1, 1, 64, 2, "sine", False, 30.0), 2, 8),
             ((4, 4, 64, 4, "sine", False, 30.0), 3, 56),
             ((2, 3, 128, 1, "sine", True, 10.0), 2, 72),
             ((3, 2, 64, 2, "sine", True, 10.0), 3, 200),
             ((3, 1, 128, 2, "sine", False, 30.0), 40, 200)]
# bf16 loss of one tensor-core body against the other: each product is
# exact, only the order of the f32 sums differs (chip_smoke.py's TC_LOSS_REL)
TC_LOSS_REL = 1e-4


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("args", WG_CASES, ids=["n128", "n64-res"])
def test_wgmma_k2_matches_plain_and_the_mma_sync_body(card, args, weighted):
    """The wgmma K2 at P = 200 (a ragged last tile) against plain K2 (loss
    rel 1e-3, d_wb within 2^-6 of max|plain|) and its loss against the
    mma.sync body's on the same inputs (rel 1e-4); one wgmma launch a call."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=40)
    tgt, w, _ = _side(cfg, 3, 200, torch.bfloat16, seed=40)
    w = w if weighted else None
    before = dict(_build.LAUNCHES)
    loss, d_wb = fs._shapenet_mse_grads_on("wgmma", wb, x, tgt, cfg, "siren", w)
    got, want = _launched("shapenet_mse_grads", before, "wgmma")
    assert got == want
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert loss.dtype == torch.float32 and d_wb.dtype == torch.bfloat16
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)
    l_tc, _ = fs._shapenet_mse_grads_on("tc", wb, x, tgt, cfg, "siren", w)
    assert float(loss) == pytest.approx(float(l_tc), rel=TC_LOSS_REL)


@pytest.mark.parametrize("args", WG_CASES, ids=["n128", "n64-res"])
def test_wgmma_k3_matches_plain(card, args):
    """The wgmma K3 at P = 200 against plain K3: d_wb and dx within 2^-6 of
    max|plain|; one wgmma launch a call."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=41)
    g = _side(cfg, 3, 200, torch.bfloat16, seed=41)[2]
    before = dict(_build.LAUNCHES)
    d_wb, dx = fs._shapenet_bwd_on("wgmma", wb, x, g, cfg, "siren")
    got, want = _launched("shapenet_bwd", before, "wgmma")
    assert got == want
    assert d_wb.dtype == dx.dtype == torch.bfloat16 and dx.shape == x.shape
    for mine, ref in zip((d_wb, dx), fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


@pytest.mark.parametrize("args,G,P", WG_SHAPES,
                         ids=["si1-so1-p8", "si4-so4-d4-p56", "res-so3-p72", "res-n64-p200",
                              "g40-p200"])
def test_wgmma_k2_k3_shapes(card, args, G, P):
    """The wgmma K2 (weighted) and K3 on the shapes that set it apart,
    against their plain versions within the bf16 bounds; G = 40 puts more
    groups than SMs / splits, so a block walks several groups."""
    cfg = ShapeNetConfig(*args)
    assert fs._wg_status("train", cfg, "siren", G, P)[0] == 0
    wb, x = _data(cfg, G, P, torch.bfloat16, seed=42)
    tgt, w, g = _side(cfg, G, P, torch.bfloat16, seed=42)
    loss, d_wb = fs._shapenet_mse_grads_on("wgmma", wb, x, tgt, cfg, "siren", w)
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(d_wb, g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)
    for mine, ref in zip(fs._shapenet_bwd_on("wgmma", wb, x, g, cfg, "siren"),
                         fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_wgmma_k2_k3_flagship_is_deterministic(card):
    """The flagship chain at G=32, P=32768 in bf16 on the wgmma body: K2
    (weighted) and K3 twice each on one input give the same bits (each
    consumer adds its tiles in order into its own partial, an ordered
    reduce), within the bf16 bounds of their plain versions; K2's loss
    within 1e-4 of the mma.sync body's."""
    cfg = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    geo = fs.k2_geometry(cfg, "siren", 32, 32768, torch.bfloat16, kernel="wgmma")
    assert (geo["kernel"], geo["tile"], geo["residuals"], geo["weights"]) == (
        "wgmma", 128, "shared", "shared")
    wb, x = _data(cfg, 32, 32768, torch.bfloat16, seed=43)
    tgt, w, g = _side(cfg, 32, 32768, torch.bfloat16, seed=43)
    runs = [fs._shapenet_mse_grads_on("wgmma", wb, x, tgt, cfg, "siren", w) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    l_ref, g_ref = fs.shapenet_mse_grads_reference(wb, x, tgt, cfg, "siren", w)
    assert float(runs[0][0]) == pytest.approx(float(l_ref), rel=1e-3)
    err, scale = _max_diff(runs[0][1], g_ref)
    assert err <= 2.0 ** -6 * scale, (err, scale)
    l_tc, _ = fs._shapenet_mse_grads_on("tc", wb, x, tgt, cfg, "siren", w)
    assert float(runs[0][0]) == pytest.approx(float(l_tc), rel=TC_LOSS_REL)
    bwd = [fs._shapenet_bwd_on("wgmma", wb, x, g, cfg, "siren") for _ in range(2)]
    assert torch.equal(bwd[0][0], bwd[1][0]) and torch.equal(bwd[0][1], bwd[1][1])
    for mine, ref in zip(bwd[0], fs.shapenet_fused_bwd_reference(wb, x, g, cfg, "siren")):
        err, scale = _max_diff(mine, ref)
        assert err <= 2.0 ** -6 * scale, (err, scale)


def test_wgmma_geometry_takes_and_refuses(card):
    """The wgmma workspace entry: the flagship fits (128-point tiles, SMs //
    32 splits, everything in shared memory, no scratch for a plain chain);
    width 128 past two hidden matrices, and bench.py's w128_d4_resblock,
    exceed shared memory (status 2); width 256 (bench.py's w256_d2), si 5
    and so 5 have no instance (status 3), and route to the mma.sync body."""
    flagship = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    status, geo = fs._wg_status("train", flagship, "siren", 32, 32768)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert status == 0 and (geo["tile"], geo["splits"], geo["scratch_bytes"]) == (
        128, min(sms // 32, 64), 0)
    assert geo["smem_bytes"] <= 232448
    for args in ((3, 1, 128, 3, "sine", False, 30.0), (3, 1, 128, 4, "sine", True, 30.0)):
        assert fs._wg_status("train", ShapeNetConfig(*args), "siren", 32, 32768)[0] == 2
        assert fs.k2_variant(torch.bfloat16, ShapeNetConfig(*args), "siren") == "tc"
    for args in ((3, 1, 256, 2, "sine", False, 30.0), (5, 1, 64, 2, "sine", False, 30.0),
                 (3, 5, 64, 2, "sine", False, 30.0)):
        assert fs._wg_status("backward", ShapeNetConfig(*args), "siren", 32, 32768)[0] == 3
        assert fs.k3_variant(torch.bfloat16, ShapeNetConfig(*args), "siren") != "wgmma"


# The chains the wgmma K7/K8 body takes (si = 3, widths 64 and 128, so <= 4,
# every W_m and both consumers' planes in shared memory): the flagship, a
# resblock at width 128 (two matrices), width 64 with so = 3, and a resblock
# at width 64 with four matrices and so = 4.
WG_HESS_SHAPES = [
    (3, 1, 128, 2, "sine", False, 30.0),
    (3, 2, 128, 1, "sine", True, 30.0),
    (3, 3, 64, 2, "sine", False, 30.0),
    (3, 4, 64, 2, "sine", True, 10.0),
]
WG_HESS_IDS = ["flagship", "res-w128-so2", "w64-so3", "res-w64-d4-so4"]


@pytest.mark.parametrize("args", WG_HESS_SHAPES, ids=WG_HESS_IDS)
def test_k7_wgmma_matches_plain_and_the_mma_sync_body(card, args):
    """The wgmma K7 by name at three groups of P = 200 (a ragged last
    16-point tile, one consumer's half of it empty): y, jac and hess within
    2^-6 of max|plain| of plain K7 and of the mma.sync body's on the same
    inputs, the Hessian exactly symmetric."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=53)
    before = dict(_build.LAUNCHES)
    outs = fh._shapenet_fwd_hess_on("wgmma", wb, x, cfg, "siren")
    got, want = _launched("shapenet_fwd_hess", before, "wgmma")
    assert got == want
    si, so = cfg.input_dim, cfg.output_dim
    assert outs[2].shape == (3, 200, so, si, si)
    assert torch.equal(outs[2], outs[2].transpose(-1, -2))
    for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
        assert mine.dtype == torch.bfloat16 and bool(torch.isfinite(mine).all())
        _close_rel(mine, ref, torch.bfloat16)
    for mine, other in zip(outs, fh._shapenet_fwd_hess_on("tc", wb, x, cfg, "siren")):
        _close_rel(mine, other, torch.bfloat16)


@pytest.mark.parametrize("weighted,masked", [(False, False), (True, False), (True, True)],
                         ids=["unweighted", "weighted", "weighted-masked"])
@pytest.mark.parametrize("args", WG_HESS_SHAPES, ids=WG_HESS_IDS)
def test_k8_wgmma_matches_plain(card, args, weighted, masked):
    """The wgmma K8 by name at three groups of P = 200, at the bounds of
    test_k8_matches_plain (terms rel 1e-3, d_wb within 2^-6 of max|plain|),
    unweighted, weighted, and weighted with the value, Jacobian and Hessian
    masks (the first output, every other Jacobian entry, two of three
    Hessian entries)."""
    cfg = ShapeNetConfig(*args)
    wb, x = _data(cfg, 3, 200, torch.bfloat16, seed=54)
    tgt, jt, ht, w = _hessian_side(cfg, 3, 200, seed=54)
    si, so = cfg.input_dim, cfg.output_dim
    kw = dict(w_value=0.7, w_jac=1.3, w_hess=0.4, weight=w if weighted else None)
    if masked:
        kw.update(y_mask=np.eye(1, so, dtype=np.float32)[0],
                  jac_mask=(np.arange(si * so) % 2 == 0).astype(np.float32),
                  hess_mask=(np.arange(si * (si + 1) // 2 * so) % 3 != 1).astype(np.float32))
    before = dict(_build.LAUNCHES)
    *terms, d_wb = fh._shapenet_hessian_grads_on("wgmma", wb, x, tgt, jt, ht, cfg, "siren", **kw)
    got, want = _launched("shapenet_hessian_grads", before, "wgmma")
    assert got == want
    *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren", **kw)
    for mine, ref in zip(terms, refs):
        assert float(mine) == pytest.approx(float(ref), rel=1e-3)
    assert d_wb.dtype == torch.bfloat16 and d_wb.shape == r_wb.shape
    err, scale = _max_diff(d_wb, r_wb)
    assert err <= 2.0 ** -6 * scale, (err, scale)


# the wgmma K7/K8's reason for each status it refuses with
REFUSED_AS = {2: "bytes of shared memory per block in the wgmma Hessian",
              3: "the wgmma Hessian (evaluation|train) kernel has no instance"}


def test_k7_k8_wgmma_geometry_takes_and_refuses(card):
    """The wgmma K7/K8 library's own geometry: the flagship at G = 1 and 32
    (16-point tiles, SMs / G splits capped at 64 and at the group's tiles,
    every W_m and the planes in shared memory, no scratch for a plain chain);
    status 2 past shared memory (K8: width 128 with three hidden matrices,
    and a resblock of two blocks; K7: five matrices, while it takes four);
    status 3 for what it has no instance for (si = 2 and 4, so = 5, widths
    96 and 256; asked of the library only where the width and si are the
    instances'). Each refused chain routes to the mma.sync body and agrees
    with its plain version."""
    flagship = ShapeNetConfig(3, 1, 128, 2, "sine", False, 30.0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for G in (1, 32):
        for mode in ("eval", "train"):
            geo = fh.hessian_geometry(mode, flagship, "siren", G, 32768, torch.bfloat16,
                                      kernel="wgmma")
            assert (geo["tile"], geo["splits"], geo["weights"], geo["scratch_bytes"]) == (
                16, min(64, max(1, sms // G)), "shared", 0)
            assert geo["smem_bytes"] <= 232448
    assert fh.hessian_geometry("eval", ShapeNetConfig(3, 1, 128, 4, "sine"), "siren", 2, 64,
                               torch.bfloat16, kernel="wgmma")["kernel"] == "wgmma"
    refused = [("train", (3, 1, 128, 3, "sine", False, 30.0), 2),
               ("train", (3, 1, 128, 2, "sine", True, 30.0), 2),
               ("eval", (3, 1, 128, 5, "sine", False, 30.0), 2),
               ("train", (2, 2, 64, 1, "sine", True, 10.0), 3),
               ("eval", (4, 1, 128, 2, "sine", False, 30.0), 3),
               ("train", (3, 5, 64, 2, "sine", False, 30.0), 3),
               ("eval", (3, 1, 96, 2, "sine", False, 30.0), 3),
               ("train", (3, 1, 256, 2, "sine", False, 30.0), 3)]
    for mode, args, code in refused:
        cfg = ShapeNetConfig(*args)
        with pytest.raises(ValueError, match=REFUSED_AS[code]):
            fh.hessian_geometry(mode, cfg, "siren", 2, 96, torch.bfloat16, kernel="wgmma")
        pick = fh.k7_variant if mode == "eval" else fh.k8_variant
        body = pick(torch.bfloat16, cfg, "siren")
        assert body == "tc", args
        wb, x = _data(cfg, 2, 96, torch.bfloat16, seed=56)
        before = dict(_build.LAUNCHES)
        if mode == "eval":
            outs = fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren")
            for mine, ref in zip(outs, fh.shapenet_fwd_hess_reference(wb, x, cfg, "siren")):
                _close_rel(mine, ref, torch.bfloat16)
            got, want = _launched("shapenet_fwd_hess", before, "tc")
        else:
            tgt, jt, ht, w = _hessian_side(cfg, 2, 96, seed=56)
            *terms, d_wb = fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren",
                                                          weight=w)
            *refs, r_wb = fh.shapenet_hessian_grads_reference(wb, x, tgt, jt, ht, cfg, "siren",
                                                              weight=w)
            for mine, ref in zip(terms, refs):
                assert float(mine) == pytest.approx(float(ref), rel=1e-3)
            err, scale = _max_diff(d_wb, r_wb)
            assert err <= 2.0 ** -6 * scale, (err, scale)
            got, want = _launched("shapenet_hessian_grads", before, "tc")
        assert got == want, args
    with pytest.raises(ValueError, match="wgmma Hessian train kernel"):
        fh.hessian_geometry("train", ShapeNetConfig(3, 1, 128, 3, "sine"), "siren", 2, 96,
                            torch.bfloat16, kernel="wgmma")
    with pytest.raises(ValueError, match="takes bfloat16"):
        fh.hessian_geometry("eval", flagship, "siren", 2, 96, torch.float32, kernel="wgmma")


# The reference's K1 in bf16 on the deep plain chain (tests/test_torch_k1_deep_chain.py
# regenerates it from nif_tpu and pins it)
K1_DEEP_FIXTURE = Path(__file__).resolve().parent / "data" / "k1_deep_chain_bf16.npz"


def test_k1_deep_plain_chain_against_the_reference_fixture(card):
    """The mma.sync K1 on the deep plain chain ShapeNetConfig(3, 1, 128, 7,
    "sine", False, 30.0) (seven hidden matrices, which the wgmma K1 refuses)
    at the fixture's G = 2, P = 96 and each of its seeds, against plain K1,
    with the committed output of nif_tpu's K1 on the same inputs setting the
    bound. The reference itself sits 2.18e-3 to 7.32e-2 of max|plain| from plain
    K1 over those seeds: seven sine layers at omega_0 = 30 amplify a bf16
    rounding that flips with the order of an f32 sum, so a seed's gap is one
    draw of the chain's scatter. So the kernel is held, at every seed,
    within the largest distance the reference sits from plain K1 over the
    seeds (its worst reading, no looser). A body whose product blocks are
    added the tensor core's way (rounding toward zero) sits past it at six
    of the seeds in the CPU model of tests/test_torch_k1_deep_chain.py."""
    cfg = ShapeNetConfig(3, 1, 128, 7, "sine", False, 30.0)
    assert fs.k1_variant(torch.bfloat16, cfg, "siren") == "tc"
    with np.load(K1_DEEP_FIXTURE) as z:
        seeds, G, P = [int(v) for v in z["seeds"]], int(z["G"]), int(z["P"])
        refs = torch.from_numpy(z["out_bits"].view(np.int16)).view(torch.bfloat16)
    errs, gaps = [], []
    for seed, ref in zip(seeds, refs):
        wb, x = _data(cfg, G, P, torch.bfloat16, seed=seed)
        before = dict(_build.LAUNCHES)
        out = fs.shapenet_fwd_cuda(wb, x, cfg, "siren")
        got, want = _launched("shapenet_fwd", before, "tc")
        assert got == want
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        plain = fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren")
        gap, scale = _max_diff(ref, plain)  # the reference's own distance from plain K1
        gaps.append(gap / scale)
        errs.append(_max_diff(out, plain)[0] / scale)
    assert max(errs) <= max(gaps), (errs, gaps)
