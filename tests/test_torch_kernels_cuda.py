"""The port's CUDA kernels on a card (marker ``cuda``; each test skips
without one). This file imports neither JAX nor ``nif_tpu``, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs are made with numpy from a seed. K1 is held against its plain
version on the same card: f32 rtol 2e-4 / atol 1e-5 (the JAX kernel tests'
bound; both sum in f32 in different orders); bf16 max|d| <= 1e-2 * max|plain|
(an f32 last-bit difference can flip the bf16 rounding of one activation)."""
import numpy as np
import pytest
import torch

import nif_tpu_torch
from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.ops import _build
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
    out = fs.shapenet_fwd_cuda(wb, x, cfg, variant)
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
    """The kernel's library owns its launch geometry: points per block by
    width, and the widths it refuses."""
    mk = lambda n, si=3: ShapeNetConfig(si, 1, n, 2, "sine")  # noqa: E731
    assert fs.kernel_geometry(mk(128)) == (64, None)
    assert fs.kernel_geometry(mk(256)) == (32, None)
    assert fs.kernel_geometry(mk(16)) == (64, None)
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
    with torch.inference_mode():
        out = model.apply_grouped(t, x)
        wb = model.p_to_w(t)
        ref = fs.shapenet_grouped_fused_reference(
            wb, model.policy.cast_to_compute(x, device="cuda"), model.cfg_shape_net, "siren")
    assert _build.LAUNCHES["shapenet_fwd"] == before + 1
    err, scale = _max_diff(out, ref)
    assert out.dtype == torch.float32 and err <= 1e-2 * scale
    # with gradients needed, auto routing refuses (no K3 yet); fused=False
    # is the explicit eager autograd path
    with pytest.raises(RuntimeError, match="K3"):
        model.apply_grouped(t, x)
    out = model.apply_grouped(t, x, fused=False)
    assert out.requires_grad and _build.LAUNCHES["shapenet_fwd"] == before + 1
