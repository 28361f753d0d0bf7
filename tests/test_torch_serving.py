"""The port's models and serving path (``nif_tpu_torch``) against the JAX
package on the CPU: the flagship NIFMultiScale at its full widths
(po = 33665) with few groups and points, under the float32 policy.

The JAX model draws its parameters; they cross to the port as numpy arrays
(``from_jax_params``), and both packages get the same numpy inputs. f32
outputs agree to rtol 1e-4 / atol 1e-5: the same chain summed in another
order, through omega_0 = 30 sines."""
import json

import jax
import numpy as np
import pytest
import torch

import nif_tpu
from nif_tpu.ops.pallas_shapenet import shapenet_grouped_fused as jax_fused
from nif_tpu.serving import predict as jax_predict
from nif_tpu.serving import predict_grouped as jax_predict_grouped
import nif_tpu_torch
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.ops import _build
from nif_tpu_torch.serving import predict, predict_grouped

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5

CFG_S = {"input_dim": 3, "output_dim": 1, "units": 128, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.01}
CFG_P = {"input_dim": 4, "latent_dim": 128, "units": 128, "nlayers": 2,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0}


@pytest.fixture(scope="module")
def flagship():
    jm = nif_tpu.NIFMultiScale(CFG_S, CFG_P, mixed_policy="float32")
    params = jm.init(jax.random.key(0))
    tm = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, mixed_policy="float32", device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _inputs(G, P, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, 4)).astype(np.float32),
            rng.uniform(-1, 1, (G, P, 3)).astype(np.float32))


def test_flagship_widths(flagship):
    jm, _, tm = flagship
    assert tm.po_dim == jm.po_dim == 33665
    assert tm.pnet_kind == jm.pnet_kind == "mlp_hyper"


@pytest.mark.parametrize("fused", [None, False, True])
def test_apply_grouped_matches_jax(flagship, fused):
    """fused=None and False run the eager chain on the CPU (as JAX runs XLA
    off-TPU); fused=True runs K1's plain version, held against the Pallas
    kernel in interpret mode."""
    jm, params, tm = flagship
    t, x = _inputs(2, 256)
    with torch.no_grad():
        out = tm.apply_grouped(t, x, fused=fused)
    if fused:
        ref = jax_fused(jm.p_to_w(params, t), x, jm.cfg_shape_net, "siren", True)
    else:
        ref = jm.apply_grouped(params, t, x, fused=False)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 256, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_apply_grouped_is_differentiable_on_the_eager_path(flagship):
    _, _, tm = flagship
    t, x = _inputs(2, 16)
    out = tm.apply_grouped(t, x)
    out.sum().backward()
    g = tm.pnet.params["last"]["w"].grad
    assert g is not None and bool(torch.isfinite(g).all())
    tm.zero_grad(set_to_none=True)


def test_predict_grouped_matches_jax(flagship):
    jm, params, tm = flagship
    t, x = _inputs(2, 256, seed=1)
    out = predict_grouped(tm, t, x)
    ref = jax_predict_grouped(jm, params, t, x)
    assert out.dtype == np.float32 and out.shape == (2, 256, 1)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_predict_grouped_pads_and_chunks_like_jax(flagship):
    """Ragged P (100 -> padded to 128) and G=5 in chunks of 2 (the last one
    padded): the pads are stripped and the values match the unpadded call."""
    jm, params, tm = flagship
    t, x = _inputs(5, 100, seed=2)
    out = predict_grouped(tm, t, x, group_batch=2, point_pad=128)
    ref = jax_predict_grouped(jm, params, t, x, group_batch=2, point_pad=128)
    assert out.shape == ref.shape == (5, 100, 1)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        direct = tm.apply_grouped(t, x).numpy()
    np.testing.assert_allclose(out, direct, rtol=1e-6, atol=1e-7)


def test_predict_grouped_empty_and_mismatched(flagship):
    _, _, tm = flagship
    out = predict_grouped(tm, np.zeros((0, 4)), np.zeros((0, 50, 3)))
    assert out.shape == (0, 50, 1) and out.dtype == np.float32
    with pytest.raises(ValueError, match="groups"):
        predict_grouped(tm, np.zeros((2, 4)), np.zeros((3, 8, 3)))


def test_predict_pointwise_matches_jax(flagship):
    jm, params, tm = flagship
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.standard_normal((37, 4)), rng.uniform(-1, 1, (37, 3))],
                          axis=1).astype(np.float32)
    out = predict(tm, rows, batch_size=16)
    ref = jax_predict(jm, params, rows, batch_size=16)
    assert out.shape == (37, 1)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        u, lat = tm.apply(rows, return_latent=True)
    np.testing.assert_allclose(u.numpy(), out, rtol=1e-6, atol=1e-7)
    assert tuple(lat.shape) == (37, 128)
    empty = predict(tm, np.zeros((0, 7), np.float32))
    assert empty.shape == (0, 1) and empty.dtype == np.float32


def test_subnetworks_match_jax(flagship):
    jm, params, tm = flagship
    t, x = _inputs(2, 32, seed=4)
    with torch.no_grad():
        wb = tm.p_to_w(t)
        np.testing.assert_allclose(wb.numpy(), np.asarray(jm.p_to_w(params, t)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tm.x_to_u_given_w_grouped(x, wb).numpy(),
            np.asarray(jm.x_to_u_given_w_grouped(x, np.asarray(wb))), rtol=RTOL, atol=ATOL)
        wb_rows = np.repeat(wb.numpy(), 32, axis=0)
        np.testing.assert_allclose(
            tm.x_to_u_given_w(x.reshape(-1, 3), wb_rows).numpy(),
            np.asarray(jm.x_to_u_given_w(x.reshape(-1, 3), wb_rows)), rtol=RTOL, atol=ATOL)


def test_bf16_policy_matches_jax(flagship):
    """mixed_bfloat16. The ParameterNet's bf16 output agrees to a few bf16
    ulps (the two frameworks round its swish layers at different points).
    From the same bf16 weight vector, K1's plain version and the Pallas
    kernel in interpret mode agree to 2 bf16 ulps of max|u|: both lift the
    activations to bf16 before each matmul and round the output to bf16."""
    _, params, _ = flagship
    jb = nif_tpu.NIFMultiScale(CFG_S, CFG_P, mixed_policy="mixed_bfloat16")
    tb = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, mixed_policy="mixed_bfloat16",
                                     device="cpu")
    from_jax_params(tb, jax.tree_util.tree_map(np.asarray, params))
    t, x = _inputs(2, 256, seed=5)
    wb_j = np.asarray(jb.p_to_w(params, t), np.float32)
    with torch.no_grad():
        wb_t = tb.p_to_w(t).float().numpy()
        assert np.abs(wb_t - wb_j).max() <= 4 * 2.0 ** -8 * np.abs(wb_j).max()
        wb = torch.from_numpy(wb_j).to(torch.bfloat16)
        out = tb.x_to_u_given_w_grouped(x, wb)  # eager, as a shape/dtype check
        assert out.dtype == torch.float32 and tuple(out.shape) == (2, 256, 1)
        from nif_tpu_torch.ops import shapenet_grouped_fused
        mine = shapenet_grouped_fused(wb, tb._compute(x), tb.cfg_shape_net, "siren")
    ref = jax_fused(jax.numpy.asarray(wb_j, jax.numpy.bfloat16),
                    jax.numpy.asarray(x, jax.numpy.bfloat16), jb.cfg_shape_net, "siren", True)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    assert np.abs(mine.float().numpy() - ref).max() <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_fast_path_info_and_routing(flagship, caplog):
    jm, _, tm = flagship
    info = tm.fast_path_info(256)
    assert info == {"path": "eager", "tile": None, "reason": "not on CUDA (device 'cpu')"}
    bad = tm.fast_path_info(257)
    assert bad["path"] == "eager"
    assert bad["reason"] == jm.fast_path_info(257)["reason"]
    tm._announced_paths.clear()
    with caplog.at_level("WARNING", logger="nif_tpu_torch"):
        with torch.no_grad():
            tm.apply_grouped(*_inputs(1, 257))
    assert "FALLING BACK to eager for P=257" in caplog.text
    f64 = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, mixed_policy="float64", device="cpu")
    assert "float64" in f64.fast_path_info(256)["reason"]


def test_fused_cuda_routing_refuses_gradients(flagship, monkeypatch):
    """Auto routing that picks K1 (forced here, as on a card) no longer
    refuses gradients: the backward reaches K3's path (plain K3 on the
    CPU, the kernel on a card) and agrees with eager autograd in f32."""
    from nif_tpu_torch.ops import fused_shapenet as fs

    _, _, tm = flagship
    fused = {"path": "fused", "tile": 64, "reason": None}
    monkeypatch.setattr(tm, "fast_path_info", lambda P: fused)
    monkeypatch.setattr(tm, "_announce_path", lambda P: None)
    calls = []
    real_bwd = fs.shapenet_fused_bwd_reference
    monkeypatch.setattr(fs, "shapenet_fused_bwd_reference",
                        lambda *a: calls.append(1) or real_bwd(*a))
    t, x = _inputs(1, 64)
    params = [p for _, p in tm.param_items()]
    out = tm.apply_grouped(t, x)
    assert out.requires_grad and tuple(out.shape) == (1, 64, 1)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 64, 1)).astype(np.float32))
    fused_grads = torch.autograd.grad(out, params, g)
    assert calls == [1]
    eager_grads = torch.autograd.grad(tm.apply_grouped(t, x, fused=False), params, g)
    assert calls == [1]
    for a, b in zip(fused_grads, eager_grads):
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=5e-5)
    with torch.inference_mode():
        assert tuple(tm.apply_grouped(t, x).shape) == (1, 64, 1)
    assert calls == [1]


def test_flagship_is_the_smoke_scripts_model():
    from nif_tpu_torch.utils import bench

    assert bench.FLAGSHIP_SHAPE == CFG_S and bench.FLAGSHIP_PNET == CFG_P
    assert bench.FLAGSHIP_POLICY == "mixed_bfloat16"


def test_cpu_serving_launches_no_kernel(flagship):
    _, _, tm = flagship
    before = _build.LAUNCHES["shapenet_fwd"]
    predict_grouped(tm, *_inputs(2, 64))
    assert _build.LAUNCHES["shapenet_fwd"] == before


def test_vanilla_nif_matches_jax():
    cfg_s = {"input_dim": 2, "output_dim": 2, "units": 32, "nlayers": 2,
             "activation": "swish", "use_resblock": True}
    cfg_p = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
             "activation": "tanh"}
    jm = nif_tpu.NIF(cfg_s, cfg_p)
    params = jm.init(jax.random.key(1))
    tm = nif_tpu_torch.NIF(cfg_s, cfg_p, device="cpu")
    assert not tm.cfg_shape_net.use_resblock and tm.po_dim == jm.po_dim
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(6)
    t = rng.standard_normal((2, 1)).astype(np.float32)
    x = rng.standard_normal((2, 64, 2)).astype(np.float32)
    with torch.no_grad():
        for fused in (False, True):
            np.testing.assert_allclose(
                tm.apply_grouped(t, x, fused=fused).numpy(),
                np.asarray(jm.apply_grouped(params, t, x, fused=fused)),
                rtol=RTOL, atol=ATOL)


def test_config_io_across_packages(flagship, tmp_path):
    jm, _, tm = flagship
    tm.save_config(str(tmp_path / "torch.json"))
    jm.save_config(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "torch.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    back = nif_tpu_torch.NIFMultiScale.from_config(str(tmp_path / "jax.json"), device="cpu")
    assert back.cfg_shape_net == tm.cfg_shape_net and back.mixed_policy == "float32"
    assert nif_tpu.NIFMultiScale.from_config(str(tmp_path / "torch.json")).po_dim == 33665


def test_construction_validation():
    with pytest.raises(ValueError, match="connectivity"):
        nif_tpu_torch.NIFMultiScale({**CFG_S, "connectivity": "nope"}, CFG_P, device="cpu")
    with pytest.raises(ValueError, match="NIFMultiScaleLastLayerParameterized"):
        nif_tpu_torch.NIFMultiScale({**CFG_S, "connectivity": "last_layer"}, CFG_P,
                                    device="cpu")
    with pytest.raises(ValueError, match="mixed_policy"):
        nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, mixed_policy="fp8", device="cpu")


def test_convert_round_trip_and_errors(flagship):
    _, params, tm = flagship
    tree = jax.tree_util.tree_map(np.asarray, params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, to_numpy_params(tm), tree)
    with pytest.raises(KeyError):
        from_jax_params(tm, {"pnet": {k: v for k, v in tree["pnet"].items() if k != "last"}})
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["pnet"]["first"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tm, bad)
