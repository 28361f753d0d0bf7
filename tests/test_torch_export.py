"""The port's ``export_apply``/``load_exported`` (``torch.export``) and K1's
registered op on the CPU, against the JAX package's StableHLO artifacts.

Each of the four layouts round-trips through bytes and through a path and
equals the direct call bit for bit (the exported graph runs the same ATen
ops); the port's artifact matches JAX's artifact on the same parameters and
inputs to 1e-5 (float32: the two frameworks' sine, tanh and sums differ in
the last bits; the int8 decode shares its integer sums and rounds
``a(t)``'s scale one float32 product apart). K1's op passes
``torch.library.opcheck`` and is what an exported fused forward records.
"""
import jax
import numpy as np
import pytest
import torch

import nif_tpu
from nif_tpu.compression import quantize_shared_mesh as jax_quantize_shared_mesh
from nif_tpu.serving import export_apply as jax_export_apply
from nif_tpu.serving import load_exported as jax_load_exported
import nif_tpu_torch
from nif_tpu_torch.compression import quantize_shared_mesh, rom_decode_int8
from nif_tpu_torch.config import ShapeNetConfig, shapenet_param_count
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.ops import fused_shapenet as fs
from nif_tpu_torch.serving import export_apply, load_exported, predict_shared_mesh

torch.set_num_threads(1)

MS_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1, "activation": "sine",
        "use_resblock": False, "omega_0": 10.0}
MS_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1, "activation": "swish",
        "use_resblock": False, "omega_0": 10.0}
LIN_S = {**MS_S, "output_dim": 2, "connectivity": "last_layer", "weight_init_factor": 0.1}
G, P = 3, 40


def _pair(cls, cfg_s, seed):
    jm = getattr(nif_tpu, cls)(cfg_s, MS_P)
    params = jm.init(jax.random.key(seed))
    tm = getattr(nif_tpu_torch, cls)(cfg_s, MS_P, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def grouped_pair():
    return _pair("NIFMultiScale", MS_S, 0)


@pytest.fixture(scope="module")
def linear_pair():
    return _pair("NIFMultiScaleLastLayerParameterized", LIN_S, 1)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, 1)).astype(np.float32),
            rng.uniform(-1, 1, (G, P, 2)).astype(np.float32),
            rng.uniform(-1, 1, (P, 2)).astype(np.float32))


def _cases(grouped_pair, linear_pair):
    """``(jax model, params, port model, layout, export kwargs, inputs,
    direct port call)`` for each layout."""
    t, x, xm = _inputs()
    rows = np.concatenate([np.repeat(t, P, axis=0), x.reshape(-1, 2)], axis=1)[:2 * P]
    (jg, pg, tg), (jl, pl, tl) = grouped_pair, linear_pair
    pack = quantize_shared_mesh(tl, xm)
    return [
        (jg, pg, tg, "pointwise", dict(batch_size=2 * P), (rows,), lambda: tg.apply(rows)),
        (jg, pg, tg, "grouped", dict(batch_size=P, group_batch=G), (t, x),
         lambda: tg.apply_grouped(t, x)),
        (jl, pl, tl, "shared_mesh", dict(batch_size=P, group_batch=G), (t, xm),
         lambda: tl.apply_shared_mesh(t, xm)),
        (jl, pl, tl, "shared_mesh_int8", dict(batch_size=P, group_batch=G, int8_pack=pack),
         (t,), lambda: rom_decode_int8(tl, pack, t)),
    ]


@pytest.mark.parametrize("layout", ["pointwise", "grouped", "shared_mesh", "shared_mesh_int8"])
def test_every_layout_round_trips_and_equals_the_direct_call(grouped_pair, linear_pair,
                                                             layout, tmp_path):
    case = next(c for c in _cases(grouped_pair, linear_pair) if c[3] == layout)
    _, _, tm, _, kw, inputs, direct = case
    path = tmp_path / "sub" / f"{layout}.pt2"
    blob = export_apply(tm, layout=layout, path=str(path), **kw)
    assert isinstance(blob, bytes) and path.read_bytes() == blob
    with torch.no_grad():
        want = direct()
    for loaded in (load_exported(blob), load_exported(str(path))):
        assert loaded.in_avals == tuple((a.shape, torch.float32) for a in inputs)
        out = loaded(*inputs)
        assert out.dtype == want.dtype and torch.equal(out, want)
        # tensors are taken as they are, numpy arrays cast to float32
        assert torch.equal(loaded(*(torch.from_numpy(a) for a in inputs)), want)


@pytest.mark.parametrize("layout", ["pointwise", "grouped", "shared_mesh", "shared_mesh_int8"])
def test_artifact_matches_the_jax_artifact(grouped_pair, linear_pair, layout):
    case = next(c for c in _cases(grouped_pair, linear_pair) if c[3] == layout)
    jm, params, tm, _, kw, inputs, _ = case
    jkw = dict(kw)
    if layout == "shared_mesh_int8":  # one pack for both: JAX's, crossed as numpy
        jkw["int8_pack"] = jax_quantize_shared_mesh(jm, params, _inputs()[2])
        kw = dict(kw, int8_pack={k: (v if k == "shape" else np.asarray(v))
                                 for k, v in jkw["int8_pack"].items()})
    ref = np.asarray(jax_load_exported(jax_export_apply(jm, params, layout=layout, **jkw))(
        *inputs))
    out = load_exported(export_apply(tm, layout=layout, **kw))(*inputs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_export_refusals(grouped_pair, linear_pair):
    _, _, tg = grouped_pair
    _, _, tl = linear_pair
    with pytest.raises(ValueError, match="layout"):
        export_apply(tg, batch_size=P, layout="bogus")
    with pytest.raises(ValueError, match="int8_pack"):
        export_apply(tl, batch_size=P, layout="shared_mesh_int8")
    with pytest.raises(TypeError, match="apply_shared_mesh"):
        export_apply(tg, batch_size=P, layout="shared_mesh")


def test_predict_shared_mesh_int8_pack_chunks_and_checks_the_mesh(linear_pair):
    """tests/test_serving.py:162-197 in the port: chunks of group_batch (the
    last one padded) equal the whole decode; x may be omitted; a mesh of
    another size is refused, naming int8_pack; against the float32 decode
    within 0.05 of max."""
    _, _, tl = linear_pair
    rng = np.random.default_rng(4)
    t = rng.standard_normal((5, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (96, 2)).astype(np.float32)
    pack = quantize_shared_mesh(tl, x)
    i8 = predict_shared_mesh(tl, t, int8_pack=pack, group_batch=2)
    assert i8.dtype == np.float32 and i8.shape == (5, 96, 2)
    np.testing.assert_array_equal(i8, rom_decode_int8(tl, pack, t).numpy())
    np.testing.assert_array_equal(predict_shared_mesh(tl, t, x, int8_pack=pack), i8)
    f32 = predict_shared_mesh(tl, t, x, group_batch=2)
    assert np.max(np.abs(i8 - f32)) / max(np.max(np.abs(f32)), 1e-6) < 0.05
    with pytest.raises(ValueError, match="int8_pack"):
        predict_shared_mesh(tl, t, x[:48], int8_pack=pack)
    assert predict_shared_mesh(tl, t[:0], int8_pack=pack).shape == (0, 96, 2)


# ------------------------------------------------------ K1's registered op
OP_CASES = [("siren", (2, 3, 16, 2, "sine", False, 30.0)),
            ("siren", (3, 1, 16, 1, "sine", True, 10.0)),
            ("vanilla", (2, 2, 16, 2, "swish", False, 30.0))]


def _op_args(variant, args, dtype, seed=0):
    cfg = ShapeNetConfig(*args)
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((2, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((2, 24, cfg.input_dim))
    return cfg, torch.from_numpy(wb).to(dtype), torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,args", OP_CASES, ids=["siren", "resblock", "vanilla"])
def test_k1_op_passes_opcheck_and_is_plain_k1_on_the_cpu(variant, args, dtype):
    cfg, wb, x = _op_args(variant, args, dtype)
    op_args = (wb, x, *fs._cfg_fields(cfg), variant)
    torch.library.opcheck(torch.ops.nif_tpu_torch.shapenet_fwd.default, op_args)
    out = torch.ops.nif_tpu_torch.shapenet_fwd(*op_args)
    assert torch.equal(out, fs.shapenet_grouped_fused_reference(wb, x, cfg, variant))
    assert torch.equal(fs.shapenet_grouped_fused(wb, x, cfg, variant), out)


def test_exported_fused_forward_records_the_op_and_reloads():
    """An exported K1 forward is one call of the registered op, which a
    loaded artifact runs (its CPU kernel here, K1 on the card); autograd
    through K1 + K3 still runs around it."""
    cfg, wb, x = _op_args("siren", OP_CASES[0][1], torch.float32)

    class Fused(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wb = torch.nn.Parameter(wb.clone())

        def forward(self, xx):
            return fs.shapenet_grouped_fused(self.wb, xx, cfg, "siren")

    import io

    with torch.no_grad():
        program = torch.export.export(Fused(), (x,))
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops == [torch.ops.nif_tpu_torch.shapenet_fwd.default]
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = load_exported(buf.getvalue())
    assert torch.equal(loaded(x), fs.shapenet_grouped_fused_reference(wb, x, cfg))
    w = wb.clone().requires_grad_()
    fs.shapenet_grouped_fused(w, x, cfg).square().sum().backward()
    d_wb, _ = fs.shapenet_fused_bwd_reference(wb, x, 2 * fs.shapenet_grouped_fused_reference(
        wb, x, cfg), cfg, "siren")
    torch.testing.assert_close(w.grad, d_wb, rtol=0, atol=0)
