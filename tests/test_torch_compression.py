"""The port's ``compression`` against the JAX package on the CPU: magnitude
pruning (masks, ``sparsity``, the ``MagnitudePruning`` schedule over SGD and
over Adam, a checkpoint round trip mid-ramp), int8 post-training
quantization, ``quantize_shared_mesh`` and the int8 ROM decode.

The JAX models draw the parameters; they cross to the port as numpy arrays
(``from_jax_params``), and both packages get the same numpy inputs.
Tolerances:

* masks, ``q`` and per-channel and per-tensor scales: exact (the same
  float32 comparisons and divisions; the pruning schedule and kept count in
  float32 as XLA:CPU compiles the jitted update); SGD params within 1e-6 (the projection is
  ``p * m`` here, ``p + ((p + u) * m - p)`` in JAX: one rounding apart).
* Over Adam (30 steps): the kept counts exactly, the masks within 1% of the
  entries: ``torch.optim.Adam``'s float64 bias corrections sit 1.3e-5 from
  optax's float32 ones, and a weight at the threshold can cross it.
* ``quantize_shared_mesh``: ``phi(x)`` comes from torch's sine, not XLA's,
  so ``s_phi`` within rel 1e-6 and ``q_phi`` at most one unit off in at
  most 0.1% of the entries (a row value on a rounding boundary).
* ``rom_decode_int8`` on JAX's own pack: rel 1e-6 (the same int32 sums, the
  ParameterNet's f32 products one rounding apart); against the float32
  decode rel-L2 1e-2 (the JAX test's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu import compression as jc
import nif_tpu_torch
from nif_tpu_torch import compression as tc
from nif_tpu_torch import optimizers as topt
from nif_tpu_torch.compression import quantization as tq
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.training import CheckpointCallback, GroupedTrainer

torch.set_num_threads(1)

CFG_S = {"input_dim": 1, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "tanh"}
CFG_P = {"input_dim": 1, "latent_dim": 2, "units": 16, "nlayers": 2, "activation": "tanh"}
LIN_S = {"input_dim": 1, "output_dim": 2, "units": 16, "nlayers": 1, "activation": "sine",
         "use_resblock": False, "omega_0": 30.0, "connectivity": "last_layer",
         "weight_init_factor": 0.1}
LIN_P = {"input_dim": 1, "latent_dim": 8, "units": 16, "nlayers": 1, "activation": "swish",
         "use_resblock": False, "omega_0": 30.0}


def _nif(seed=0):
    jm = nif_tpu.NIF(CFG_S, CFG_P)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIF(CFG_S, CFG_P, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _linear(seed=0, policy="float32"):
    jm = nif_tpu.NIFMultiScaleLastLayerParameterized(LIN_S, LIN_P, mixed_policy=policy)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(LIN_S, LIN_P, mixed_policy=policy,
                                                           device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _pairs(jtree, ttree):
    """The matching leaves of a JAX tree and a port tree, as numpy arrays."""
    jl, jdef = jax.tree_util.tree_flatten(jtree)
    tl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: a.numpy() if isinstance(a, torch.Tensor) else a, ttree))
    assert len(jl) == len(tl)
    return list(zip(map(np.asarray, jl), tl))


def _path_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------- pruning
@pytest.mark.parametrize("target", [0.5, 0.8, 1.0])
def test_prune_by_magnitude_apply_mask_and_sparsity_equal_jax(target):
    _, params, tm = _nif()
    jmask = jc.prune_by_magnitude(params, target)
    tmask = tc.prune_by_magnitude(tm.param_tree(), target)
    for a, b in _pairs(jmask, tmask):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jp = jc.apply_mask(params, jmask)
    tp = tc.apply_mask(tm.param_tree(), tmask)
    for a, b in _pairs(jp, tp):
        np.testing.assert_array_equal(a, b)
    assert tc.sparsity(tp) == jc.sparsity(jp)
    assert tc.sparsity(tp, prunable_only=False) == jc.sparsity(jp, prunable_only=False)
    # a plain nested dict of tensors works as the model's tree does
    plain = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    for a, b in _pairs(jmask, tc.prune_by_magnitude(plain, target)):
        assert np.array_equal(a, b)
    # the pruned tree loads into a model, which still runs
    from_jax_params(tm, tp)
    assert torch.isfinite(tm.apply(np.ones((5, 2), np.float32))).all()


def test_magnitude_pruning_over_sgd_equals_jax_step_for_step():
    """tests/test_compression.py:107-132's scenario: the mask recomputes at
    steps 1 and 4 and is held in between and after end_step."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    tx = jc.MagnitudePruning(optax.sgd(0.1), final_sparsity=0.5, begin_step=0, end_step=4,
                             update_every=4)
    jp = {"w": jnp.asarray(w0)}
    st = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = tc.MagnitudePruning(lambda ps: torch.optim.SGD(ps, lr=0.1), final_sparsity=0.5,
                              begin_step=0, end_step=4, update_every=4)([w])
    jstep = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for _ in range(6):
        g = np.full((8, 8), 0.05, np.float32)
        u, st = jstep({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, u)
        w.grad = torch.from_numpy(g)
        opt.step()
        assert np.array_equal(opt.masks[0].numpy(), np.asarray(st.mask["w"]))
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-6)
    assert opt.prune_step == int(st.step) == 6
    assert tc.sparsity({"w": w}) == jc.sparsity(jp) >= 0.4


RAMPS = [(0.7, 3, 40, [(7, 143), (64, 64)]), (0.5, 0, 20, [(16, 16), (33, 7)]),
         (0.9, 5, 200, [(128, 263), (3, 5), (5, 7), (11, 3)])]


@pytest.mark.parametrize("final,begin,end,shapes", RAMPS, ids=[str(r[:3]) for r in RAMPS])
def test_magnitude_pruning_masks_equal_jax_at_every_step_of_a_ramp(final, begin, end, shapes):
    """The kept count at every step of a ramp (recomputed each step, the
    parameters held), mask for mask against the JAX transform under jit:
    XLA:CPU multiplies by the window's reciprocal and fuses each
    product-and-subtract (at the 15-entry tensor's step 135 the unfused
    float32 chain keeps 1 entry where JAX keeps 2)."""
    rng = np.random.default_rng(0)
    p0 = {f"w{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}
    tx = jc.MagnitudePruning(optax.sgd(0.0), final, begin, end, update_every=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)

    @jax.jit
    def jstep(p, s):
        u, s = tx.update(jax.tree_util.tree_map(jnp.zeros_like, p), s, p)
        return optax.apply_updates(p, u), s

    ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in p0.values()]
    opt = tc.MagnitudePruning(lambda q: torch.optim.SGD(q, lr=0.0), final, begin, end,
                              update_every=1)(ps)
    for _ in range(end + 3):
        jp, st = jstep(jp, st)
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt.step()
        for m, k in zip(opt.masks, p0):
            assert np.array_equal(m.numpy(), np.asarray(st.mask[k])), (opt.prune_step, k)


def test_magnitude_pruning_over_adam_fit_matches_jax():
    """A 30-step fit of the tiny NIF (tests/test_compression.py:48-67): the
    kept counts equal JAX's exactly, the masks within 1% of the entries."""
    jm, params, tm = _nif()
    rng = np.random.default_rng(1)
    inputs = rng.standard_normal((64, 2)).astype(np.float32)
    tx = jc.MagnitudePruning(optax.adam(1e-3), final_sparsity=0.5, begin_step=0, end_step=20)
    st = tx.init(params)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda q: jnp.mean(jm.apply(q, jnp.asarray(inputs)) ** 2))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for _ in range(30):
        params, st = jstep(params, st)
    opt = tc.MagnitudePruning(topt.adam(1e-3), final_sparsity=0.5, begin_step=0,
                              end_step=20)([p for _, p in tm.param_items()])
    x = torch.from_numpy(inputs)
    for _ in range(30):
        opt.zero_grad()
        torch.mean(tm.apply(x) ** 2).backward()
        opt.step()
    differ = total = 0
    for (path, p), m in zip(tm.param_items(), opt.masks):
        jmask = np.asarray(_path_get(st.mask, path))
        if m is None:
            assert p.dim() < 2
            continue
        assert int(m.sum()) == int(jmask.sum())
        differ += int((m.numpy() != jmask).sum())
        total += m.numel()
    assert differ <= 0.01 * total
    assert tc.sparsity(tm.param_tree()) == pytest.approx(jc.sparsity(params), abs=0.01)
    assert tc.sparsity(tm.param_tree()) >= 0.45


def _wave(G=4, P=32, seed=8):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    return t, x, np.sin(np.pi * x + t[:, None]).astype(np.float32)


def test_pruning_state_resumes_from_a_checkpoint_mid_ramp(tmp_path):
    """The masks and the pruning count live in the optimizer's state dict:
    ``init_or_restore`` at step 6 of a 10-step ramp continues to the
    uninterrupted run's masks and parameters, bit for bit."""
    t, x, u = _wave()
    make = tc.MagnitudePruning(topt.adam(1e-2), final_sparsity=0.6, begin_step=0, end_step=10,
                               update_every=2)

    def trainer():
        return GroupedTrainer(nif_tpu_torch.NIF(CFG_S, CFG_P, device="cpu"), make)

    kw = dict(group_batch=2, point_batch=16)
    whole = trainer()
    ws = whole.fit_resident(whole.init(0), t, x, u, epochs=3, seed=0, **kw)
    ws = whole.fit_resident(ws, t, x, u, epochs=3, seed=1, **kw)
    first = trainer()
    ckpt = str(tmp_path / "ckpt")
    first.fit_resident(first.init(0), t, x, u, epochs=3, seed=0,
                       callbacks=[CheckpointCallback(ckpt, every=1)], **kw)
    second = trainer()
    rs = second.init_or_restore(7, ckpt)
    assert rs.step == 6 and rs.opt_state.prune_step == 6
    assert 0 < tc.sparsity(second.model.param_tree()) < 0.6
    rs = second.fit_resident(rs, t, x, u, epochs=3, seed=1, **kw)
    assert rs.opt_state.prune_step == ws.opt_state.prune_step == 12
    for a, b in zip(rs.opt_state.masks, ws.opt_state.masks):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(second.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    assert tc.sparsity(whole.model.param_tree()) >= 0.59


# ---------------------------------------------------------- quantization
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_params_equals_jax(per_channel):
    _, params, tm = _nif()
    jq = jc.quantize_params(params, per_channel=per_channel)
    tq_ = tc.quantize_params(tm.param_tree(), per_channel=per_channel)
    pairs = _pairs(jq, tq_)
    assert any(a.dtype == np.int8 for a, _ in pairs)
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8) if a.dtype == np.int8 else a.view(np.uint32),
                              b.view(np.uint8) if b.dtype == np.int8 else b.view(np.uint32))
    assert tc.quantized_size_bytes(tq_) == jc.quantized_size_bytes(jq)
    for a, b in _pairs(jc.dequantize_params(jq), tc.dequantize_params(tq_)):
        np.testing.assert_array_equal(a, b)


def test_quantize_shared_mesh_matches_jax_float32():
    jm, params, tm = _linear()
    x = np.random.default_rng(0).uniform(-1, 1, (96, 1)).astype(np.float32)
    jpack = jc.quantize_shared_mesh(jm, params, jnp.asarray(x))
    pack = tc.quantize_shared_mesh(tm, x)
    assert pack["shape"] == tuple(jpack["shape"]) == (96, 2, 8)
    assert pack["q_phi"].dtype == torch.int8 and pack["q_phi"].shape == (192, 8)
    np.testing.assert_allclose(pack["s_phi"].numpy(), np.asarray(jpack["s_phi"]), rtol=1e-6)
    dq = pack["q_phi"].numpy().astype(np.int32) - np.asarray(jpack["q_phi"]).astype(np.int32)
    assert np.abs(dq).max() <= 1 and np.count_nonzero(dq) <= 1e-3 * dq.size
    np.testing.assert_array_equal(pack["bias"].numpy(), np.asarray(params["snet"]["bias"]))
    # 192 x 8 already meets torch._int_mm's rules: no padded copy
    assert pack["q_phi_padded"] is pack["q_phi"]


def test_rom_decode_int8_on_jax_pack_equals_jax_and_tracks_float32():
    """tests/test_compression.py:135-170's shape (G=6, K=8): fed JAX's pack
    (numpy), the decode equals JAX's within rel 1e-6; the port's own pack
    decodes within rel-L2 1e-2 of apply_shared_mesh."""
    jm, params, tm = _linear()
    rng = np.random.default_rng(0)
    t = rng.standard_normal((6, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (96, 1)).astype(np.float32)
    jpack = jc.quantize_shared_mesh(jm, params, jnp.asarray(x))
    ref = np.asarray(jc.rom_decode_int8(jm, params, jpack, jnp.asarray(t)))
    np_pack = {k: (v if k == "shape" else np.asarray(v)) for k, v in jpack.items()}
    mine = tc.rom_decode_int8(tm, np_pack, t)
    assert mine.dtype == torch.float32 and mine.shape == (6, 96, 2)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    with torch.no_grad():
        uf = tm.apply_shared_mesh(t, x).double()
        u8 = tc.rom_decode_int8(tm, tc.quantize_shared_mesh(tm, x), t).double()
    assert float(torch.linalg.norm(u8 - uf) / torch.linalg.norm(uf)) < 1e-2


@pytest.mark.parametrize("G,P,so,K", [(6, 97, 1, 8), (5, 33, 3, 5), (20, 8, 1, 16)])
def test_int8_product_pads_to_int_mm_rules_and_is_exact(G, P, so, K):
    """The padded operands meet torch._int_mm's CUDA rules (> 16 rows,
    inner and outer sizes multiples of 8) and the stripped result is the
    exact integer product."""
    rng = np.random.default_rng(G + P)
    q_a = torch.from_numpy(rng.integers(-127, 128, (G, K)).astype(np.int8))
    q_phi = torch.from_numpy(rng.integers(-127, 128, (P * so, K)).astype(np.int8))
    padded = tq._mm_operand(q_phi)
    assert padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    assert torch.equal(padded[:P * so, :K], q_phi) and not padded[P * so:].any()
    acc = tq._int8_product(q_a, padded, P * so)
    assert acc.dtype == torch.int32 and acc.shape == (G, P * so)
    exact = q_a.numpy().astype(np.int64) @ q_phi.numpy().astype(np.int64).T
    np.testing.assert_array_equal(acc.numpy(), exact)


def test_rom_decode_int8_bf16_policy_runs_the_parameter_net_in_float32():
    """Under mixed_bfloat16, a(t) comes from the float32 parameters in
    float32 (the JAX decode's), so the same pack decodes as JAX's does."""
    jm, params, tm = _linear(policy="mixed_bfloat16")
    rng = np.random.default_rng(2)
    t = rng.standard_normal((20, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (40, 1)).astype(np.float32)
    jpack = jc.quantize_shared_mesh(jm, params, jnp.asarray(x))
    np_pack = {k: (v if k == "shape" else np.asarray(v)) for k, v in jpack.items()}
    ref = np.asarray(jc.rom_decode_int8(jm, params, jpack, jnp.asarray(t)))
    mine = tc.rom_decode_int8(tm, np_pack, t)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_rom_decode_int8_error_at_the_flagship_width_is_the_jax_packages():
    """At the NIF-linear flagship's width (K=128, random weights), int8
    rounding costs each package the same rel-L2 against the float32 decode
    (equal within 1% between the packages). It is near the JAX test's 1e-2
    bound, set at K=8, and can exceed it (scripts/int8_decode_error.py:
    0.85-1.22e-2 in both packages over three seeds)."""
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, LINEAR_SHAPE

    jm = nif_tpu.NIFMultiScaleLastLayerParameterized(LINEAR_SHAPE, FLAGSHIP_PNET)
    params = jm.init(jax.random.key(0))
    tm = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(LINEAR_SHAPE, FLAGSHIP_PNET,
                                                           device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7)
    t = rng.standard_normal((20, 4)).astype(np.float32)
    x = rng.standard_normal((512, 3)).astype(np.float32)
    jpack = jc.quantize_shared_mesh(jm, params, jnp.asarray(x))
    ju8 = np.asarray(jc.rom_decode_int8(jm, params, jpack, jnp.asarray(t)), np.float64)
    juf = np.asarray(jm.apply_shared_mesh(params, jnp.asarray(t), jnp.asarray(x)), np.float64)
    j_rel = np.linalg.norm(ju8 - juf) / np.linalg.norm(juf)
    with torch.no_grad():
        u8 = tc.rom_decode_int8(tm, tc.quantize_shared_mesh(tm, x), t).double()
        uf = tm.apply_shared_mesh(t, x).double()
    rel = float(torch.linalg.norm(u8 - uf) / torch.linalg.norm(uf))
    assert 5e-3 < rel < 2e-2
    assert rel == pytest.approx(j_rel, rel=1e-2)
