"""The port's device-resident training, residual point sampling and resumable
init against the JAX package on the CPU: ``GroupedTrainer.fit_resident``
(full-batch runs, where neither package samples, step for step against the
JAX scan), ``fit(point_sampling="residual")``, ``residual_probs`` and
``_gumbel_topk``, the chunking of ``fit_resident`` around callbacks,
validation and refreshes, the resident sampler's statistics, and
``init_or_restore`` on both trainers.

The JAX model draws the parameters; they cross to the port as numpy arrays
(``from_jax_params``). Tolerances (float32): per-epoch losses rtol 1e-4 and
parameters normalized by each leaf's largest entry atol 1e-4 over a few
epochs of Adam (``test_grouped_fit_matches_jax``'s), residual
probabilities atol 1e-5. Sampled resident runs draw from the port's own
``torch.Generator``, not from ``jax.random``, so they are held to the JAX
package's convergence and to statistics, not to its batches.
"""
import numpy as np
import jax
import optax
import pytest
import torch
from scipy.stats import chi2

import nif_tpu
from nif_tpu.training import CheckpointCallback as JaxCheckpointCallback
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
from nif_tpu.training import Trainer as JaxTrainer
import nif_tpu_torch
from nif_tpu_torch.convert import from_jax_params, to_numpy_params
from nif_tpu_torch.training import (
    FINAL_MARKER_OFFSET,
    CheckpointCallback,
    Checkpointer,
    GroupedTrainer,
    LearningRateScheduler,
    Trainer,
)
from nif_tpu_torch.training.resident import (ResidentData, ResidentLoop, _hyperparameters,
                                             graph_form)

torch.set_num_threads(1)

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2,
         "activation": "sine", "use_resblock": False, "omega_0": 10.0,
         "connectivity": "full", "weight_init_factor": 0.1}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0}
# fit_resident's convergence tests (tests/test_training.py:172-263)
CFG_S1 = {"input_dim": 1, "output_dim": 1, "units": 16, "nlayers": 1,
          "activation": "sine", "use_resblock": False, "omega_0": 30.0,
          "connectivity": "full", "weight_init_factor": 0.1}
CFG_P1 = {"input_dim": 1, "latent_dim": 2, "units": 16, "nlayers": 1,
          "activation": "swish", "use_resblock": False, "omega_0": 30.0}


def _adam(lr):
    return lambda p: torch.optim.Adam(p, lr=lr)


def _pair(cfg_s=CFG_S, cfg_p=CFG_P, lr=1e-3, seed=3, **kw):
    """A JAX trainer and a port trainer over the same parameters."""
    jm = nif_tpu.NIFMultiScale(cfg_s, cfg_p)
    jt = JaxGroupedTrainer(jm, optax.adam(lr), seed=seed, **kw)
    js = jt.init(jax.random.key(1))
    tm = nif_tpu_torch.NIFMultiScale(cfg_s, cfg_p, device="cpu")
    tt = GroupedTrainer(tm, _adam(lr), seed=seed, **kw)
    ts = tt.init(1)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, js.params))
    return jt, js, tt, ts


def _trees_close(mine, ref, atol):
    def check(a, b):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)
    jax.tree_util.tree_map(check, mine, jax.tree_util.tree_map(np.asarray, ref))


def _wave(G=4, P=32, seed=8):
    """u = sin(pi x0 + t) cos(x1) with its analytic Jacobian and Hessian,
    and point weights."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, (G, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 2)).astype(np.float32)
    a = np.pi * x[..., 0] + t
    b = x[..., 1]
    u = (np.sin(a) * np.cos(b))[..., None]
    ju = np.stack([np.pi * np.cos(a) * np.cos(b), -np.sin(a) * np.sin(b)], -1)[:, :, None]
    h01 = -np.pi * np.cos(a) * np.sin(b)
    hu = np.stack([np.stack([-np.pi ** 2 * np.sin(a) * np.cos(b), h01], -1),
                   np.stack([h01, -np.sin(a) * np.cos(b)], -1)], -2)[:, :, None]
    w = rng.uniform(0.5, 1.5, (G, P))
    return [v.astype(np.float32) for v in (t, x, u, ju, hu, w)]


# ------------------------------------------------ full-batch parity with JAX
@pytest.mark.parametrize("case,fused", [
    ("mse", None), ("mse", True), ("weighted", None), ("sobolev", None),
    ("sobolev", True), ("hessian", True)],
    ids=["mse", "mse-plain-K2", "weighted", "sobolev", "sobolev-plain-K6", "hessian-plain-K8"])
def test_fit_resident_full_batch_matches_jax(case, fused):
    """Four full-batch epochs (every group, every point, in order: neither
    package samples), so each step is the JAX scan's step."""
    t, x, u, ju, hu, w = _wave()
    kw = {"weighted": dict(sample_weight=w), "sobolev": dict(target_jac=ju),
          "hessian": dict(target_jac=ju, target_hess=hu)}.get(case, {})
    jt, js, tt, ts = _pair(w_jac=0.5, w_hess=0.05, fused=fused)
    js = jt.fit_resident(js, t, x, u, epochs=4, seed=0, **kw)
    ts = tt.fit_resident(ts, t, x, u, epochs=4, seed=0, **kw)
    assert ts.step == int(js.step) == 4
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    _trees_close(to_numpy_params(tt.model), js.params, atol=1e-4)
    assert tt.history["epoch"] == jt.history["epoch"] == [0, 1, 2, 3]
    assert tt.history["resident_graph"] == "eager"
    assert "not on CUDA" in tt.history["resident_graph_reason"]
    key = "path" if case in ("mse", "weighted") else "sobolev_path"
    assert tt.history[key] == "eager"


# ------------------------------------------------------- residual sampling
def test_residual_probs_and_gumbel_topk_match_jax():
    t, x, u, *_ = _wave(G=3, P=64, seed=2)
    jt, js, tt, ts = _pair()
    for alpha, mix in ((1.0, 0.5), (2.0, 0.1), (0.5, 0.0)):
        mine = tt.residual_probs(ts, t, x, u, alpha=alpha, mix=mix)
        ref = jt.residual_probs(js, t, x, u, alpha=alpha, mix=mix)
        assert mine.shape == ref.shape == (3, 64) and mine.dtype == np.float64
        np.testing.assert_allclose(mine, ref, atol=1e-5)
        np.testing.assert_allclose(mine.sum(axis=1), 1.0, rtol=1e-12)
    probs = np.random.default_rng(0).dirichlet(np.ones(64), size=5)
    for k in (1, 7, 64):
        mine = GroupedTrainer._gumbel_topk(probs, k, np.random.default_rng(11))
        ref = JaxGroupedTrainer._gumbel_topk(probs, k, np.random.default_rng(11))
        np.testing.assert_array_equal(mine, ref)
        assert all(len(set(row)) == k for row in mine)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "sample_weight"])
def test_residual_fit_matches_jax(weighted):
    """Four epochs of residual point sampling (refresh every two epochs,
    before the permutation; one Gumbel draw per step), three groups in
    batches of two (the tail padded), 24 of 64 points: the same batches
    from one numpy seed in both packages."""
    t, x, u, _ju, _hu, w = _wave(G=3, P=64, seed=4)
    jt, js, tt, ts = _pair()
    kw = dict(epochs=4, group_batch=2, point_batch=24, point_sampling="residual",
              resample_every=2, sample_weight=w if weighted else None)
    js = jt.fit(js, t, x, u, **kw)
    ts = tt.fit(ts, t, x, u, **kw)
    assert ts.step == int(js.step) == 8
    np.testing.assert_allclose(tt.history["loss"], jt.history["loss"], rtol=1e-4)
    _trees_close(to_numpy_params(tt.model), js.params, atol=1e-4)
    # both generators made the same calls
    assert tt._rng.integers(2**63) == jt._rng.integers(2**63)
    with pytest.raises(ValueError, match="unknown point_sampling"):
        tt.fit(ts, t, x, u, point_sampling="bogus")


# --------------------------------------------------------- the resident loop
def _localized_wave(G=8, P=128, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, G, dtype=np.float32)[:, None]
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    u = np.sin(2 * np.pi * (x[..., 0] - t)).astype(np.float32)[..., None]
    return t, x, u


def _model1(seed=0):
    """CFG_S1/CFG_P1 with the JAX model's parameters from ``seed``."""
    jm = nif_tpu.NIFMultiScale(CFG_S1, CFG_P1)
    params = jm.init(jax.random.key(seed))
    tm = nif_tpu_torch.NIFMultiScale(CFG_S1, CFG_P1, device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return tm


def _resident_trainer(seed=0, lr=5e-3, **kw):
    tr = GroupedTrainer(_model1(), _adam(lr), seed=seed, **kw)
    state = tr.init(0)
    from_jax_params(tr.model, jax.tree_util.tree_map(
        np.asarray, nif_tpu.NIFMultiScale(CFG_S1, CFG_P1).init(jax.random.key(0))))
    return tr, state


def test_fit_resident_trains_and_matches_objective():
    """tests/test_training.py:172-207 without the mesh: 40 epochs of two
    steps (4 of 8 groups, 64 of 128 points) halve the loss, as the JAX
    loop does from the same parameters; the weighted variant trains."""
    t, x, u = _localized_wave()
    tr, state = _resident_trainer()
    loss0 = tr.evaluate(state, t, x, u)
    state = tr.fit_resident(state, t, x, u, epochs=40, group_batch=4, point_batch=64, seed=1)
    assert tr.evaluate(state, t, x, u) < loss0 * 0.5
    assert state.step == 80
    w = np.random.default_rng(0).uniform(0.5, 1.5, x.shape[:2]).astype(np.float32)
    tr, state = _resident_trainer()
    state = tr.fit_resident(state, t, x, u, sample_weight=w, epochs=5, point_batch=64, seed=2)
    assert state.step == 5 and np.isfinite(tr.history["loss"][-1])


def test_fit_resident_chunking_keeps_host_obligations():
    """tests/test_training.py:209-263: per-epoch history, validation on its
    cadence, callbacks on every epoch with end-of-epoch state; the batches
    of a step do not depend on the chunking, so a run without callbacks (one
    chunk) gives the same losses bit for bit."""
    rng = np.random.default_rng(3)
    G, P = 4, 64
    t = np.linspace(0, 1, G, dtype=np.float32)[:, None]
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    u = np.sin(2 * np.pi * x).astype(np.float32)
    seen = []

    class Recorder:
        def on_train_begin(self, trainer):
            pass

        def on_epoch_end(self, trainer, state, epoch, logs):
            seen.append((epoch, state.step, logs["loss"]))

        def on_train_end(self, trainer, state):
            seen.append(("end", state.step))

    kw = dict(epochs=7, group_batch=2, point_batch=32, seed=1)
    tr, state = _resident_trainer()
    state = tr.fit_resident(state, t, x, u, callbacks=[Recorder()],
                            validation_data=(t, x, u), validation_every=3, **kw)
    assert state.step == 14
    assert tr.history["epoch"] == list(range(7)) and len(tr.history["loss"]) == 7
    assert tr.history["val_epoch"] == [0, 3, 6]
    assert all(np.isfinite(v) for v in tr.history["val_loss"])
    assert [s[0] for s in seen] == list(range(7)) + ["end"]
    assert [s[1] for s in seen[:-1]] == [2 * (e + 1) for e in range(7)]
    tr2, s2 = _resident_trainer()
    tr2.fit_resident(s2, t, x, u, **kw)
    assert tr2.history["loss"] == [s[2] for s in seen[:-1]]
    # validation alone splits the run into chunks too: the same losses
    tr3, s3 = _resident_trainer()
    tr3.fit_resident(s3, t, x, u, validation_data=(t, x, u), validation_every=2, **kw)
    assert tr3.history["loss"] == tr2.history["loss"]
    assert tr3.history["val_epoch"] == [0, 2, 4, 6]


def test_residual_point_sampling_resident():
    """tests/test_training.py:774-822 without the mesh: residual draws from
    refreshed probabilities train on a localized bump; the weighted +
    Sobolev variant composes; an unknown sampling is refused."""
    model = nif_tpu_torch.NIFMultiScale(
        {"input_dim": 1, "output_dim": 1, "units": 12, "nlayers": 1, "activation": "sine",
         "use_resblock": False, "omega_0": 5.0, "connectivity": "full",
         "weight_init_factor": 0.1},
        {"input_dim": 1, "latent_dim": 2, "units": 12, "nlayers": 1, "activation": "tanh",
         "use_resblock": False, "omega_0": 5.0}, device="cpu")
    rng = np.random.default_rng(0)
    G, P = 4, 128
    t = np.linspace(0, 1, G, dtype=np.float32)[:, None]
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    u = np.exp(-200.0 * (x[..., 0] - 0.5) ** 2).astype(np.float32)[..., None]
    tr = GroupedTrainer(model, _adam(5e-3), seed=0)
    st = tr.init(0)
    st = tr.fit_resident(st, t, x, u, epochs=30, group_batch=G, point_batch=8,
                         point_sampling="residual", resample_every=5, seed=1)
    assert np.isfinite(tr.evaluate(st, t, x, u)) and len(tr.history["loss"]) == 30
    w = rng.uniform(0.5, 1.5, (G, P)).astype(np.float32)
    ju = (-400.0 * (x[..., 0] - 0.5) * u[..., 0]).astype(np.float32)[..., None, None]
    tr2 = GroupedTrainer(model, _adam(1e-3), seed=0, w_jac=0.1)
    st2 = tr2.init(0)
    st2 = tr2.fit_resident(st2, t, x, u, sample_weight=w, target_jac=ju, epochs=6,
                           group_batch=2, point_batch=16, point_sampling="residual",
                           resample_every=3, seed=2)
    assert np.isfinite(tr2.history["loss"][-1]) and st2.step == 12
    with pytest.raises(ValueError, match="unknown point_sampling"):
        tr2.fit_resident(st2, t, x, u, epochs=1, point_sampling="bogus")


# ------------------------------------------------------------ the sampler
def test_resident_sampler_statistics():
    """Groups: distinct within a step, each group equally often. Points:
    uniform, with replacement. Residual draws: proportional to each row's
    probabilities. The sequence of draws is a function of the seed alone."""
    G, P, gb, pb = 6, 50, 4, 40
    t = np.arange(G, dtype=np.float32)[:, None]
    x = np.arange(G * P, dtype=np.float32).reshape(G, P, 1)
    data = ResidentData(t, x, x, group_batch=gb, point_batch=pb, seed=7, device="cpu")
    n_steps = 400
    g_counts = np.zeros(G)
    p_counts = np.zeros(P)
    dup = 0
    for i in range(n_steps):
        gsel, idx = data.indices()
        gsel, idx = gsel.numpy(), idx.numpy()
        assert len(set(gsel)) == gb and gsel.min() >= 0 and gsel.max() < G
        assert idx.shape == (gb, pb) and idx.min() >= 0 and idx.max() < P
        g_counts += np.bincount(gsel, minlength=G)
        p_counts += np.bincount(idx.ravel(), minlength=P)
        dup += sum(pb - len(np.unique(row)) for row in idx)
    assert dup > 0  # with replacement
    # chi-square against uniform
    exp_g = n_steps * gb / G
    assert chi2.sf(np.sum((g_counts - exp_g) ** 2 / exp_g), G - 1) > 1e-3
    exp_p = n_steps * gb * pb / P
    assert chi2.sf(np.sum((p_counts - exp_p) ** 2 / exp_p), P - 1) > 1e-3
    # the sequence of batches is a function of the seed: the gathered rows
    # are the rows a twin's draws at the same position name
    twin = ResidentData(t, x, x, group_batch=gb, point_batch=pb, seed=7, device="cpu")
    for _ in range(n_steps):
        twin.indices()
    batch = data.batch()
    gsel, idx = twin.indices()
    np.testing.assert_array_equal(batch["t"].numpy()[:, 0], gsel.numpy())
    xb = batch["x"]
    np.testing.assert_array_equal(xb.numpy()[..., 0], gsel.numpy()[:, None] * P + idx.numpy())
    assert batch["w"] is None and batch["target_jac"] is None and batch["target_hess"] is None
    again = ResidentData(t, x, x, group_batch=gb, point_batch=pb, seed=7, device="cpu")
    first = [again.batch()["x"] for _ in range(3)]
    restart = ResidentData(t, x, x, group_batch=gb, point_batch=pb, seed=7, device="cpu")
    assert all(torch.equal(restart.batch()["x"], a) for a in first)
    assert not torch.equal(first[0], first[1])
    other = ResidentData(t, x, x, group_batch=gb, point_batch=pb, seed=8, device="cpu")
    assert not torch.equal(other.batch()["x"], first[0])
    # residual: inverse-CDF draws follow each row's probabilities
    probs = np.random.default_rng(1).dirichlet(np.full(P, 0.5), size=G)
    probs[2, 10:] = 0.0
    probs[2] /= probs[2].sum()
    res = ResidentData(t, x, x, group_batch=G, point_batch=P, seed=3, residual=True,
                       device="cpu")
    res.set_probs(probs)
    draws = []
    for i in range(80):
        gsel, idx = res.indices()
        assert gsel is None and idx.shape == (G, P)
        draws.append(idx.numpy())
    draws = np.concatenate(draws, axis=1)  # [G, 4000]
    for g in range(G):
        counts = np.bincount(draws[g], minlength=P)
        keep = probs[g] > 0
        assert counts[~keep].sum() == 0
        exp = 4000 * probs[g][keep]
        big = exp >= 5  # the sparse bins pooled into one
        obs = np.append(counts[keep][big], counts[keep][~big].sum())
        exp = np.append(exp[big], exp[~big].sum())
        obs, exp = obs[exp > 0], exp[exp > 0]
        assert chi2.sf(np.sum((obs - exp) ** 2 / exp), len(exp) - 1) > 1e-3, g


def test_seed_key_and_graph_form():
    """Any seed fit_resident can be given (JAX's draw is below 2**63) seeds
    the sampler; the graph form follows the optimizer."""
    t, x, u, *_ = _wave(G=2, P=16)
    for seed in (0, 2**63 - 1):
        data = ResidentData(t, x, u, group_batch=1, point_batch=8, seed=seed, device="cpu")
        assert data.batch()["x"].shape == (1, 8, x.shape[2])
    # the device defaults to CUDA, as every entry point's does
    if torch.cuda.is_available():
        assert ResidentData(t, x, u, group_batch=1, point_batch=8, seed=0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ResidentData(t, x, u, group_batch=1, point_batch=8, seed=0)
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))], lr=1e-3)
    assert graph_form(opt, "cpu") == ("eager", "not on CUDA (device 'cpu')")
    assert graph_form(opt, "cuda")[0] == "forward_backward"
    cap = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], lr=1e-3, capturable=True)
    form, reason = graph_form(cap, "cuda")
    assert form == "step" and "capturable=True" in reason
    sgd = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1e-3)
    assert graph_form(sgd, "cuda") == (
        "forward_backward", "SGD is not an Adam or AdamW with capturable=True: opt.step() runs "
        "after each replay")


def test_whole_step_graph_reads_the_scheduled_learning_rate():
    """The whole-step graph reads each param group's lr from a tensor the
    loop fills before its replays: a schedule's float lands there, the
    group keeps its float, and only another hyperparameter's change calls
    for a new capture."""
    t, x, u, *_ = _wave(G=2, P=16)
    tr, st = _pair(lr=3e-3)[2:]
    data = ResidentData(t, x, u, group_batch=2, point_batch=16, seed=0, device="cpu")
    loop = ResidentLoop(tr, st.opt_state, data, 4)
    loop._lr = [torch.zeros((), dtype=torch.float32)]  # as the whole-step form keeps it
    group = st.opt_state.param_groups[0]
    captured = _hyperparameters(st.opt_state)
    group["lr"] = float(group["lr"]) * 0.5  # what LearningRateScheduler writes
    loop._fill_lr()
    assert float(loop._lr[0]) == np.float32(1.5e-3) and type(group["lr"]) is float
    assert _hyperparameters(st.opt_state) == captured
    group["betas"] = (0.8, 0.999)
    assert _hyperparameters(st.opt_state) != captured


def test_fit_resident_seed_none_draws_from_the_trainer_rng_like_jax():
    t, x, u, *_ = _wave(G=2, P=16)
    jt, js, tt, ts = _pair(seed=9)
    jt.fit_resident(js, t, x, u, epochs=1)
    tt.fit_resident(ts, t, x, u, epochs=1)
    assert tt._rng.bit_generator.state == jt._rng.bit_generator.state
    tt.fit_resident(ts, t, x, u, epochs=1, seed=4)
    assert tt._rng.bit_generator.state == jt._rng.bit_generator.state


def test_fit_resident_second_dataset_trains_on_it():
    """A second call on a dataset of another size stages and trains on that
    dataset (the point of tests/test_training.py:1116-1134): its full-batch
    first step's loss is the MSE of the new dataset at the parameters the
    first call left."""
    t1, x1, u1, *_ = _wave(G=4, P=32, seed=0)
    t2, x2, u2, *_ = _wave(G=8, P=32, seed=1)
    tr, st = _pair()[2:]
    st = tr.fit_resident(st, t1, x1, u1, epochs=2, group_batch=4, point_batch=32)
    before = tr.evaluate(st, t2, x2, u2)
    st = tr.fit_resident(st, t2, x2, u2, epochs=2, group_batch=8, point_batch=32)
    assert tr.history["loss"][2] == pytest.approx(before, rel=1e-6)
    assert st.step == 4 and tr.history["loss"][3] < tr.history["loss"][2]
    assert all(p.grad is None for p in tr.model.parameters())


def test_scheduled_resident_fit_equals_the_eager_loop():
    """fit_resident with a learning-rate schedule against a loop of
    GroupedTrainer.step over the same resident batches, lr set per epoch:
    the same losses and parameters, bit for bit."""
    t, x, u, *_ = _wave(G=4, P=32)
    schedule = LearningRateScheduler(lambda epoch, lr: lr * 0.5)
    tr, st = _pair(lr=3e-3)[2:]
    ref_tr, ref_st = _pair(lr=3e-3)[2:]
    st = tr.fit_resident(st, t, x, u, epochs=3, group_batch=2, point_batch=16, seed=5,
                         callbacks=[schedule])
    data = ResidentData(t, x, u, group_batch=2, point_batch=16, seed=5, device="cpu")
    losses = []
    for epoch in range(3):
        for i in range(2):
            ref_st, loss = ref_tr.step(ref_st, **data.batch())
            losses.append(float(loss))
        for group in ref_st.opt_state.param_groups:
            group["lr"] *= 0.5
    assert tr.history["loss"] == [float(np.mean(losses[i: i + 2], dtype=np.float64))
                                  for i in (0, 2, 4)]
    assert st.opt_state.param_groups[0]["lr"] == pytest.approx(3e-3 / 8)
    for a, b in zip(tr.model.parameters(), ref_tr.model.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ init_or_restore
TUT1_S = {"input_dim": 1, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "swish"}
TUT1_P = {"input_dim": 1, "latent_dim": 1, "units": 16, "nlayers": 2, "activation": "swish"}


def _rows(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    tx = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    return tx, np.sin(2 * np.pi * (tx[:, 1:] - tx[:, :1])).astype(np.float32)


def _point_trainer(seed=0):
    return Trainer(nif_tpu_torch.NIF(TUT1_S, TUT1_P, device="cpu"), _adam(2e-3), seed=seed)


def test_checkpoint_resume(tmp_path):
    """tests/test_training.py:113-135: a fresh trainer resumes from the
    latest checkpoint (epoch 2 of 4 at two steps an epoch: step 6), with the
    parameters and the optimizer's moments as they were saved."""
    inputs, targets = _rows()
    trainer = _point_trainer()
    state = trainer.init(0)
    ckpt_dir = str(tmp_path / "ckpt")
    state = trainer.fit(state, inputs, targets, epochs=4, batch_size=1000,
                        callbacks=[CheckpointCallback(ckpt_dir, every=2)])
    saved = Checkpointer(ckpt_dir).restore(6)
    trainer2 = _point_trainer()
    resumed = trainer2.init_or_restore(99, ckpt_dir)
    assert resumed.step == 6
    for k, v in resumed.params.state_dict().items():
        assert torch.equal(v, saved["params"][k])
    moments = resumed.opt_state.state_dict()["state"]
    for k, v in saved["opt_state"]["state"].items():
        assert torch.equal(moments[k]["exp_avg"], v["exp_avg"])
    pred = trainer2.model.apply(inputs[:4])
    assert torch.all(torch.isfinite(pred))


def test_resume_matches_jax_and_prefers_full_state_over_final_marker(tmp_path):
    """tests/test_training.py:138-170 on both trainers, step for step against
    the JAX package's resume: the latest real step wins over a params-only
    final marker, which is taken only when it is all there is, under a fresh
    optimizer."""
    inputs, targets = _rows()
    jtr = JaxTrainer(nif_tpu.NIF(TUT1_S, TUT1_P), optax.adam(2e-3))
    js = jtr.init(jax.random.key(0))
    jtr.fit(js, inputs, targets, epochs=4, batch_size=1000,
            callbacks=[JaxCheckpointCallback(str(tmp_path / "jax"), every=2)])
    j_resumed = JaxTrainer(nif_tpu.NIF(TUT1_S, TUT1_P), optax.adam(2e-3)).init_or_restore(
        jax.random.key(99), str(tmp_path / "jax"))
    trainer = _point_trainer()
    state = trainer.init(0)
    ckpt_dir = str(tmp_path / "ckpt")
    state = trainer.fit(state, inputs, targets, epochs=4, batch_size=1000,
                        callbacks=[CheckpointCallback(ckpt_dir, every=2)])
    Checkpointer(ckpt_dir).save(state.step + FINAL_MARKER_OFFSET, state.params.state_dict())
    resumed = _point_trainer().init_or_restore(99, ckpt_dir)
    assert resumed.step == int(j_resumed.step) == 6
    only_marker = Checkpointer(str(tmp_path / "marker_only"))
    only_marker.save(FINAL_MARKER_OFFSET + 8, state.params.state_dict())
    r2 = _point_trainer().init_or_restore(99, str(tmp_path / "marker_only"))
    assert r2.step == FINAL_MARKER_OFFSET + 8
    assert r2.opt_state.state_dict()["state"] == {}  # a fresh optimizer
    for k, v in r2.params.state_dict().items():
        assert torch.equal(v, state.params.state_dict()[k])
    # the grouped trainer: the same choice of checkpoint
    t, x, u, *_ = _wave(G=4, P=32)
    gt = GroupedTrainer(nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu"), _adam(1e-3))
    gs = gt.init(0)
    gdir = str(tmp_path / "grouped")
    gs = gt.fit_resident(gs, t, x, u, epochs=3, group_batch=2, point_batch=16, seed=0,
                         callbacks=[CheckpointCallback(gdir, every=1)])
    Checkpointer(gdir).save(gs.step + FINAL_MARKER_OFFSET, gs.params.state_dict())
    gt2 = GroupedTrainer(nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu"), _adam(1e-3))
    g_resumed = gt2.init_or_restore(5, gdir)
    assert g_resumed.step == gs.step == 6
    for a, b in zip(gt2.model.parameters(), gt.model.parameters()):
        assert torch.equal(a, b)
    # resumed training continues from the saved moments, as the original does
    gs = gt.fit_resident(gs, t, x, u, epochs=1, group_batch=2, point_batch=16, seed=1)
    g_resumed = gt2.fit_resident(g_resumed, t, x, u, epochs=1, group_batch=2, point_batch=16,
                                 seed=1)
    assert gt2.history["loss"] == gt.history["loss"][-1:]


def test_fresh_init_when_no_checkpoint(tmp_path):
    for trainer in (_point_trainer(),
                    GroupedTrainer(nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu"),
                                   _adam(1e-3))):
        state = trainer.init_or_restore(0, str(tmp_path / "none"))
        assert state.step == 0 and state.opt_state.state_dict()["state"] == {}


def test_step_constants_are_uploaded_once():
    """A captured step may copy nothing from the host: the index and mask
    constants of the Sobolev and Hessian steps (index subsets, the Hessian
    selection) are made once per value and device, then reused."""
    from nif_tpu_torch.ops import fused_derivatives as fd

    a = fd._device_constant(np.arange(3), "cpu")
    assert fd._device_constant(np.arange(3), "cpu") is a
    assert fd._device_constant(np.arange(4), "cpu") is not a
    assert fd._device_constant(np.arange(3).astype(np.float32), "cpu") is not a
    t, x, u, ju, hu, w = _wave(G=2, P=16)
    tm = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu")
    kw = dict(target_jac=ju[..., :1], target_hess=hu[..., :1, :1], x_index=[0], weight=w,
              fused=True)
    first, *_ = tm.sobolev_value_and_grad(t, x, u, **kw)
    n = len(fd._CONSTANTS)
    again, *_ = tm.sobolev_value_and_grad(t, x, u, **kw)
    assert len(fd._CONSTANTS) == n and float(again) == float(first)
