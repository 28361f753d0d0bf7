"""The port's streaming data layer against the JAX package's on the CPU.

``nif_tpu_torch/data/sharded_dataset.py`` is pinned to
``nif_tpu/data/sharded_dataset.py`` by AST (imports and docstrings aside) and
``nif_tpu_torch/data/_nifio.cpp`` to ``nif_tpu/data/_nifio.cpp`` byte for
byte. The native reader (built into ``build/nif_tpu_torch/``) and its numpy
fallback give JAX's results exactly; both datasets stream JAX's batches, bit
for bit, for one seed with every option; ``prefetch_to_device(device="cpu")``
yields what direct iteration yields; and three ``GroupedTrainer.step``s on
streamed batches give the JAX trainer's losses (float32, rel 1e-5: the same
steps summed in another order).
"""
import ast
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu.data import nifio as jax_nifio
from nif_tpu.data.sharded_dataset import GroupedDataset as JaxGroupedDataset
from nif_tpu.data.sharded_dataset import ShardedDataset as JaxShardedDataset
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
import nif_tpu_torch
from nif_tpu_torch import optimizers
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.data import GroupedDataset, ShardedDataset, nifio, prefetch_to_device
from nif_tpu_torch.training import GroupedTrainer

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _code(path: pathlib.Path) -> str:
    """The module's AST without its docstrings and its imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    tree.body = [n for n in tree.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


def test_sharded_dataset_is_a_copy_of_the_jax_module():
    assert _code(REPO / "nif_tpu_torch/data/sharded_dataset.py") == _code(
        REPO / "nif_tpu/data/sharded_dataset.py")


def test_nifio_source_is_a_copy_of_the_jax_one():
    assert (REPO / "nif_tpu_torch/data/_nifio.cpp").read_bytes() == (
        REPO / "nif_tpu/data/_nifio.cpp").read_bytes()


def test_native_reader_builds_under_build_dir():
    assert nifio.native_available()
    lib = nifio._target()
    assert lib.exists() and lib.parent == REPO / "build" / "nif_tpu_torch"


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_reader_functions_match_jax(native, monkeypatch):
    if not native:
        monkeypatch.setenv("NIF_NO_NATIVE", "1")
    assert nifio.native_available() == native
    rng = np.random.default_rng(0)
    src = rng.standard_normal((1000, 7)).astype(np.float32)
    idx = rng.integers(0, 1000, 3000)
    np.testing.assert_array_equal(nifio.gather_rows(src, idx), jax_nifio.gather_rows(src, idx))
    for seed in (0, 7, 2**40 + 3):
        np.testing.assert_array_equal(nifio.permute_rows(src, seed),
                                      jax_nifio.permute_rows(src, seed))
    bits = np.array([0x7FC00001, 0xFFFFFFFF, 0x3F808000, 0x3F818000, 0], np.uint32)
    vals = np.concatenate([src.reshape(-1), bits.view(np.float32)])
    np.testing.assert_array_equal(nifio.f32_to_bf16(vals), jax_nifio.f32_to_bf16(vals))
    with pytest.raises(IndexError) as mine:
        nifio.gather_rows(src, np.array([0, 1000]))
    if native:
        with pytest.raises(IndexError) as ref:
            jax_nifio.gather_rows(src, np.array([0, 1000]))
        assert str(mine.value) == str(ref.value)


def _batches_equal(mine, ref):
    mine, ref = list(mine), list(ref)
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            if v is None or isinstance(v, (int, np.integer)):
                assert u == v
            else:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("area_weight", [False, True])
def test_sharded_dataset_streams_jax_batches(tmp_path, area_weight):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((530, 5 if area_weight else 4)).astype(np.float32)
    np.save(tmp_path / "all.npy", data)
    for pkg, cls in (("port", ShardedDataset), ("jax", JaxShardedDataset)):
        cls(2, 2, area_weight).create_from_npz(100, str(tmp_path / "all.npy"), "data",
                                               str(tmp_path / pkg), seed=3)
    for name in ["meta.json"] + [f"shard_{i}.npy" for i in range(6)]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for kw in (dict(batch_size=32, epochs=2, seed=5), dict(batch_size=32, shuffle=False),
               dict(batch_size=64, drop_remainder=False, seed=9)):
        for host in ((0, 1), (1, 2)):
            mine = ShardedDataset.from_dir(str(tmp_path / "port"), *host)
            ref = JaxShardedDataset.from_dir(str(tmp_path / "jax"), *host)
            assert mine.steps_per_epoch(kw["batch_size"]) == ref.steps_per_epoch(
                kw["batch_size"])
            _batches_equal(mine.iter_batches(**kw), ref.iter_batches(**kw))


def _grouped_arrays(G=7, P=40, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(t=f(G, 1), x=f(G, P, 2), u=f(G, P, 1),
                weight=rng.uniform(0.5, 1.5, (G, P)).astype(np.float32),
                target_jac=f(G, P, 1, 2), target_hess=f(G, P, 1, 2, 2))


@pytest.mark.parametrize("opts", [
    dict(),
    dict(drop_remainder=True, epochs=2),
    dict(with_jac=True),
    dict(with_hess=True),
    dict(with_jac=True, with_hess=True, epochs=2),
    dict(point_sampler=True),
], ids=["plain", "drop_remainder", "jac", "hess", "jac_hess", "point_sampler"])
def test_grouped_dataset_streams_jax_batches(tmp_path, opts):
    arrays = _grouped_arrays()
    JaxGroupedDataset.create_from_arrays(out_path=str(tmp_path / "jax"), groups_per_file=3,
                                         **arrays)
    GroupedDataset.create_from_arrays(out_path=str(tmp_path / "port"), groups_per_file=3,
                                      **arrays)
    opts = dict(opts)
    if opts.pop("point_sampler", False):
        opts["point_sampler"] = lambda t, x, u: np.abs(u[..., 0]) + 0.1
    for host in ((0, 1), (1, 2)):
        mine = GroupedDataset().open(str(tmp_path / "port"), *host)
        ref = JaxGroupedDataset().open(str(tmp_path / "jax"), *host)
        assert mine.steps_per_epoch(2) == ref.steps_per_epoch(2)
        _batches_equal(mine.iter_batches(2, 16, seed=4, **opts),
                       ref.iter_batches(2, 16, seed=4, **opts))


def test_grouped_dataset_refusals_match_jax(tmp_path):
    arrays = _grouped_arrays()
    del arrays["target_jac"], arrays["target_hess"]
    GroupedDataset.create_from_arrays(out_path=str(tmp_path), **arrays)
    for kw in (dict(with_jac=True), dict(with_hess=True)):
        with pytest.raises(ValueError) as mine:
            next(GroupedDataset(str(tmp_path)).iter_batches(2, **kw))
        with pytest.raises(ValueError) as ref:
            next(JaxGroupedDataset(str(tmp_path)).iter_batches(2, **kw))
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_on_the_cpu_equals_direct_iteration(tmp_path, size):
    arrays = _grouped_arrays()
    GroupedDataset.create_from_arrays(out_path=str(tmp_path), groups_per_file=3, **arrays)
    ds = GroupedDataset(str(tmp_path))
    direct = list(ds.iter_batches(2, 16, epochs=2, seed=1, with_jac=True))
    fetched = list(prefetch_to_device(ds.iter_batches(2, 16, epochs=2, seed=1, with_jac=True),
                                      size=size, device="cpu"))
    assert len(fetched) == len(direct)
    for a, b in zip(fetched, direct):
        assert len(a) == len(b) == 6 and a[0] == b[0]
        for u, v in zip(a[1:], b[1:]):
            assert isinstance(u, torch.Tensor) and u.device.type == "cpu"
            np.testing.assert_array_equal(u.numpy(), v)
    unweighted = [(0, np.zeros(2, np.float32), None)]
    assert list(prefetch_to_device(iter(unweighted), device="cpu"))[0][2] is None
    with pytest.raises(ValueError, match="size must be >= 1"):
        prefetch_to_device(iter(()), size=0, device="cpu")


def test_prefetch_to_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(iter(()))


CFG_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 2, "activation": "sine",
         "use_resblock": False, "omega_0": 10.0, "connectivity": "full",
         "weight_init_factor": 0.01}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1, "activation": "swish"}


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_streamed_grouped_steps_match_jax(tmp_path, fused):
    """Three steps of each trainer on the batches its own package streams
    from one dataset and seed (the port's through prefetch_to_device)."""
    arrays = _grouped_arrays(G=6, P=64)
    del arrays["target_jac"], arrays["target_hess"]
    GroupedDataset.create_from_arrays(out_path=str(tmp_path), groups_per_file=2, **arrays)
    jm = nif_tpu.NIFMultiScale(CFG_S, CFG_P)
    jtr = JaxGroupedTrainer(jm, optax.adam(1e-3), fused=False)
    jstate = jtr.init(jax.random.key(0))
    tm = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu")
    ttr = GroupedTrainer(tm, optimizers.adam(1e-3), fused=fused)
    tstate = ttr.init(0)
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, jstate.params))
    ref, mine = [], []
    for _epoch, t, x, u, w in JaxGroupedDataset(str(tmp_path)).iter_batches(2, 32, seed=8):
        jstate, loss = jtr.step(jstate, t, x, u, w)
        ref.append(float(loss))
    stream = GroupedDataset(str(tmp_path)).iter_batches(2, 32, seed=8)
    for _epoch, t, x, u, w in prefetch_to_device(stream, device="cpu"):
        tstate, loss = ttr.step(tstate, t, x, u, w)
        mine.append(float(loss))
    assert len(mine) == len(ref) == 3
    np.testing.assert_allclose(mine, ref, rtol=1e-5)
