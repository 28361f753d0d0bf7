"""The port's multi-host worker (``python -m nif_tpu_torch.parallel.multihost``)
on local CPU gloo clusters (the counterparts of ``tests/test_multihost.py``).

Each host stripes the GroupedDataset shards and feeds its ranks local
batches; the averaged loss must come back identical on every rank. A host
of the JAX test is a process with two devices; here a host is
``devices_per_process`` ranks, one process each. The clusters this file
needs run at module scope, three at once, each process and every collective
under a timeout. The worker imports the port only; the global metric is
held against JAX's ``evaluate_metrics`` on the full dataset with the
workers' final parameters (rel 1e-4, as the JAX test holds it).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import nif_tpu
from nif_tpu.training import GroupedTrainer as JaxGroupedTrainer
from nif_tpu.training.trainer import TrainState as JaxTrainState
from nif_tpu_torch.data import GroupedDataset
from nif_tpu_torch.parallel.multihost import launch_local_cluster

TIMEOUT = 240


def _arrays(G=8, P=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, 2)).astype(np.float32),
            rng.standard_normal((G, P, 2)).astype(np.float32),
            rng.standard_normal((G, P, 1)).astype(np.float32))


def _make_data(root, name, G=8, P=128, groups_per_file=2, seed=0):
    t, x, u = _arrays(G, P, seed)
    data_dir = str(root / name)
    GroupedDataset.create_from_arrays(t, x, u, data_dir, groups_per_file=groups_per_file)
    return data_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    snaps = _make_data(root, "snaps")
    uneven = _make_data(root, "uneven", G=6, P=64)
    ckpt = str(root / "ckpt")
    common = dict(n_processes=2, group_batch_per_host=2, timeout=TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        dp = pool.submit(launch_local_cluster, snaps, devices_per_process=1,
                         out_dir=str(root / "dp"), ckpt_dir=ckpt, **common)
        # the model axis inside a host of two ranks, each taking the host's
        # whole batch: the same global batches as the data-parallel run
        tp = pool.submit(launch_local_cluster, snaps, devices_per_process=2,
                         out_dir=str(root / "tp"), model_axis=2, **common)
        lock = pool.submit(launch_local_cluster, uneven, devices_per_process=1,
                           out_dir=str(root / "uneven"), point_batch=32, **common)
        out = {"dp": dp.result(), "tp": tp.result(), "uneven": lock.result()}
    out["resumed"] = launch_local_cluster(snaps, devices_per_process=1,
                                          out_dir=str(root / "r2"), ckpt_dir=ckpt, **common)
    out["root"] = root
    return out


def test_two_process_data_parallel(runs):
    results = runs["dp"]
    assert all(r["world_size"] == 2 and r["num_processes"] == 2 for r in results)
    # 8 groups striped 4/4, local group_batch 2 -> 2 steps/epoch x 2 epochs
    assert all(r["steps"] == 4 for r in results)
    # the averaged loss is identical across processes
    assert results[0]["final_loss"] == results[1]["final_loss"]
    assert np.isfinite(results[0]["final_loss"])


def test_two_process_global_metrics_match_single_process(runs):
    """The workers' all_reduce-joined global MSE / rel-L2 over the striped
    dataset equal a single-process computation on the FULL dataset with the
    same final parameters: JAX's evaluate_metrics."""
    results = runs["dp"]
    for key in ("global_mse", "global_rel_l2"):
        assert results[0][key] == results[1][key]
        assert np.isfinite(results[0][key])
    tree = {}
    with np.load(str(runs["root"] / "dp" / "worker_0.json.params.npz")) as z:
        for k in z.files:
            node = tree
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(z[k])
    model = nif_tpu.NIFMultiScale(
        {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.1},
        {"input_dim": 2, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0})
    template = model.init(jax.random.key(0))
    assert (jax.tree_util.tree_structure(template)
            == jax.tree_util.tree_structure(tree))
    t, x, u = _arrays()
    tr = JaxGroupedTrainer(model, optax.adam(1e-3))
    metrics = tr.evaluate_metrics(JaxTrainState(tree, None), t, x, u)
    assert results[0]["global_mse"] == pytest.approx(metrics["mse"], rel=1e-4)
    assert results[0]["global_rel_l2"] == pytest.approx(metrics["rel_l2"], rel=1e-4)


def test_multihost_checkpoint_restore_continues(runs):
    """A cluster saves a full-state checkpoint (rank 0 writes), the cluster
    ends, a fresh cluster restores from the shared directory and CONTINUES:
    its first step loss sits on the old trajectory, not at a fresh init."""
    run1, run2 = runs["dp"], runs["resumed"]
    assert all(r["resumed_step"] == 0 for r in run1)
    assert all(r["steps"] == 4 for r in run1)
    assert all(r["resumed_step"] == 4 for r in run2)
    assert all(r["steps"] == 8 for r in run2)
    assert run2[0]["first_loss"] < run1[0]["first_loss"]
    assert run2[0]["first_loss"] == pytest.approx(run1[0]["final_loss"], rel=0.5)
    assert np.isfinite(run2[0]["global_rel_l2"])


def test_two_process_tensor_parallel_matches_data_parallel(runs):
    """Multi-host TENSOR parallelism: two hosts of two ranks on a ('data',
    'model') mesh (head kernel + Adam moments split over 'model', ZeRO-1 on
    the point-wise Trainer) train to the data-parallel trajectory."""
    dp, tp = runs["dp"], runs["tp"]
    assert all(r["world_size"] == 4 for r in tp)
    assert all(r["head_is_sharded"] for r in tp)
    assert all(r["zero1_moment_sharded"] for r in tp)
    assert np.isfinite(tp[0]["zero1_loss"])
    assert len({r["final_loss"] for r in tp}) == 1
    assert tp[0]["first_loss"] == pytest.approx(dp[0]["first_loss"], rel=1e-5)
    assert tp[0]["final_loss"] == pytest.approx(dp[0]["final_loss"], rel=1e-5)
    assert tp[0]["global_rel_l2"] == pytest.approx(dp[0]["global_rel_l2"], rel=1e-5)


def test_uneven_stripe_stays_in_lockstep(runs):
    """3 shard files stripe 2/1 across 2 hosts; without global-min step
    truncation host 0 would take more collective steps than host 1 and the
    cluster would deadlock."""
    results = runs["uneven"]
    # host 0 has 2 files (2 steps/epoch available), host 1 has 1 file
    # (1 step/epoch): both must truncate to 1 step/epoch x 2 epochs
    assert all(r["steps"] == 2 for r in results)
    assert results[0]["final_loss"] == results[1]["final_loss"]
