"""The port's command line (``python -m nif_tpu_torch train|eval|export``)
on the CPU (``--device cpu``): the counterparts of ``tests/test_cli.py``,
then its parsers against the JAX package's flag for flag, ``eval`` of JAX's
own trained parameters (crossed through ``convert.py``) against JAX's
``eval`` (mse and rel_l2 rel 1e-5: the same float64 sums of float32
predictions that differ in the last bits), and ``--data-parallel`` on two
ranks from torchrun's environment against one process (float32 rel 1e-5;
mixed_bfloat16 within what a rank split's bf16 rounding moves, see
``DP_LOSS_REL``).
"""
import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import nif_tpu_torch
from nif_tpu_torch.cli import build_parser, main as cli_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def run(*argv):
    return cli_main(list(argv) + CPU)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def workdir(tmp_path):
    cfg = {
        "cfg_shape_net": {"input_dim": 1, "output_dim": 1, "units": 8,
                          "nlayers": 1, "activation": "tanh"},
        "cfg_parameter_net": {"input_dim": 1, "latent_dim": 1, "units": 8,
                              "nlayers": 1, "activation": "tanh"},
        "mixed_policy": "float32",
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, 400).astype(np.float32)
    x = rng.uniform(0, 1, 400).astype(np.float32)
    u = np.sin(2 * np.pi * (x - t)).astype(np.float32)
    np.savez(tmp_path / "data.npz", data=np.stack([t, x, u], -1))
    return tmp_path


def test_cli_train_eval(workdir, capsys):
    ckpt = str(workdir / "ckpt")
    mse = run("train", "--config", str(workdir / "config.json"),
              "--data", str(workdir / "data.npz"), "--epochs", "30",
              "--batch-size", "200", "--ckpt-dir", ckpt)
    assert mse < 1.0
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    mse_eval = run("eval", "--config", str(workdir / "config.json"),
                   "--data", str(workdir / "data.npz"), "--ckpt-dir", ckpt,
                   "--batch-size", "128")
    parsed = last_json(capsys)
    assert "rel_l2" in parsed and parsed["mse"] == pytest.approx(mse_eval)


def test_cli_lbfgs_flag(workdir):
    mse = run("train", "--config", str(workdir / "config.json"),
              "--data", str(workdir / "data.npz"), "--epochs", "10",
              "--batch-size", "400", "--lbfgs", "20")
    assert np.isfinite(mse)


def test_cli_eval_from_full_state_checkpoint(workdir, capsys):
    """Interrupted training leaves a full-state {params, opt_state, step}
    checkpoint as the latest; eval takes its params."""
    from nif_tpu_torch.training import Checkpointer, Trainer

    cfg = json.loads((workdir / "config.json").read_text())
    model = nif_tpu_torch.NIF(cfg["cfg_shape_net"], cfg["cfg_parameter_net"], device="cpu")
    trainer = Trainer(model, lambda p: torch.optim.Adam(p, lr=1e-3))
    state = trainer.init(0)
    ckpt_dir = str(workdir / "ckpt_full")
    Checkpointer(ckpt_dir).save(3, {"params": state.params.state_dict(),
                                    "opt_state": state.opt_state.state_dict(), "step": 0})
    mse = run("eval", "--config", str(workdir / "config.json"),
              "--data", str(workdir / "data.npz"), "--ckpt-dir", ckpt_dir,
              "--batch-size", "128")
    assert np.isfinite(mse)
    assert "rel_l2" in last_json(capsys)


def test_cli_eval_requires_ckpt_dir(workdir):
    with pytest.raises(SystemExit):
        run("eval", "--config", str(workdir / "config.json"),
            "--data", str(workdir / "data.npz"))


def _shards(workdir, name, rows):
    from nif_tpu_torch.data import ShardedDataset

    shard_dir = str(workdir / name)
    ShardedDataset(2, 1).create_from_npz(rows, str(workdir / "data.npz"), "data", shard_dir)
    return shard_dir


def test_cli_streaming_train_eval_from_shard_dir(workdir, capsys):
    shard_dir = _shards(workdir, "shards", 100)
    ckpt = str(workdir / "ckpt_stream")
    loss = run("train", "--config", str(workdir / "config.json"),
               "--data", shard_dir, "--epochs", "20", "--batch-size", "100",
               "--ckpt-dir", ckpt)
    assert np.isfinite(loss)
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    mse = run("eval", "--config", str(workdir / "config.json"),
              "--data", shard_dir, "--ckpt-dir", ckpt, "--batch-size", "100")
    parsed = last_json(capsys)
    assert np.isfinite(mse) and parsed["mse"] == pytest.approx(mse)


def test_cli_streaming_lbfgs_fine_tune(workdir):
    shard_dir = _shards(workdir, "lbfgs_shards", 100)
    loss = run("train", "--config", str(workdir / "config.json"),
               "--data", shard_dir, "--epochs", "10", "--batch-size", "100",
               "--lbfgs", "15")
    assert np.isfinite(loss)


def test_cli_streaming_zero_steps_is_loud(workdir):
    shard_dir = _shards(workdir, "tiny_shards", 100)
    with pytest.raises(SystemExit, match="zero steps"):
        run("train", "--config", str(workdir / "config.json"),
            "--data", shard_dir, "--epochs", "1", "--batch-size", "4096")


GROUPED_CFG = {
    "cfg_shape_net": {"input_dim": 1, "output_dim": 1, "units": 16,
                      "nlayers": 1, "activation": "sine",
                      "use_resblock": False, "omega_0": 30.0,
                      "connectivity": "full", "weight_init_factor": 0.1},
    "cfg_parameter_net": {"input_dim": 1, "latent_dim": 2, "units": 16,
                          "nlayers": 1, "activation": "swish",
                          "use_resblock": False, "omega_0": 30.0},
    "mixed_policy": "float32",
}


def _wave(G, P, seed, jac=False, hess=False):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, G, dtype=np.float32)[:, None]
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    phase = 2 * np.pi * (x[..., 0] - t)
    u = np.sin(phase).astype(np.float32)[..., None]
    ju = (2 * np.pi * np.cos(phase)).astype(np.float32)[..., None, None]
    hu = (-(2 * np.pi) ** 2 * np.sin(phase)).astype(np.float32)[..., None, None, None]
    return t, x, u, (ju if jac else None), (hu if hess else None)


@pytest.fixture
def grouped_workdir(tmp_path):
    """A multiscale config + GroupedDataset snapshot directory."""
    from nif_tpu_torch.data import GroupedDataset

    (tmp_path / "config.json").write_text(json.dumps(GROUPED_CFG))
    rng = np.random.default_rng(0)
    G, P = 10, 64
    t = np.linspace(0, 1, G, dtype=np.float32)[:, None]
    x = rng.uniform(-1, 1, (G, P, 1)).astype(np.float32)
    u = np.sin(2 * np.pi * (x[..., 0] - t)).astype(np.float32)[..., None]
    GroupedDataset.create_from_arrays(t, x, u, str(tmp_path / "snaps"), groups_per_file=4)
    return tmp_path


def _grouped_arrays(snap_dir):
    from nif_tpu_torch.data import GroupedDataset

    ts, xs, us = [], [], []
    for _, bt, bx, bu, _w in GroupedDataset(snap_dir).iter_batches(
            group_batch=10, point_batch=None, epochs=1, seed=0):
        ts.append(bt), xs.append(bx), us.append(bu)
    return np.concatenate(ts), np.concatenate(xs), np.concatenate(us)


def test_cli_grouped_train_eval(grouped_workdir, capsys):
    """GroupedDataset -> GroupedTrainer end to end with checkpoints (10
    groups / batch 4: a padded tail batch), then a grouped eval equal to
    GroupedTrainer.evaluate on the restored parameters."""
    from nif_tpu_torch.training import Checkpointer, GroupedTrainer, TrainState

    wd = grouped_workdir
    snap_dir, ckpt = str(wd / "snaps"), str(wd / "ckpt_grouped")
    loss = run("train", "--config", str(wd / "config.json"), "--data", snap_dir,
               "--model", "multiscale", "--epochs", "30", "--lr", "5e-3",
               "--group-batch", "4", "--point-batch", "64", "--ckpt-dir", ckpt)
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "compute path: eager" in out and f"final loss: {loss:.6e}" in out
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    mse = run("eval", "--config", str(wd / "config.json"), "--data", snap_dir,
              "--model", "multiscale", "--ckpt-dir", ckpt)
    parsed = last_json(capsys)
    assert np.isfinite(mse) and parsed["mse"] == pytest.approx(mse)
    assert "rel_l2" in parsed
    model = nif_tpu_torch.NIFMultiScale(GROUPED_CFG["cfg_shape_net"],
                                        GROUPED_CFG["cfg_parameter_net"], device="cpu")
    model.param_tree().load_state_dict(Checkpointer(ckpt).restore())
    ref = GroupedTrainer(model, lambda p: torch.optim.Adam(p)).evaluate(
        TrainState(model.param_tree(), None), *_grouped_arrays(snap_dir))
    assert mse == pytest.approx(ref, rel=1e-5)


def test_cli_grouped_data_parallel_and_resume(grouped_workdir):
    """grouped + --data-parallel (one rank without torchrun); a second run
    resumes from the checkpoints."""
    wd = grouped_workdir
    ckpt = str(wd / "ckpt_dp")
    base = ["train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
            "--model", "multiscale", "--group-batch", "4", "--point-batch", "64",
            "--data-parallel", "--ckpt-dir", ckpt]
    assert np.isfinite(run(*base, "--epochs", "3"))
    assert np.isfinite(run(*base, "--epochs", "2"))
    import torch.distributed as dist

    assert not dist.is_initialized()  # the CLI took down the group it made


def test_cli_grouped_layout_mismatch_is_loud(workdir):
    with pytest.raises(SystemExit, match="grouped"):
        run("train", "--config", str(workdir / "config.json"),
            "--data", str(workdir / "data.npz"), "--layout", "grouped", "--epochs", "1")


def test_cli_streaming_data_parallel(workdir):
    shard_dir = _shards(workdir, "dp_shards", 200)
    loss = run("train", "--config", str(workdir / "config.json"), "--data", shard_dir,
               "--epochs", "3", "--batch-size", "100", "--data-parallel")
    assert np.isfinite(loss)


def test_cli_grouped_sobolev_train(grouped_workdir, capsys):
    from nif_tpu_torch.data import GroupedDataset

    wd = grouped_workdir
    t, x, u, ju, _ = _wave(10, 64, 1, jac=True)
    snap_dir = str(wd / "snaps_sob")
    GroupedDataset.create_from_arrays(t, x, u, snap_dir, groups_per_file=4, target_jac=ju)
    ckpt = str(wd / "ckpt_sob")
    loss = run("train", "--config", str(wd / "config.json"), "--data", snap_dir,
               "--model", "multiscale", "--epochs", "8", "--lr", "2e-3",
               "--group-batch", "4", "--point-batch", "64",
               "--sobolev", "--w-jac", "0.1", "--ckpt-dir", ckpt)
    assert np.isfinite(loss)
    capsys.readouterr()
    mse = run("eval", "--config", str(wd / "config.json"), "--data", snap_dir,
              "--model", "multiscale", "--ckpt-dir", ckpt, "--sobolev")
    parsed = last_json(capsys)
    assert np.isfinite(mse)
    assert {"mse", "rel_l2", "jacobian_mse"} <= set(parsed)
    assert np.isfinite(parsed["jacobian_mse"])
    with pytest.raises(SystemExit, match="no Jacobian targets"):
        run("train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
            "--model", "multiscale", "--epochs", "1", "--group-batch", "4", "--sobolev")


def test_cli_grouped_hessian_train(grouped_workdir):
    from nif_tpu_torch.data import GroupedDataset

    wd = grouped_workdir
    t, x, u, ju, hu = _wave(6, 64, 2, jac=True, hess=True)
    snap_dir = str(wd / "snaps_hess")
    GroupedDataset.create_from_arrays(t, x, u, snap_dir, groups_per_file=3,
                                      target_jac=ju, target_hess=hu)
    loss = run("train", "--config", str(wd / "config.json"), "--data", snap_dir,
               "--model", "multiscale", "--epochs", "3", "--lr", "2e-3",
               "--group-batch", "3", "--point-batch", "32",
               "--sobolev", "--w-jac", "0.1", "--hessian", "--w-hess", "0.01",
               "--lbfgs", "3", "--ckpt-dir", str(wd / "ckpt_hess"))
    assert np.isfinite(loss)
    with pytest.raises(SystemExit, match="no second-order targets"):
        run("train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
            "--model", "multiscale", "--epochs", "1", "--group-batch", "4", "--hessian")


def _jax_params_into_port_ckpt(model_cls, cfg, ckpt_dir, seed=0):
    """JAX-drawn parameters, crossed into a port checkpoint (convert.py)."""
    import nif_tpu
    from nif_tpu_torch.convert import from_jax_params
    from nif_tpu_torch.training import Checkpointer

    jm = getattr(nif_tpu, model_cls)(cfg["cfg_shape_net"], cfg["cfg_parameter_net"], "float32")
    params = jm.init(jax.random.key(seed))
    tm = getattr(nif_tpu_torch, model_cls)(cfg["cfg_shape_net"], cfg["cfg_parameter_net"],
                                           "float32", device="cpu")
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    Checkpointer(ckpt_dir).save(0, tm.param_tree().state_dict())
    return jm, params


def test_cli_eval_hessian_metrics(grouped_workdir, capsys):
    """eval --hessian: per-term metrics including hessian_mse, against JAX's
    output_jacobian_hessian_grouped on the same (JAX-drawn) parameters;
    --hessian without a grouped dataset refuses; hess-only datasets report
    no jacobian_mse."""
    from nif_tpu.ops import output_jacobian_hessian_grouped
    from nif_tpu_torch.data import GroupedDataset

    wd = grouped_workdir
    t, x, u, ju, hu = _wave(6, 64, 3, jac=True, hess=True)
    snap_dir = str(wd / "snaps_hess_eval")
    GroupedDataset.create_from_arrays(t, x, u, snap_dir, groups_per_file=3,
                                      target_jac=ju, target_hess=hu)
    ckpt = str(wd / "ckpt_he")
    jm, params = _jax_params_into_port_ckpt("NIFMultiScale", GROUPED_CFG, ckpt)
    base = ["--config", str(wd / "config.json"), "--model", "multiscale", "--ckpt-dir", ckpt]
    run("eval", *base, "--data", snap_dir, "--hessian")
    out = last_json(capsys)
    assert set(out) >= {"mse", "rel_l2", "jacobian_mse", "hessian_mse"}
    _, _, hess = output_jacobian_hessian_grouped(jm, params, t, x)
    want = float(np.mean((np.asarray(hess) - hu) ** 2))
    assert out["hessian_mse"] == pytest.approx(want, rel=1e-4)
    np.savez(wd / "flat.npz", data=np.zeros((8, 3), np.float32))
    with pytest.raises(SystemExit, match="GroupedDataset"):
        run("eval", *base, "--data", str(wd / "flat.npz"), "--hessian")
    snap_ho = str(wd / "snaps_hess_only")
    GroupedDataset.create_from_arrays(t, x, u, snap_ho, groups_per_file=3, target_hess=hu)
    run("eval", *base, "--data", snap_ho, "--hessian")
    out2 = last_json(capsys)
    assert "jacobian_mse" not in out2
    assert out2["hessian_mse"] == pytest.approx(out["hessian_mse"], rel=1e-6)


def test_cli_grouped_residual_sampling(grouped_workdir):
    wd = grouped_workdir
    loss = run("train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
               "--model", "multiscale", "--epochs", "4", "--lr", "5e-3",
               "--group-batch", "4", "--point-batch", "16", "--point-sampling", "residual")
    assert np.isfinite(loss)


def test_cli_pointwise_layout_on_grouped_dir_rejected(grouped_workdir):
    wd = grouped_workdir
    with pytest.raises(SystemExit, match="GroupedDataset directory"):
        run("train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
            "--model", "multiscale", "--epochs", "1", "--layout", "pointwise")


def test_cli_grouped_lbfgs_finetune(grouped_workdir, capsys):
    wd = grouped_workdir
    loss = run("train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
               "--model", "multiscale", "--epochs", "3", "--lr", "2e-3",
               "--group-batch", "4", "--point-batch", "64", "--lbfgs", "15")
    assert "after grouped L-BFGS" in capsys.readouterr().out
    assert np.isfinite(loss)


LINEAR_CFG = {
    "cfg_shape_net": dict(GROUPED_CFG["cfg_shape_net"], connectivity="last_layer"),
    "cfg_parameter_net": GROUPED_CFG["cfg_parameter_net"],
    "mixed_policy": "float32",
}


def test_cli_export_artifacts(tmp_path, capsys):
    """export: a checkpoint serializes to standalone torch.export artifacts
    (the int8 shared-mesh, point-wise and grouped layouts) that load through
    serving.load_exported and match the live model."""
    from nif_tpu_torch.serving import load_exported, predict_shared_mesh
    from nif_tpu_torch.training import Checkpointer

    (tmp_path / "config.json").write_text(json.dumps(LINEAR_CFG))
    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
        LINEAR_CFG["cfg_shape_net"], LINEAR_CFG["cfg_parameter_net"], "float32", device="cpu")
    Checkpointer(str(tmp_path / "ckpt")).save(0, model.param_tree().state_dict())
    rng = np.random.default_rng(1)
    mesh = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    np.savez(tmp_path / "mesh.npz", x=mesh)
    t = np.linspace(0, 1, 4, dtype=np.float32)[:, None]
    base = ["--config", str(tmp_path / "config.json"), "--data", str(tmp_path / "mesh.npz"),
            "--model", "linear", "--ckpt-dir", str(tmp_path / "ckpt")]
    out8 = str(tmp_path / "art_int8.pt2")
    n = run("export", *base, "--out", out8, "--serving-layout", "shared_mesh_int8",
            "--group-batch", "4")
    assert n > 0 and os.path.getsize(out8) == n
    assert last_json(capsys)["layout"] == "shared_mesh_int8"
    got = load_exported(out8)(torch.from_numpy(t)).numpy()
    want = predict_shared_mesh(model, t, x=mesh)
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)
    assert rel < 2e-2, rel  # int8 quantization tolerance
    outp = str(tmp_path / "art_pw.pt2")
    run("export", *base, "--out", outp, "--batch-size", "32")
    inp = np.concatenate([np.repeat(t[:1], 32, 0), mesh[:32]], axis=1).astype(np.float32)
    with torch.inference_mode():
        want_p = model.apply(torch.from_numpy(inp)).numpy()
    np.testing.assert_allclose(load_exported(outp)(torch.from_numpy(inp)).numpy(), want_p,
                               atol=1e-5)
    outg = str(tmp_path / "art_grouped.pt2")
    run("export", *base, "--out", outg, "--serving-layout", "grouped",
        "--batch-size", "16", "--group-batch", "4")
    xg = torch.from_numpy(np.broadcast_to(mesh[:16], (4, 16, 1)).copy())
    with torch.inference_mode():
        want_g = model.apply_grouped(torch.from_numpy(t), xg)
    assert torch.equal(load_exported(outg)(torch.from_numpy(t), xg), want_g)


def test_cli_export_int8_needs_mesh(tmp_path):
    from nif_tpu_torch.training import Checkpointer

    cfg = json.loads(json.dumps(LINEAR_CFG))
    cfg["cfg_shape_net"]["units"] = 8
    cfg["cfg_parameter_net"]["units"] = 8
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
        cfg["cfg_shape_net"], cfg["cfg_parameter_net"], "float32", device="cpu")
    Checkpointer(str(tmp_path / "ckpt")).save(0, model.param_tree().state_dict())
    np.savez(tmp_path / "data.npz", data=np.zeros((8, 3), np.float32))
    base = ["export", "--config", str(tmp_path / "config.json"), "--model", "linear",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(tmp_path / "a.pt2"),
            "--serving-layout", "shared_mesh_int8"]
    with pytest.raises(SystemExit, match="serving mesh|'x'"):
        run(*base, "--data", str(tmp_path / "data.npz"))
    np.savez(tmp_path / "wide.npz", x=np.zeros((8, 2), np.float32))
    with pytest.raises(SystemExit, match="does not match"):
        run(*base, "--data", str(tmp_path / "wide.npz"))
    cfg2 = json.loads(json.dumps(cfg))
    cfg2["cfg_shape_net"]["connectivity"] = "full"
    (tmp_path / "config_ms.json").write_text(json.dumps(cfg2))
    ms = nif_tpu_torch.NIFMultiScale(cfg2["cfg_shape_net"], cfg2["cfg_parameter_net"],
                                     "float32", device="cpu")
    Checkpointer(str(tmp_path / "ckpt_ms")).save(0, ms.param_tree().state_dict())
    np.savez(tmp_path / "mesh1.npz", x=np.zeros((8, 1), np.float32))
    with pytest.raises(SystemExit, match="NIF-linear"):
        run("export", "--config", str(tmp_path / "config_ms.json"),
            "--data", str(tmp_path / "mesh1.npz"), "--model", "multiscale",
            "--ckpt-dir", str(tmp_path / "ckpt_ms"), "--out", str(tmp_path / "b.pt2"),
            "--serving-layout", "shared_mesh_int8")


# ---------------------------------------------------------------- parity
class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """The ArgumentParser nif_tpu.cli.main builds (caught at parse_args)."""
    from nif_tpu import cli as jax_cli

    def grab(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as caught:
            jax_cli.main([])
    return caught.value.args[0]


def _flags(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {opt: (act.default, act.choices, act.required, act.type,
                         type(act).__name__)
                   for act in p._actions for opt in act.option_strings if opt != "-h"}
            for name, p in sub.choices.items()}


def test_cli_parsers_take_every_flag_of_jax(monkeypatch):
    jax_flags, port_flags = _flags(_jax_parser(monkeypatch)), _flags(build_parser())
    assert set(port_flags) == set(jax_flags) == {"train", "eval", "export"}
    for cmd, flags in jax_flags.items():
        for opt, spec in flags.items():
            assert port_flags[cmd].get(opt) == spec, (cmd, opt)
        assert set(port_flags[cmd]) - set(flags) == {"--device"}
        assert port_flags[cmd]["--device"][0] == "cuda"


@pytest.mark.parametrize("layout", ["pointwise", "grouped"])
def test_cli_eval_matches_jax_eval_on_jax_parameters(request, capsys, layout):
    """JAX's parameters, written into a port checkpoint through convert.py:
    the port's ``eval`` prints JAX ``eval``'s mse and rel_l2 on the same
    data (rel 1e-5)."""
    from nif_tpu import cli as jax_cli
    from nif_tpu.training import Checkpointer as JaxCheckpointer

    if layout == "pointwise":
        wd = request.getfixturevalue("workdir")
        data, model, cls = str(wd / "data.npz"), "nif", "NIF"
        cfg = json.loads((wd / "config.json").read_text())
    else:
        wd = request.getfixturevalue("grouped_workdir")
        data, model, cls, cfg = str(wd / "snaps"), "multiscale", "NIFMultiScale", GROUPED_CFG
    jax_ckpt, port_ckpt = str(wd / "jax_ckpt"), str(wd / "port_ckpt")
    _, params = _jax_params_into_port_ckpt(cls, cfg, port_ckpt, seed=3)
    ck = JaxCheckpointer(jax_ckpt)
    ck.save(0, params)
    ck.wait()
    args = ["eval", "--config", str(wd / "config.json"), "--data", data, "--model", model,
            "--batch-size", "128"]
    jax_cli.main(args + ["--ckpt-dir", jax_ckpt])
    want = last_json(capsys)
    cli_main(args + ["--ckpt-dir", port_ckpt] + CPU)
    got = last_json(capsys)
    assert set(got) == set(want) == {"mse", "rel_l2"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


# The final loss of two ranks against one process, by policy. float32: the
# same global batches give the same loss up to f32 sum order (rel 1e-5).
# mixed_bfloat16: each rank rounds its partial sums to bf16 (the
# ParameterNet's weight gradients over its own groups) before the f32
# average, where one process rounds the whole batch's sum once. On this
# fixture that reads 1.05e-3, the same with the one process on 1, 2, 4 or 8
# threads; the bound leaves 5x for another CPU's sum order. Ranks that draw
# different batches after the first epoch move it 0.16-0.25.
DP_LOSS_REL = {"float32": 1e-5, "mixed_bfloat16": 5e-3}


@pytest.mark.parametrize("policy", sorted(DP_LOSS_REL))
def test_cli_data_parallel_on_two_ranks_from_torchrun_env(grouped_workdir, policy):
    """``train --data-parallel`` on two processes with torchrun's variables
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): the same
    global batches as one process, so the same final loss (``DP_LOSS_REL``
    of the policy); rank 0 alone prints and writes the checkpoint; ``python
    -m nif_tpu_torch`` runs the CLI."""
    from nif_tpu_torch.parallel.launch import free_port, rank_env

    wd = grouped_workdir
    (wd / "config.json").write_text(json.dumps(dict(GROUPED_CFG, mixed_policy=policy)))
    args = ["train", "--config", str(wd / "config.json"), "--data", str(wd / "snaps"),
            "--model", "multiscale", "--epochs", "3", "--lr", "5e-3",
            "--group-batch", "4", "--point-batch", "32", "--data-parallel"] + CPU
    one = cli_main(args + ["--ckpt-dir", str(wd / "ckpt_one")])
    port = free_port()
    procs = []
    for r in range(2):
        env = rank_env()
        env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nif_tpu_torch", *args, "--ckpt-dir", str(wd / "ckpt_two")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    final = [ln for ln in outs[0].splitlines() if ln.startswith("final loss: ")]
    assert len(final) == 1
    assert float(final[0].split()[-1]) == pytest.approx(one, rel=DP_LOSS_REL[policy])
    assert "final loss" not in outs[1]
    assert os.path.exists(wd / "ckpt_two" / "config.json")
