"""The command line for training, evaluation and export (counterpart of
``nif_tpu/cli.py``, with the same subcommands, flags, defaults and printed
lines)::

    python -m nif_tpu_torch train --config config.json --data data.npz \\
        --model multiscale --epochs 5000 --batch-size 2048 \\
        --ckpt-dir ./ckpt --lbfgs 500

    python -m nif_tpu_torch eval --config config.json --data data.npz \\
        --ckpt-dir ./ckpt

    python -m nif_tpu_torch export --config config.json --data snaps/ \\
        --model multiscale --ckpt-dir ./ckpt --out model.pt2 \\
        --serving-layout grouped --batch-size 32768 --group-batch 32

``--config`` is the reference-schema JSON ({cfg_shape_net,
cfg_parameter_net, mixed_policy}); ``--data`` an ``.npz`` with a ``data``
array of point-wise rows [params..., x..., u...], a shard directory from
``ShardedDataset`` or a ``GroupedDataset`` snapshot directory (the fused
kernels' path, auto-detected). Three differences from the JAX package's:
``--device`` (default ``cuda``) picks the device, so the tests can ask for
the CPU; checkpoints are the port's ``Checkpointer`` (``torch.save``) plus
``config.json``; ``export`` writes a ``torch.export`` artifact
(``serving.export_apply``).

``train --data-parallel`` trains on a mesh over the ranks of ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``;
without it the world is one process)::

    torchrun --nproc-per-node 8 --no-python python -m nif_tpu_torch train \\
        --data-parallel ...

Every rank reads the same data and takes its block of each batch; rank 0
prints and writes the checkpoints, and every rank reads them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["build_parser", "main"]

_MODELS = {
    "nif": "NIF",
    "multiscale": "NIFMultiScale",
    "linear": "NIFMultiScaleLastLayerParameterized",
}


def _say(*args) -> None:
    """Print on rank 0 only (every process without a process group)."""
    from .parallel.collectives import is_primary

    if is_primary():
        print(*args, flush=True)


def _build_model(args, device=None):
    import nif_tpu_torch

    cfg = nif_tpu_torch.NIFConfig.load(args.config)
    cls = getattr(nif_tpu_torch, _MODELS[args.model])
    model = cls(cfg.shape_net, cfg.parameter_net, cfg.mixed_policy,
                device=args.device if device is None else device)
    return model, cfg


def _load_pointwise(args, cfg):
    pi = cfg.parameter_net.input_dim
    si = cfg.shape_net.input_dim
    so = cfg.shape_net.output_dim
    data = np.load(args.data)["data"].astype(np.float32)
    inputs = data[:, : pi + si]
    targets = data[:, pi + si : pi + si + so]
    weight = data[:, -1] if data.shape[1] == pi + si + so + 1 else None
    return inputs, targets, weight


def _is_grouped_dir(path: str) -> bool:
    """A data directory is grouped (GroupedDataset snapshots) when its
    meta.json carries the grouped schema; point-wise shard dirs carry the
    column-split schema instead."""
    meta = os.path.join(path, "meta.json")
    if not os.path.isfile(meta):
        return False
    with open(meta) as f:
        return "n_groups" in json.load(f)


def _resolve_layout(args) -> str:
    if args.layout != "auto":
        if args.layout == "grouped" and not (
            os.path.isdir(args.data) and _is_grouped_dir(args.data)
        ):
            raise SystemExit(
                "--layout grouped needs a GroupedDataset directory (see "
                "nif_tpu_torch.data.GroupedDataset.create_from_arrays); got "
                f"{args.data!r}"
            )
        if args.layout == "pointwise" and os.path.isdir(args.data) \
                and _is_grouped_dir(args.data):
            raise SystemExit(
                f"{args.data!r} is a GroupedDataset directory — the "
                "point-wise layout streams ShardedDataset .npy shard "
                "directories; drop --layout pointwise (grouped is "
                "auto-detected) or convert the data"
            )
        return args.layout
    if os.path.isdir(args.data) and _is_grouped_dir(args.data):
        return "grouped"
    return "pointwise"


def _open_sharded(args, cfg):
    """Open a ShardedDataset directory and validate its column split
    against the model config."""
    from .data import ShardedDataset

    ds = ShardedDataset.from_dir(args.data)
    pi_si = cfg.parameter_net.input_dim + cfg.shape_net.input_dim
    so = cfg.shape_net.output_dim
    if (ds.n_feature, ds.n_target) != (pi_si, so):
        raise SystemExit(
            f"shard directory columns {ds.n_feature}/{ds.n_target} do not "
            f"match the config ({pi_si} inputs / {so} targets)"
        )
    return ds


def _mesh(args):
    """``--data-parallel``: a 1-D ``data`` mesh over torchrun's world (one
    process without it); else None."""
    if not getattr(args, "data_parallel", False):
        return None
    from .parallel import init_distributed, make_mesh

    init_distributed(device=args.device)
    return make_mesh()


def _save_final(args, model, state, mesh) -> None:
    """The params-only final marker and config.json, written by rank 0."""
    from .parallel.collectives import barrier, is_primary
    from .parallel.state import full_param_state
    from .training import Checkpointer
    from .training.checkpoint import FINAL_MARKER_OFFSET

    params = full_param_state(model)
    if is_primary():
        Checkpointer(args.ckpt_dir).save(int(state.step) + FINAL_MARKER_OFFSET, params)
        model.save_config(os.path.join(args.ckpt_dir, "config.json"))
    if mesh is not None:
        barrier()
    _say(f"saved final checkpoint + config to {args.ckpt_dir}")


def _train_streaming(args, mesh):
    """Streamed training over a ShardedDataset directory: fixed-size
    batches through the train step, global epoch accounting, checkpoints
    keyed by step; ``--lbfgs`` fine-tunes over the whole directory in
    chunks."""
    from .optimizers import get_optimizer
    from .training import CheckpointCallback, Trainer

    model, cfg = _build_model(args, None if mesh is None else mesh.device)
    ds = _open_sharded(args, cfg)
    if mesh is not None:
        # streamed batches bypass Trainer.fit's internal rounding: dim 0
        # must divide across the data axes, so round the batch size here
        from .parallel import batch_axis_size

        args.batch_size += (-args.batch_size) % batch_axis_size(mesh)
    trainer = Trainer(model, get_optimizer(args.optimizer, args.lr),
                      mesh=mesh, seed=args.seed)
    if args.ckpt_dir:
        state = trainer.init_or_restore(args.seed, args.ckpt_dir)
        if state.step:
            _say(f"resumed from step {state.step}")
    else:
        state = trainer.init(args.seed)
    ckpt_cb = (CheckpointCallback(args.ckpt_dir,
                                  every=max(args.epochs // 10, 1))
               if args.ckpt_dir else None)

    if ds.steps_per_epoch(args.batch_size) == 0:
        raise SystemExit(
            f"--batch-size {args.batch_size} exceeds every shard's row "
            "count: the streaming loop would take zero steps. Lower the "
            "batch size or recreate shards with more points per file."
        )

    # keep the loss on the device per step (reading it back would sync the
    # host every step); read once per epoch boundary for the print.
    cur_epoch, last_loss = -1, None
    for epoch, feats, targets, w in ds.iter_batches(
        args.batch_size, epochs=args.epochs, seed=args.seed
    ):
        if epoch != cur_epoch and cur_epoch >= 0:
            _say(f"epoch {cur_epoch:5d}  loss {float(last_loss):.6e}")
            if ckpt_cb is not None:
                ckpt_cb.on_epoch_end(trainer, state, cur_epoch, {})
        cur_epoch = epoch
        bi, bt, bw = trainer._put(
            feats, targets, w if ds.area_weight else None
        )
        state, loss = trainer._step(state, bi, bt, bw)
        last_loss = loss
    last_loss = float(last_loss)
    _say(f"epoch {cur_epoch:5d}  loss {last_loss:.6e}")
    if ckpt_cb is not None:
        ckpt_cb.on_epoch_end(trainer, state, cur_epoch, {})
        ckpt_cb.on_train_end(trainer, state)

    if args.lbfgs:
        # full-batch fine-tune over the WHOLE shard directory: the chunked
        # objective accumulates value/grad in fixed-size pieces, so only
        # one chunk's activations are ever live
        from .optimizers import LBFGS

        parts = [np.load(f) for f in ds.files]
        full = np.concatenate(parts, axis=0)
        nf, nt = ds.n_feature, ds.n_target
        weight = full[:, -1] if ds.area_weight else None
        tuner = LBFGS(model, inputs=full[:, :nf],
                      targets=full[:, nf:nf + nt], sample_weight=weight,
                      chunk_size=args.batch_size, mesh=mesh)
        tuner.minimize(rounds=1, max_iter=args.lbfgs)
        last_loss = float(tuner.history["loss"][-1]) if len(
            tuner.history["loss"]) else last_loss
        _say(f"after L-BFGS ({args.lbfgs} iters, chunked "
             f"{args.batch_size}): loss {last_loss:.6e}")
    _say(f"final loss: {last_loss:.6e}")
    if args.ckpt_dir:
        _save_final(args, model, state, mesh)
    return last_loss


def _train_grouped(args, mesh):
    """Streamed grouped-layout training: GroupedDataset group batches
    through ``GroupedTrainer`` (the fused train kernels on the card), with
    ``--data-parallel`` meshes, resumable checkpoints and exact zero-weight
    padding of tail group batches."""
    from .data import GroupedDataset, prefetch_to_device
    from .optimizers import get_optimizer
    from .training import CheckpointCallback, GroupedTrainer
    from .training.trainer import pad_batch, reg_row_weights

    model, cfg = _build_model(args, None if mesh is None else mesh.device)
    ds = GroupedDataset(args.data)
    group_batch = args.group_batch
    if mesh is not None:
        from .parallel import batch_axis_size

        group_batch += (-group_batch) % batch_axis_size(mesh)
    P = int(ds.meta["points_per_group"])
    point_batch = min(args.point_batch or P, P)
    sobolev = getattr(args, "sobolev", False)
    if sobolev and not ds.meta.get("sobolev"):
        raise SystemExit(
            "--sobolev: this grouped dataset has no Jacobian targets — "
            "create it with GroupedDataset.create_from_arrays(..., "
            "target_jac=...)"
        )
    hessian = getattr(args, "hessian", False)
    if hessian and not ds.meta.get("hessian"):
        raise SystemExit(
            "--hessian: this grouped dataset has no second-order targets "
            "— create it with GroupedDataset.create_from_arrays(..., "
            "target_hess=...)"
        )

    trainer = GroupedTrainer(model, get_optimizer(args.optimizer, args.lr),
                             mesh=mesh, seed=args.seed,
                             w_jac=getattr(args, "w_jac", 1.0),
                             w_hess=getattr(args, "w_hess", 1.0))
    if args.ckpt_dir:
        state = trainer.init_or_restore(args.seed, args.ckpt_dir)
        if state.step:
            _say(f"resumed from step {state.step}")
    else:
        state = trainer.init(args.seed)
    ckpt_cb = (CheckpointCallback(args.ckpt_dir,
                                  every=max(args.epochs // 10, 1))
               if args.ckpt_dir else None)
    if ds.steps_per_epoch(group_batch, drop_remainder=False) == 0:
        raise SystemExit("the grouped dataset is empty")

    use_reg = trainer.use_reg and model.has_regularization
    cur_epoch, last_loss = -1, None

    # streamed residual sampling: score each loaded shard window against
    # the CURRENT params (read through this mutable box; the prefetch
    # lookahead means scores can lag the step loop by a batch, which is
    # harmless for a sampling distribution)
    state_box = [None]
    sampler = None
    if getattr(args, "point_sampling", "uniform") == "residual":
        sampler = lambda t_, x_, u_: trainer.residual_probs(  # noqa: E731
            state_box[0], t_, x_, u_)

    def host_batches():
        """Dim-check + exact tail padding on host, ready for transfer."""
        checked = False
        for batch in ds.iter_batches(
            group_batch=group_batch, point_batch=point_batch,
            epochs=args.epochs, seed=args.seed, with_jac=sobolev,
            with_hess=hessian, point_sampler=sampler,
        ):
            epoch, bt, bx, bu, bw = batch[:5]
            bju = batch[5] if (sobolev or hessian) else None
            bhu = batch[6] if hessian else None
            if not checked:
                pi = cfg.parameter_net.input_dim
                si, so = cfg.shape_net.input_dim, cfg.shape_net.output_dim
                if (bt.shape[1], bx.shape[2], bu.shape[2]) != (pi, si, so):
                    raise SystemExit(
                        f"grouped dataset dims t/x/u = {bt.shape[1]}/"
                        f"{bx.shape[2]}/{bu.shape[2]} do not match the "
                        f"config ({pi}/{si}/{so})"
                    )
                checked = True
            b = bt.shape[0]
            rw = None
            if b < group_batch or bw is not None:
                # exact zero-weight padding: tail batches keep one shape
                # and train every group (trainer.pad_batch)
                opts = [a for a in (bju, bhu) if a is not None]
                arrs = (bt, bx, bu) + tuple(opts)
                arrs, w_rows = pad_batch(arrs, None, b, group_batch)
                bt, bx, bu = arrs[:3]
                it = iter(arrs[3:])
                if bju is not None:
                    bju = next(it)
                if bhu is not None:
                    bhu = next(it)
                pb = bx.shape[1]
                bw = (np.broadcast_to(w_rows[:, None], (group_batch, pb))
                      if bw is None
                      else np.concatenate(
                          [bw, np.zeros((group_batch - b, pb), bw.dtype)]
                      ) * w_rows[:, None])
                bw = np.ascontiguousarray(bw, np.float32)
                if use_reg:
                    rw = reg_row_weights(b, group_batch)
            yield epoch, bt, bx, bu, bw, rw, bju, bhu

    # double-buffer: the NEXT batch copies to the device while the current
    # step runs (only this rank's block of it under a mesh)
    state_box[0] = state
    for epoch, bt, bx, bu, bw, rw, bju, bhu in prefetch_to_device(
        host_batches(), device=model.device, mesh=mesh
    ):
        if epoch != cur_epoch and cur_epoch >= 0:
            _say(f"epoch {cur_epoch:5d}  loss {float(last_loss):.6e}")
            if ckpt_cb is not None:
                ckpt_cb.on_epoch_end(trainer, state, cur_epoch, {})
        cur_epoch = epoch
        state, loss = trainer.step(state, bt, bx, bu, bw, rw,
                                   target_jac=bju, target_hess=bhu)
        state_box[0] = state
        last_loss = loss
    last_loss = float(last_loss)
    _say(f"epoch {cur_epoch:5d}  loss {last_loss:.6e}")
    _say(f"compute path: {trainer.history.get('path', '?')}"
         + (f" ({trainer.history['path_reason']})"
            if "path_reason" in trainer.history else ""))
    if ckpt_cb is not None:
        ckpt_cb.on_epoch_end(trainer, state, cur_epoch, {})
        ckpt_cb.on_train_end(trainer, state)

    if args.lbfgs:
        # chunked grouped-layout L-BFGS fine-tune over the WHOLE shard
        # directory: the streamed trainer's objective, accumulated group
        # chunk by group chunk (one fused kernel launch a chunk on the card)
        from .optimizers import GroupedLBFGS

        parts = [np.load(f) for f in ds.files]
        tt = np.concatenate([p["t"] for p in parts])
        xx = np.concatenate([p["x"] for p in parts])
        uu = np.concatenate([p["u"] for p in parts])
        ww = (np.concatenate([p["w"] for p in parts])
              if ds.meta.get("weighted") else None)
        jj = (np.concatenate([p["ju"] for p in parts]) if sobolev else None)
        hh = (np.concatenate([p["hu"] for p in parts]) if hessian else None)
        tuner = GroupedLBFGS(model, tt, xx, uu, weight=ww, target_jac=jj,
                             target_hess=hh,
                             w_jac=getattr(args, "w_jac", 1.0),
                             w_hess=getattr(args, "w_hess", 1.0),
                             chunk_groups=group_batch, mesh=mesh)
        tuner.minimize(rounds=1, max_iter=args.lbfgs)
        if len(tuner.history["loss"]):
            last_loss = float(tuner.history["loss"][-1])
        _say(f"after grouped L-BFGS ({args.lbfgs} iters, chunked "
             f"{group_batch} groups): loss {last_loss:.6e}")

    _say(f"final loss: {last_loss:.6e}")
    if args.ckpt_dir:
        _save_final(args, model, state, mesh)
    return last_loss


def _cmd_train(args):
    import torch.distributed as dist

    own_group = getattr(args, "data_parallel", False) and not dist.is_initialized()
    try:
        return _train(args, _mesh(args))
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, mesh):
    from .optimizers import LBFGS, get_optimizer
    from .parallel.collectives import is_primary
    from .training import CheckpointCallback, LossPrintingCallback, Trainer

    layout = _resolve_layout(args)
    if layout == "grouped":
        return _train_grouped(args, mesh)
    if getattr(args, "sobolev", False):
        raise SystemExit(
            "--sobolev needs the grouped layout: create the dataset with "
            "GroupedDataset.create_from_arrays(..., target_jac=...) and "
            "pass its directory (--layout grouped)"
        )
    if os.path.isdir(args.data):
        return _train_streaming(args, mesh)
    model, cfg = _build_model(args, None if mesh is None else mesh.device)
    inputs, targets, weight = _load_pointwise(args, cfg)

    trainer = Trainer(model, get_optimizer(args.optimizer, args.lr), mesh=mesh, seed=args.seed)
    if args.ckpt_dir:
        state = trainer.init_or_restore(args.seed, args.ckpt_dir)
        if state.step:
            _say(f"resumed from step {state.step}")
    else:
        state = trainer.init(args.seed)

    callbacks = ([LossPrintingCallback(every=max(args.epochs // 20, 1))]
                 if is_primary() else [])
    if args.ckpt_dir:
        callbacks.append(
            CheckpointCallback(args.ckpt_dir, every=max(args.epochs // 10, 1))
        )
    state = trainer.fit(
        state,
        inputs,
        targets,
        sample_weight=weight,
        epochs=args.epochs,
        batch_size=args.batch_size,
        callbacks=callbacks,
    )
    mse = trainer.evaluate(state, inputs, targets, sample_weight=weight)
    _say(f"train MSE: {mse:.6e}")

    if args.lbfgs:
        tuner = LBFGS(model, inputs=inputs, targets=targets, sample_weight=weight, mesh=mesh)
        tuner.minimize(rounds=1, max_iter=args.lbfgs)
        # same (weighted) metric as the pre-L-BFGS line, so the two are
        # actually comparable
        mse = trainer.evaluate(state, inputs, targets, sample_weight=weight)
        _say(f"after L-BFGS: MSE {mse:.6e}")

    if args.ckpt_dir:
        _save_final(args, model, state, mesh)
    return mse


def _restore_params(ckpt_dir: str, model):
    """Load trained params from ``ckpt_dir``'s latest checkpoint into
    ``model``: a params-only payload (the final marker) or the full-state
    ``{params, opt_state, step}`` layout interrupted training leaves behind.
    Shared by ``eval`` and ``export``."""
    from .parallel.state import load_param_state
    from .training import Checkpointer

    try:
        payload = Checkpointer(ckpt_dir).restore(map_location=model.device)
        if isinstance(payload, dict) and set(payload) == {"params", "opt_state", "step"}:
            payload = payload["params"]
        load_param_state(model, payload)
    except Exception as e:
        raise RuntimeError(
            f"could not restore checkpoint from {ckpt_dir!r} as either a "
            "params-only or a full-state payload"
        ) from e
    return model.param_tree()


def _cmd_eval(args):
    import torch

    from .serving import predict
    from .utils import rel_l2

    if not args.ckpt_dir:
        raise SystemExit("eval requires --ckpt-dir (a trained checkpoint)")
    model, cfg = _build_model(args)
    layout = _resolve_layout(args)
    streaming = os.path.isdir(args.data)
    if not streaming:
        inputs, targets, _ = _load_pointwise(args, cfg)
    _restore_params(args.ckpt_dir, model)
    dev = model.device
    if layout == "grouped":
        # grouped snapshots: full-P group chunks through apply_grouped (K1
        # on the card), the same accumulated metric GroupedTrainer.evaluate
        # computes, plus rel-L2
        from .data import GroupedDataset

        ds = GroupedDataset(args.data)
        P = int(ds.meta["points_per_group"])
        # clamp to what a batch can actually hold: iter_batches never
        # crosses shard files
        gb = max(1, min(4_000_000 // max(P, 1),
                        int(ds.meta["n_groups"]),
                        int(ds.meta.get("groups_per_file",
                                        ds.meta["n_groups"]))))
        sobolev = getattr(args, "sobolev", False)
        if sobolev and not ds.meta.get("sobolev"):
            raise SystemExit(
                "--sobolev: this grouped dataset has no Jacobian targets"
            )
        hessian = getattr(args, "hessian", False)
        if hessian and not ds.meta.get("hessian"):
            raise SystemExit(
                "--hessian: this grouped dataset has no second-order "
                "targets"
            )
        # --hessian also reports jacobian_mse when the dataset carries
        # first-order targets (hess-only datasets are legal: iter_batches
        # then yields ju=None)
        sobolev = sobolev or (hessian and bool(ds.meta.get("sobolev")))
        if hessian:
            # second-order metrics ride the fused evaluation kernel (K7)
            from .ops import output_jacobian_hessian_grouped

            def apply_fn(t, x):
                return output_jacobian_hessian_grouped(model, t, x)
        elif sobolev:
            from .ops import output_and_jacobian_grouped

            def apply_fn(t, x):
                return (*output_and_jacobian_grouped(model, t, x), None)
        else:
            def apply_fn(t, x):
                return model.apply_grouped(t, x), None, None
        se = st = n_el = 0.0
        sj = n_j = 0.0
        sh = n_h = 0.0
        for batch in ds.iter_batches(
            group_batch=gb, point_batch=None, epochs=1, seed=0,
            with_jac=sobolev, with_hess=hessian,
        ):
            _, bt, bx, bu = batch[:4]
            bju = batch[5] if sobolev else None
            bhu = batch[6] if hessian else None
            with torch.no_grad():
                pred, jac, hess = apply_fn(torch.as_tensor(bt, device=dev),
                                           torch.as_tensor(bx, device=dev))
            d = pred.double().cpu().numpy() - bu.astype(np.float64)
            se += float(np.sum(d * d))
            st += float(np.sum(bu.astype(np.float64) ** 2))
            n_el += bu.size
            if bju is not None:
                dj = jac.double().cpu().numpy() - bju.astype(np.float64)
                sj += float(np.sum(dj * dj))
                n_j += bju.size
            if bhu is not None:
                dh = hess.double().cpu().numpy() - bhu.astype(np.float64)
                sh += float(np.sum(dh * dh))
                n_h += bhu.size
        mse = se / max(n_el, 1)
        rl2 = float(np.sqrt(se / max(st, 1e-300)))
        if sobolev or hessian:
            out = {"mse": mse, "rel_l2": rl2}
            if sobolev:
                out["jacobian_mse"] = sj / max(n_j, 1)
            if hessian:
                out["hessian_mse"] = sh / max(n_h, 1)
            print(json.dumps(out))
            return mse
    elif getattr(args, "sobolev", False) or getattr(args, "hessian", False):
        raise SystemExit(
            "--sobolev/--hessian eval needs a GroupedDataset directory "
            "with stored derivative targets"
        )
    elif streaming:
        # accumulate the error/target sums shard by shard: same metrics, no
        # full-dataset materialization
        ds = _open_sharded(args, cfg)
        bs = args.batch_size
        se = st = n_el = 0.0
        for _, feats, targets, _w in ds.iter_batches(
            bs, epochs=1, shuffle=False, drop_remainder=False
        ):
            with torch.inference_mode():
                pred = model.apply(torch.as_tensor(feats, device=dev))
            d = pred.double().cpu().numpy() - targets.astype(np.float64)
            se += float(np.sum(d * d))
            st += float(np.sum(targets.astype(np.float64) ** 2))
            n_el += targets.size
        mse = se / max(n_el, 1)
        rl2 = float(np.sqrt(se / max(st, 1e-300)))
    else:
        pred = predict(model, inputs, batch_size=args.batch_size)
        mse = float(np.mean((pred - targets) ** 2))
        rl2 = float(rel_l2(torch.from_numpy(pred), torch.from_numpy(targets)))
    print(json.dumps({"mse": mse, "rel_l2": rl2}))
    return mse


def _serving_mesh(args, cfg):
    """The fixed coordinate mesh an int8 shared-mesh export quantizes
    against: a GroupedDataset directory's first-group ``x``, or an
    ``.npz`` carrying an explicit ``x [P, si]`` array."""
    si = cfg.shape_net.input_dim
    if os.path.isdir(args.data):
        if not _is_grouped_dir(args.data):
            raise SystemExit(
                "--serving-layout shared_mesh_int8 needs a GroupedDataset "
                "directory (or an .npz with an 'x' array) for the serving "
                "mesh"
            )
        from .data import GroupedDataset

        ds = GroupedDataset(args.data)
        with np.load(ds.files[0]) as z:
            x = np.asarray(z["x"][0])
    else:
        with np.load(args.data) as blob:
            if "x" not in blob:
                raise SystemExit(
                    "--serving-layout shared_mesh_int8: pass the serving "
                    "mesh as an .npz with an 'x' [P, si] array or a "
                    "GroupedDataset directory (the decode quantizes phi(x) "
                    "for ONE fixed mesh)"
                )
            x = np.asarray(blob["x"])
    x = np.asarray(x, np.float32)
    if x.ndim == 1 and si == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[1] != si:
        # a silent reshape(-1, si) would reinterpret a wrong-width mesh
        # as garbage points and bake it into the artifact
        raise SystemExit(
            f"--serving-layout shared_mesh_int8: serving mesh shape "
            f"{x.shape} does not match [P, si={si}] from the config"
        )
    return x


def _cmd_export(args):
    """Serialize a trained checkpoint to a standalone ``torch.export``
    serving artifact (``serving.export_apply``), with the int8 ROM decode as
    a layout of its own."""
    from .serving import export_apply

    if not args.ckpt_dir:
        raise SystemExit("export requires --ckpt-dir (a trained checkpoint)")
    model, cfg = _build_model(args)
    _restore_params(args.ckpt_dir, model)

    int8_pack = None
    if args.serving_layout == "shared_mesh_int8":
        from .compression import quantize_shared_mesh

        if not hasattr(model, "x_to_phi"):
            raise SystemExit(
                "--serving-layout shared_mesh_int8 quantizes phi(mesh) and "
                "needs the NIF-linear model (--model linear); "
                f"--model {args.model!r} has no shared-mesh decode"
            )
        mesh_x = _serving_mesh(args, cfg)
        int8_pack = quantize_shared_mesh(model, mesh_x)
    blob = export_apply(
        model,
        batch_size=args.batch_size,
        path=args.out,
        layout=args.serving_layout,
        group_batch=args.group_batch,
        int8_pack=int8_pack,
    )
    out = {"path": args.out, "layout": args.serving_layout,
           "bytes": len(blob)}
    print(json.dumps(out))
    return len(blob)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nif_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", required=True, help="reference-schema JSON")
    common.add_argument("--data", required=True, help=".npz with 'data' array")
    common.add_argument("--model", choices=sorted(_MODELS), default="nif")
    common.add_argument("--batch-size", type=int, default=2048)
    common.add_argument("--ckpt-dir", default=None)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument(
        "--layout", choices=["auto", "pointwise", "grouped"], default="auto",
        help="grouped = snapshot-structured GroupedDataset directory "
        "through the fused-kernel fast path (auto-detected from meta.json)",
    )
    common.add_argument("--device", default="cuda",
                        help="cuda (the default; under --data-parallel the local "
                             "rank's card) or cpu")

    tp = sub.add_parser("train", parents=[common])
    tp.add_argument("--epochs", type=int, default=1000)
    tp.add_argument("--lr", type=float, default=1e-3)
    tp.add_argument("--optimizer", default="adam",
                    choices=["adam", "adabelief", "lion"])
    tp.add_argument("--lbfgs", type=int, default=0,
                    help="L-BFGS fine-tune iterations after Adam")
    tp.add_argument("--data-parallel", action="store_true",
                    help="train on a mesh over torchrun's ranks (one process "
                         "without torchrun)")
    tp.add_argument("--group-batch", type=int, default=8,
                    help="groups per step (grouped layout)")
    tp.add_argument("--point-batch", type=int, default=4096,
                    help="point subsample per group per step (grouped layout)")
    tp.add_argument("--sobolev", action="store_true",
                    help="train on Jacobian targets too (grouped layout; "
                         "dataset must carry target_jac)")
    tp.add_argument("--w-jac", type=float, default=1.0,
                    help="jacobian MSE term weight under --sobolev")
    tp.add_argument("--hessian", action="store_true",
                    help="also train on second-order targets (grouped "
                         "layout; dataset must carry target_hess)")
    tp.add_argument("--w-hess", type=float, default=1.0,
                    help="hessian MSE term weight under --hessian")
    tp.add_argument("--point-sampling", choices=["uniform", "residual"],
                    default="uniform",
                    help="residual = hard-point mining: per-shard point "
                         "subsamples proportional to the current squared "
                         "residual (grouped layout)")
    tp.set_defaults(fn=_cmd_train)

    ep = sub.add_parser("eval", parents=[common])
    ep.add_argument("--hessian", action="store_true",
                    help="also report hessian_mse from the grouped "
                         "dataset's stored target_hess (the fused "
                         "second-order evaluation kernel on the card)")
    ep.add_argument("--sobolev", action="store_true",
                    help="also report jacobian_mse against the grouped "
                         "dataset's stored target_jac")
    ep.set_defaults(fn=_cmd_eval)

    xp = sub.add_parser(
        "export", parents=[common],
        help="serialize a trained checkpoint to a standalone torch.export "
             "serving artifact")
    xp.add_argument("--out", required=True, help="artifact output path")
    xp.add_argument(
        "--serving-layout",
        choices=["pointwise", "grouped", "shared_mesh", "shared_mesh_int8"],
        default="pointwise",
        help="exported signature (see serving.export_apply); "
             "shared_mesh_int8 bakes an int8-quantized phi(mesh) pack in "
             "and decodes int8 x int8 -> int32 (--data supplies the fixed "
             "serving mesh)")
    xp.add_argument("--group-batch", type=int, default=1,
                    help="group/snapshot batch of the exported signature")
    xp.set_defaults(fn=_cmd_export)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
