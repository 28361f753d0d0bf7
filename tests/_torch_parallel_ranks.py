"""What each rank of ``tests/test_torch_parallel.py``'s two-rank gloo
cluster runs (``nif_tpu_torch.parallel.launch.run_ranks``). It imports the
port only: the test process holds the JAX side and compares.

``scenarios(workdir)`` runs every case in one launch and returns a JSON
tree of its numbers; the inputs come from :func:`inputs` (numpy, seeded),
which the test process calls too, and the JAX parameters from
``workdir/params.npz``."""
import os

import numpy as np

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.1}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0}
LR = 1e-3


def inputs(G, P, seed, jac=False):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((G, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 2)).astype(np.float32)
    u = rng.standard_normal((G, P, 1)).astype(np.float32)
    if not jac:
        return t, x, u
    ju = rng.standard_normal((G, P, 1, 2)).astype(np.float32)
    h = rng.standard_normal((G, P, 1, 2, 2)).astype(np.float32)
    return t, x, u, ju, 0.5 * (h + h.transpose(0, 1, 2, 4, 3))


def rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 1)).astype(np.float32))


def _flat(params):
    return {k: np.asarray(v).tolist() for k, v in params.items()}


def _state_dict(workdir):
    import torch

    with np.load(os.path.join(workdir, "params.npz")) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k]) for k in z.files}


def _trainer(mesh, cls="GroupedTrainer", optimizer=None, **kw):
    import torch

    import nif_tpu_torch
    from nif_tpu_torch import training

    dev = "cpu" if mesh is None else mesh.device
    model = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device=dev)
    make = optimizer or (lambda p: torch.optim.Adam(p, lr=LR))
    return getattr(training, cls)(model, make, mesh=mesh, seed=4, **kw)


def _jax_init(tr, workdir):
    """Fresh state, then the JAX parameters (a split head takes its rows)."""
    from nif_tpu_torch.parallel.state import load_param_state

    state = tr.init(0)
    load_param_state(tr.model, _state_dict(workdir))
    return state


def _params(model):
    from nif_tpu_torch.parallel.state import local_params

    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v

    walk(local_params(model), "")
    return out


def helpers():
    import torch
    import torch.distributed as dist

    from nif_tpu_torch import parallel

    mesh = parallel.make_mesh()
    tp = parallel.make_mesh(axis_names=("data", "model"), mesh_shape=(1, 2))
    hy = parallel.make_hybrid_mesh(("data",))
    hy2 = parallel.make_hybrid_mesh(("data", "model"), (1, 2))
    ones = parallel.put_batch(np.ones((16, 3), np.float32), mesh)
    tree = parallel.shard_batch({"a": np.ones((8, 2), np.float32),
                                 "b": [np.arange(8.0)]}, mesh)
    total = torch.tensor([float(ones.sum())])
    dist.all_reduce(total)
    differs = False
    try:
        parallel.put_replicated({"w": torch.full((3,), float(dist.get_rank()))}, mesh)
    except RuntimeError:
        differs = True
    same = parallel.put_replicated({"w": torch.ones(3)}, mesh) is not None
    uneven = False
    try:
        parallel.put_batch(np.ones((5, 3), np.float32), mesh)
    except ValueError:
        uneven = True
    return {
        "mesh": [list(mesh.axis_names), mesh.shape, mesh.size, mesh.backend],
        "tp": [list(tp.axis_names), tp.shape, parallel.batch_axes(tp),
               parallel.batch_axis_size(tp), tp.coordinate("model")],
        "hybrid": [list(hy.axis_names), hy.shape, list(parallel.batch_axes(hy)),
                   parallel.batch_axis_size(hy)],
        "hybrid2": [list(hy2.axis_names), hy2.shape],
        "block": [list(ones.shape), float(total), list(parallel.batch_block(mesh))],
        "placed_again": parallel.put_batch(ones, mesh) is ones,
        "tree": [list(tree["a"].shape), tree["b"][0].tolist()],
        "replicated_differs_raises": differs, "replicated_same": same,
        "uneven_raises": uneven,
        "eval_block": [[parallel.eval_block(mesh, n).start, parallel.eval_block(mesh, n).stop]
                       for n in (7, 8)],
    }


def dp_steps(workdir):
    from nif_tpu_torch.parallel import make_mesh

    tr = _trainer(make_mesh())
    state = _jax_init(tr, workdir)
    t, x, u = inputs(4, 32, 11)
    losses = []
    for _ in range(3):
        state, loss = tr.step(state, t, x, u)
        losses.append(float(loss))
    return {"losses": losses, "params": _flat(_params(tr.model))}


def dp_fit(workdir):
    from nif_tpu_torch.parallel import make_mesh

    t, x, u = inputs(8, 32, 12)
    out = {}
    for name, kw in (("dp", {}), ("tp", {"shard_model_axis": True})):
        mesh = make_mesh(**({} if name == "dp" else
                            {"axis_names": ("data", "model"), "mesh_shape": (1, 2)}))
        tr = _trainer(mesh, **kw)
        state = _jax_init(tr, workdir)
        tr.fit(state, t, x, u, epochs=3, group_batch=4, point_batch=16)
        out[name] = tr.history["loss"]
        out[name + "_metrics"] = tr.evaluate_metrics(state, t, x, u)
        if name == "tp":
            out["tp_head_shape"] = list(tr.model.pnet.params["last"]["w"].shape)
            out["tp_moment_shape"] = list(
                state.opt_state.state[tr.model.pnet.params["last"]["w"]]["exp_avg"].shape)
    return out


def pointwise_tp_zero(workdir):
    from nif_tpu_torch.parallel import make_mesh
    from nif_tpu_torch.parallel.zero import ZeroOneOptimizer

    inp, tgt = rows(96, 13)
    out = {}
    for name, mesh, kw in (
            ("none", None, {}),
            ("dp", make_mesh(), {}),
            ("tp_zero", make_mesh(axis_names=("data", "model"), mesh_shape=(1, 2)),
             {"shard_model_axis": True, "shard_opt_state": True}),
            ("zero", make_mesh(), {"shard_opt_state": True})):
        tr = _trainer(mesh, "Trainer", **kw)
        state = _jax_init(tr, workdir)
        tr.fit(state, inp, tgt, epochs=3, batch_size=32)
        out[name] = tr.history["loss"]
        opt = state.opt_state
        if isinstance(opt, ZeroOneOptimizer):
            out[name + "_owned"] = [len(opt.owned), len(opt.params)]
    return out


def tp_checkpoint(workdir):
    import torch

    from nif_tpu_torch.parallel import make_mesh
    from nif_tpu_torch.training import CheckpointCallback, Checkpointer

    mesh = make_mesh(axis_names=("data", "model"), mesh_shape=(1, 2))
    t, x, u = inputs(8, 32, 14)
    ckpt = os.path.join(workdir, "tp_ckpt")
    tr = _trainer(mesh, shard_model_axis=True)
    state = _jax_init(tr, workdir)
    state = tr.fit(state, t, x, u, epochs=3, group_batch=4, point_batch=16,
                   callbacks=[CheckpointCallback(ckpt, every=1)])
    saved = Checkpointer(ckpt).restore()
    head = tr.model.pnet.params["last"]["w"].detach().clone()
    tr2 = _trainer(mesh, shard_model_axis=True)
    restored = tr2.init_or_restore(7, ckpt)
    w = tr2.model.pnet.params["last"]["w"]
    moments = restored.opt_state.state[w]
    ref_moments = state.opt_state.state[tr.model.pnet.params["last"]["w"]]
    head_equal = bool(torch.equal(head, w))
    moments_equal = bool(torch.equal(moments["exp_avg"], ref_moments["exp_avg"])
                         and torch.equal(moments["exp_avg_sq"], ref_moments["exp_avg_sq"]))
    tr2.fit(restored, t, x, u, epochs=2, group_batch=4, point_batch=16)
    return {
        "step": [int(state.step), int(restored.step)],
        "saved_head_shape": list(saved["params"]["pnet.last.w"].shape),
        "saved_moment_shape": list(saved["opt_state"]["state"][
            [i for i, (p, _) in enumerate(tr.model.param_items())
             if p == ("pnet", "last", "w")][0]]["exp_avg"].shape),
        "head_equal": head_equal,
        "moments_equal": moments_equal,
        "continued": tr2.history["loss"],
    }


def meshed_evaluation(workdir):
    from nif_tpu_torch.parallel import make_mesh

    t, x, u, ju, hu = inputs(7, 16, 15, jac=True)
    kw = dict(w_value=1.0, w_jac=0.3, w_hess=0.05)
    out = {}
    for name, mesh in (("none", None), ("mesh", make_mesh()),
                       ("tp", make_mesh(axis_names=("data", "model"), mesh_shape=(1, 2)))):
        tr = _trainer(mesh, **kw, **({"shard_model_axis": True} if name == "tp" else {}))
        state = _jax_init(tr, workdir)
        out[name] = {
            "hess": tr.evaluate_sobolev(state, t, x, u, ju, group_batch=3, target_hess=hu),
            "jac": tr.evaluate_sobolev(state, t, x, u, ju, group_batch=3),
            "metrics": tr.evaluate_metrics(state, t, x, u, group_batch=2),
        }
    return out


def resident(workdir):
    from nif_tpu_torch.parallel import make_mesh

    t, x, u = inputs(4, 16, 16)
    out = {}
    for name, mesh in (("none", None), ("mesh", make_mesh())):
        tr = _trainer(mesh)
        state = _jax_init(tr, workdir)
        tr.fit_resident(state, t, x, u, epochs=3, group_batch=4, point_batch=16)
        out[name] = tr.history["loss"]
    return out


def lbfgs(workdir):
    from nif_tpu_torch.optimizers import GroupedLBFGS, LBFGS
    from nif_tpu_torch.parallel import make_mesh

    inp, tgt = rows(50, 17)
    t, x, u = inputs(5, 16, 18)
    out = {}
    for name, mesh in (("none", None), ("mesh", make_mesh())):
        tr = _trainer(mesh)
        _jax_init(tr, workdir)
        opt = LBFGS(tr.model, inputs=inp, targets=tgt, chunk_size=15, mesh=mesh)
        opt.minimize(max_iter=4)
        tr2 = _trainer(mesh)
        _jax_init(tr2, workdir)
        gopt = GroupedLBFGS(tr2.model, t, x, u, chunk_groups=2, mesh=mesh)
        gopt.minimize(max_iter=4)
        out[name] = {"pointwise": opt.history["loss"], "grouped": gopt.history["loss"],
                     "counts": gopt.counts}
    return out


def scenarios(workdir):
    import torch

    torch.manual_seed(0)
    return {name: fn(workdir) for name, fn in (
        ("dp_steps", dp_steps), ("dp_fit", dp_fit), ("pointwise", pointwise_tp_zero),
        ("tp_checkpoint", tp_checkpoint), ("evaluation", meshed_evaluation),
        ("resident", resident), ("lbfgs", lbfgs))} | {"helpers": helpers()}
