"""What each rank of ``tests/test_torch_lbfgs_row_parallel.py``'s gloo
clusters runs (``nif_tpu_torch.parallel.launch.run_ranks``): ``LBFGS`` and
``GroupedLBFGS`` on a model whose hypernetwork head is split row-parallel
over the mesh's ``'model'`` axis. It imports the port only; the test
process holds the JAX side and the unsplit run, and compares.

The parameters come from ``workdir/params.npz`` (JAX-drawn, carried across
whole; each rank then keeps its rows of the head), the data from
:func:`data` (numpy, seeded), which the test process calls too."""
import os

import numpy as np

CFG_S = {"input_dim": 2, "output_dim": 1, "units": 16, "nlayers": 1,
         "activation": "sine", "use_resblock": False, "omega_0": 30.0,
         "connectivity": "full", "weight_init_factor": 0.1}
CFG_P = {"input_dim": 1, "latent_dim": 4, "units": 16, "nlayers": 1,
         "activation": "swish", "use_resblock": False, "omega_0": 30.0}
ITERS = 5
#: the chunk of the meshed objectives: each rank its block of every chunk
CHUNK_ROWS, CHUNK_GROUPS = 24, 2


def data():
    """``(rows, targets, t, x, u)``: 48 point-wise rows ``[t, x0, x1]`` and
    a grouped batch of 4 groups of 16 points."""
    rng = np.random.default_rng(31)
    t = rng.standard_normal((4, 1)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, 16, 2)).astype(np.float32)
    u = (np.sin(3 * x[..., :1]) * np.cos(t[:, None, :])).astype(np.float32)
    rows = rng.uniform(-1, 1, (48, 3)).astype(np.float32)
    targets = np.sin(2 * rows[:, 1:2] + rows[:, :1]).astype(np.float32)
    return rows, targets, t, x, u


def model(params, mesh=None):
    """The port model on the CPU with ``params`` (a flat ``{"pnet/...":
    array}``), its head split over ``mesh``'s model axis when given."""
    import torch

    import nif_tpu_torch
    from nif_tpu_torch.parallel import put_params_model_parallel

    m = nif_tpu_torch.NIFMultiScale(CFG_S, CFG_P, device="cpu")
    m.param_tree().load_state_dict(
        {k.replace("/", "."): torch.from_numpy(np.array(v)) for k, v in params.items()})
    if mesh is not None:
        put_params_model_parallel(m, mesh)
    return m


def flat_params(m):
    """The whole parameters (a split head reassembled) as ``{"pnet/...":
    list}``."""
    from nif_tpu_torch.parallel.state import local_params

    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = np.asarray(v).tolist()

    walk(local_params(m), "")
    return out


def fine_tune(params, mesh=None, chunked=False):
    """Point-wise ``LBFGS`` and ``GroupedLBFGS`` for :data:`ITERS`
    iterations from ``params``: ``{form: {"loss", "params", "counts",
    "head_rows"}}``."""
    from nif_tpu_torch.optimizers import GroupedLBFGS, LBFGS

    rows, targets, t, x, u = data()
    out = {}
    for form in ("pointwise", "grouped"):
        m = model(params, mesh)
        if form == "pointwise":
            opt = LBFGS(m, inputs=rows, targets=targets, mesh=mesh,
                        chunk_size=CHUNK_ROWS if chunked else None)
        else:
            opt = GroupedLBFGS(m, t, x, u, mesh=mesh,
                               chunk_groups=CHUNK_GROUPS if chunked else None)
        opt.minimize(max_iter=ITERS)
        out[form] = {"loss": [float(v) for v in opt.history["loss"]],
                     "params": flat_params(m), "counts": dict(opt.counts),
                     "head_rows": int(m.pnet.params["last"]["w"].shape[0])}
    return out


def split_head(workdir, mesh_shape):
    """One rank: both fine-tunes on a ``('data', 'model')`` mesh of
    ``mesh_shape`` with the head split over ``'model'``, unchunked and
    chunked over the data axis."""
    from nif_tpu_torch.parallel import make_mesh

    with np.load(os.path.join(workdir, "params.npz")) as z:
        params = {k: z[k] for k in z.files}
    mesh = make_mesh(axis_names=("data", "model"), mesh_shape=tuple(mesh_shape))
    return {"whole": fine_tune(params, mesh), "chunked": fine_tune(params, mesh, chunked=True)}
