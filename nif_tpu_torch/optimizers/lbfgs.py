"""Full-batch L-BFGS fine-tuning (counterpart of ``nif_tpu/optimizers/lbfgs.py``).

``lbfgs_minimize`` runs, on one flat parameter vector, the algorithm the JAX
package configures from optax: ``optax.lbfgs`` with a memory of 20 curvature
pairs and the scaled initial preconditioner (its first step capped by the
reciprocal of the gradient norm), ``scale_by_zoom_linesearch(100)`` with
optax's defaults (slope 1e-4, curvature 0.9, the approximate-decrease rule
1e-6, the previous step size as the first guess) and
``value_and_grad_from_state`` (the line search's value and gradient at the
accepted point start the next iteration, so an iteration costs its trials
alone). It stops when ``||g||_2 <= tolerance`` or the value is not finite.

The two-loop recursion runs on the device. The line search's branches run on
the host, in the parameters' dtype, one for one with optax's: each trial
reads its value and slope back (one host read), and each iteration reads its
slope and gradient norm (one more). ``LBFGSState`` counts the iterations,
the objective evaluations and the host reads.

``LBFGS`` fine-tunes a model point-wise and ``GroupedLBFGS`` on the grouped
layout, in place: the objective reads the model's parameters, and the
optimizer writes each trial point into them. ``GroupedLBFGS`` evaluates its
objective through ``mse_value_and_grad`` / ``sobolev_value_and_grad``, one
fused train kernel launch (K2, K4, K6 or K8) per evaluation, or per group
chunk, on the card. A row-parallel head (split over a mesh's ``'model'``
axis) enters the flat vector whole, gathered by ``all_reduce``; each rank
writes back its own rows.

``dtype="float64"`` runs the optimizer's arithmetic and the parameters in
float64 (the reference's float64 L-BFGS); the model's compute dtype still
casts the inputs, so under the float32 policy the objective is computed in
float32, as in the JAX package. Afterwards the parameters stay float64 and
the fused kernels are not taken (``NIF._any_f64``); :func:`cast_parameters`
casts them back. The whole call runs at
``torch.set_float32_matmul_precision("highest")`` (never TF32).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["LBFGS", "GroupedLBFGS", "LBFGSState", "lbfgs_minimize", "cast_parameters"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    key = np.dtype(dtype).name
    if key not in _DTYPES:
        raise ValueError(f"dtype {dtype!r}: L-BFGS runs in float32 or float64")
    return _DTYPES[key]


@contextlib.contextmanager
def _highest_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def cast_parameters(model, dtype=torch.float32):
    """Cast every parameter of ``model`` to ``dtype`` in place (each
    ``nn.Parameter`` keeps its identity; float64 -> float32 rounds to
    nearest even, as numpy's ``astype`` does). Returns ``model.param_tree()``.
    After a ``dtype="float64"`` fine-tune this restores the float32
    parameters the fused kernels and the train state's optimizer take."""
    dtype = _torch_dtype(dtype)
    with torch.no_grad():
        for _, p in model.param_items():
            p.data = p.data.to(dtype)
    return model.param_tree()


class LBFGSState:
    """The optimizer's state between calls: the curvature memory (``[m, n]``
    differences of parameters and gradients and their weights, on the
    device), the previous point and gradient, the iteration count, the line
    search's last step size, value and gradient; and the counts of the work
    done (``iterations``, ``evaluations``, ``host_reads``)."""

    def __init__(self, x: torch.Tensor, memory_size: int):
        n = x.numel()
        self.dtype = x.dtype
        self.np_dtype = np.float64 if x.dtype == torch.float64 else np.float32
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.diff_params = torch.zeros((memory_size, n), dtype=x.dtype, device=x.device)
        self.diff_updates = torch.zeros((memory_size, n), dtype=x.dtype, device=x.device)
        self.weights = torch.zeros(memory_size, dtype=x.dtype, device=x.device)
        self.learning_rate = self.np_dtype(1.0)
        self.value = self.np_dtype(np.inf)
        self.grad = torch.zeros_like(x)
        self.iterations = 0
        self.evaluations = 0
        self.host_reads = 0


def _precondition(state: LBFGSState, grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """optax ``scale_by_lbfgs`` (scale_init_precond=True): store the newest
    curvature pair, then multiply ``grad`` by the inverse-Hessian estimate
    (the two-loop recursion over the memory, oldest slot first)."""
    m = state.weights.shape[0]
    idx = state.count % m
    prev = (state.count - 1) % m
    if state.count > 0:
        dp = x - state.params
        du = grad - state.updates
        vd = torch.dot(du, dp)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        den = torch.dot(du, du)
        scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
    else:
        dp = torch.zeros_like(x)
        du = torch.zeros_like(x)
        weight = torch.zeros((), dtype=x.dtype, device=x.device)
        scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
    state.diff_params[prev] = dp
    state.diff_updates[prev] = du
    state.weights[prev] = weight
    # oldest slot first; slots no pair has reached yet hold zeros, whose
    # terms leave the vector as it is, so they are skipped
    order = [(idx + k) % m for k in range(m)][m - min(state.count, m):]
    vec = grad
    alphas = {}
    for i in reversed(order):
        alpha = state.weights[i] * torch.dot(state.diff_params[i], vec)
        vec = vec + (-alpha) * state.diff_updates[i]
        alphas[i] = alpha
    vec = scale * vec
    for i in order:
        beta = state.weights[i] * torch.dot(state.diff_updates[i], vec)
        vec = vec + (alphas[i] - beta) * state.diff_params[i]
    state.count += 1
    state.params = x
    state.updates = grad
    return vec


class _Zoom:
    """optax's ``zoom_linesearch`` (Nocedal and Wright's algorithms 3.5 and
    3.6 with Hager and Zhang's approximate decrease), its scalars on the host
    in the parameters' dtype. ``run`` returns ``(stepsize, value, grad)``
    at the accepted point."""

    def __init__(self, dt, max_steps: int = 100, tol: float = 0.0, increase_factor: float = 2.0,
                 slope_rtol: float = 1e-4, curv_rtol: float = 0.9,
                 approx_dec_rtol: Optional[float] = 1e-6, interval_threshold: float = 1e-5):
        self.dt = dt
        self.max_steps = max_steps
        self.tol, self.increase_factor = dt(tol), dt(increase_factor)
        self.slope_rtol, self.curv_rtol = dt(slope_rtol), dt(curv_rtol)
        self.approx_slope = dt(2 * slope_rtol - 1.0)
        self.approx_dec_rtol = None if approx_dec_rtol is None else dt(approx_dec_rtol)
        self.interval_threshold = dt(interval_threshold)

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        dt = self.dt
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        if self.approx_dec_rtol is not None:
            approx = slope - self.approx_slope * slope_init
            delta = value - value_init - self.approx_dec_rtol * np.abs(value_init)
            approx = np.maximum(approx, delta)
            err = np.minimum(approx, err)
        err = np.maximum(err, dt(0))
        return dt(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(slope_init), self.dt(0))
        return self.dt(np.inf) if np.isnan(err) else err

    def _cubicmin(self, a, fa, fpa, b, fb, c, fc):
        """optax's ``_cubicmin``: the critical point of the cubic through
        (a, fa), (b, fb), (c, fc) with slope fpa at a (NaN when none)."""
        dt = self.dt
        C = fpa
        db = b - a
        dc = c - a
        dbdc = db * dc
        denom = dbdc * dbdc * (db - dc)
        r0 = fb - fa - C * db
        r1 = fc - fa - C * dc
        A = (dc * dc * r0 + (-(db * db)) * r1) / denom
        B = ((-(dc * dc * dc)) * r0 + db * db * db * r1) / denom
        radical = B * B - dt(3) * A * C
        return a + (-B + np.sqrt(radical)) / (dt(3) * A)

    def _quadmin(self, a, fa, fpa, b, fb):
        """optax's ``_quadmin``: the critical point of the quadratic through
        (a, fa), (b, fb) with slope fpa at a."""
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return a - fpa / (self.dt(2) * B)

    def run(self, trial: Callable, value_init, grad_init, slope_init, guess):
        """``trial(stepsize) -> (value, slope, grad)`` at ``x + stepsize *
        u``; the search starts at ``guess`` (optax's "keep")."""
        dt = self.dt
        zero = dt(0)
        s = dict(stepsize=zero, value=value_init, grad=grad_init, slope=slope_init,
                 decrease_error=dt(np.inf), low=zero, value_low=value_init,
                 slope_low=slope_init, high=zero, value_high=value_init,
                 slope_high=slope_init, cubic_ref=zero, value_cubic_ref=value_init,
                 safe_stepsize=zero, safe_value=value_init, safe_grad=grad_init)
        interval_found = False
        count = 0
        with np.errstate(all="ignore"):
            while True:
                if interval_found:
                    done, failed = self._zoom(s, trial, count, value_init, slope_init)
                else:
                    done, failed, interval_found = self._search(
                        s, trial, count, value_init, slope_init, guess)
                count += 1
                if failed:
                    outside = np.isinf(s["decrease_error"])
                    if s["safe_stepsize"] > 0 or outside:
                        s["stepsize"], s["value"], s["grad"] = (
                            s["safe_stepsize"], s["safe_value"], s["safe_grad"])
                if done or failed:
                    return s["stepsize"], s["value"], s["grad"]

    def _search(self, s, trial, count, value_init, slope_init, guess):
        prev_stepsize, prev_value, prev_slope = s["stepsize"], s["value"], s["slope"]
        new = guess if count == 0 else self.increase_factor * prev_stepsize
        value, slope, grad = trial(new)
        dec = self._decrease_error(new, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = np.maximum(dec, curv)
        if dec <= self.tol:
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = new, value, grad
        set_high = bool(dec > 0) or (bool(value >= prev_value) and count > 0)
        set_low = bool(slope >= 0) and not set_high
        if set_low:
            low, vlow, slow, high, vhigh, shigh = new, value, slope, prev_stepsize, prev_value, prev_slope
        else:
            low, vlow, slow, high, vhigh, shigh = prev_stepsize, prev_value, prev_slope, new, value, slope
        found = set_high or set_low or bool(error <= self.tol)
        done = bool(error <= self.tol)
        failed = (count + 1 >= self.max_steps) and not done
        s.update(stepsize=new, value=value, grad=grad, slope=slope, decrease_error=dec,
                 low=low, value_low=vlow, slope_low=slow, high=high, value_high=vhigh,
                 slope_high=shigh, cubic_ref=low, value_cubic_ref=vlow)
        return done, failed, found

    def _zoom(self, s, trial, count, value_init, slope_init):
        dt = self.dt
        low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
        high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
        cref, vcref = s["cubic_ref"], s["value_cubic_ref"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = dt(0.2) * delta, dt(0.1) * delta
        too_small = bool(delta <= self.interval_threshold)
        mid_cubic = self._cubicmin(low, vlow, slow, high, vhigh, cref, vcref)
        use_cubic = bool(mid_cubic > left + cubic_chk) and bool(mid_cubic < right - cubic_chk)
        mid_quad = self._quadmin(low, vlow, slow, high, vhigh)
        use_quad = (not use_cubic) and bool(mid_quad > left + quad_chk) and bool(
            mid_quad < right - quad_chk)
        if use_cubic:
            middle = mid_cubic
        elif use_quad:
            middle = mid_quad
        else:
            middle = (low + high) / dt(2)
        value, slope, grad = trial(middle)
        dec = self._decrease_error(middle, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = np.maximum(dec, curv)
        if dec <= self.tol and bool(value < s["safe_value"]):
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = middle, value, grad
        done = bool(error <= self.tol)
        set_high_mid = bool(dec > 0) or bool(value >= vlow)
        set_high_low = bool(slope * (high - low) >= 0) and not set_high_mid
        set_low_mid = not set_high_mid
        nh, nvh, nsh = (middle, value, slope) if set_high_mid else (high, vhigh, shigh)
        if set_high_low:
            nh, nvh, nsh = low, vlow, slow
        nl, nvl, nsl = (middle, value, slope) if set_low_mid else (low, vlow, slow)
        ncref, nvcref = (high, vhigh) if (set_high_mid or set_high_low) else (low, vlow)
        failed = ((count + 1 >= self.max_steps)
                  or (too_small and bool(s["safe_stepsize"] > 0))) and not done
        s.update(stepsize=middle, value=value, grad=grad, slope=slope, decrease_error=dec,
                 low=nl, value_low=nvl, slope_low=nsl, high=nh, value_high=nvh,
                 slope_high=nsh, cubic_ref=ncref, value_cubic_ref=nvcref)
        return done, failed


def _read(state: LBFGSState, *scalars: torch.Tensor) -> List:
    """One host read of several device scalars, counted."""
    state.host_reads += 1
    vals = torch.stack([v.reshape(()).to(state.dtype) for v in scalars]).cpu().numpy()
    return [state.np_dtype(v) for v in vals]


def _run(vg: Callable, x: torch.Tensor, max_iter: int, state: LBFGSState, tolerance: float,
         learning_rate, display_every: int) -> Tuple[torch.Tensor, np.ndarray]:
    """The L-BFGS loop on the flat vector ``x`` with ``vg(x) -> (value,
    grad)``: ``(x, float32 losses of the iterations run)``."""
    dt = state.np_dtype
    zoom = _Zoom(dt)
    losses = []
    for i in range(max_iter):
        value, grad = state.value, state.grad
        fresh = None
        if not np.isfinite(value):
            fresh, grad = vg(x)
            state.evaluations += 1
        lr = -1.0 if learning_rate is None else -float(learning_rate)
        updates = lr * _precondition(state, grad, x)
        scalars = [torch.dot(updates, grad), torch.linalg.vector_norm(grad)]
        if fresh is not None:
            scalars.append(fresh)
        read = _read(state, *scalars)
        slope_init, gnorm = read[0], read[1]
        if fresh is not None:
            value = read[2]

        def trial(stepsize, x=x, updates=updates):
            v, g = vg(x + float(stepsize) * updates)
            state.evaluations += 1
            val, slope = _read(state, v, torch.dot(g, updates))
            return val, slope, g

        stepsize, state.value, state.grad = zoom.run(trial, value, grad, slope_init,
                                                     state.learning_rate)
        state.learning_rate = stepsize
        x = x + float(stepsize) * updates
        state.iterations += 1
        losses.append(np.float32(value))
        if display_every and (i + 1) % display_every == 0:
            print(f"L-BFGS iter {i + 1}  loss {value}")
        if gnorm <= tolerance or not np.isfinite(value):
            break
    return x, np.asarray(losses, np.float32)


def _flatten(params):
    """``(leaves, rebuild)`` of a tensor or a nested dict of tensors (keys in
    sorted order, as JAX flattens a dict)."""
    if isinstance(params, torch.Tensor):
        return [params], lambda leaves: leaves[0]
    keys = sorted(params)
    parts = [_flatten(params[k]) for k in keys]

    def rebuild(leaves):
        out, i = {}, 0
        for k, (sub, fn) in zip(keys, parts):
            out[k] = fn(leaves[i: i + len(sub)])
            i += len(sub)
        return out

    return [leaf for sub, _ in parts for leaf in sub], rebuild


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, o = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[o: o + n].view(shape))
        o += n
    return out


def lbfgs_minimize(
    loss_fn: Callable,
    params,
    max_iter: int = 500,
    memory_size: int = 20,
    tolerance: float = 1e-15,
    learning_rate: Optional[float] = None,
    opt_state: Optional[LBFGSState] = None,
    return_state: bool = False,
    display_every: int = 0,
    dtype=None,
):
    """Minimize ``loss_fn(params)`` with L-BFGS; returns ``(params, losses)``
    (``losses`` float32, one per iteration run), or with ``return_state``
    ``(params, losses, state)``.

    ``params`` is a tensor or a nested dict of tensors; ``loss_fn`` takes
    the same structure and returns a 0-dim tensor that autograd
    differentiates. Pass ``opt_state`` from an earlier call to continue with
    its curvature pairs. ``dtype="float64"`` casts the parameters (and the
    optimizer's arithmetic) to float64, and the loss to it; the returned
    parameters keep that dtype. ``learning_rate`` scales the direction
    before the line search, as optax's ``lbfgs(learning_rate=...)``."""
    dtype = _torch_dtype(dtype)
    leaves, rebuild = _flatten(params)
    if dtype is not None:
        leaves = [leaf.to(dtype) for leaf in leaves]
    shapes = [tuple(leaf.shape) for leaf in leaves]
    x = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])

    def vg(flat):
        leaf = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss_fn(rebuild(_split(leaf, shapes)))
            if dtype is not None:
                value = value.to(dtype)
            (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), grad

    with _highest_precision():
        state = LBFGSState(x, memory_size) if opt_state is None else opt_state
        x, losses = _run(vg, x, max_iter, state, tolerance, learning_rate, display_every)
    out = rebuild([t.clone() for t in _split(x, shapes)])
    return (out, losses, state) if return_state else (out, losses)


def _params_key(model, dtype=None):
    """Path/shape/dtype fingerprint guarding a resumed state."""
    return (tuple((path, tuple(p.shape), p.dtype) for path, p in model.param_items()),
            None if dtype is None else _torch_dtype(dtype))


def _chunk_block(a: np.ndarray, mesh) -> np.ndarray:
    """``[C, chunk, ...]`` chunks -> this rank's block of every chunk's rows
    (all of them without a mesh or with local batches)."""
    if mesh is None:
        return a
    from ..parallel.mesh import host_block

    return np.moveaxis(host_block(np.moveaxis(a, 1, 0), mesh), 0, 1)


def _as(scale: float, value: torch.Tensor) -> float:
    """``scale`` rounded to ``value``'s dtype: the cotangent that reaches a
    gradient through ``value * scale``."""
    return float(torch.tensor(scale, dtype=value.dtype))


def _to_f(a) -> np.ndarray:
    """float64 stays float64 (the f64 fine-tune sees no truncated data),
    everything else becomes float32."""
    a = np.asarray(a)
    return a if a.dtype == np.float64 else a.astype(np.float32)


class LBFGS:
    """Full-batch L-BFGS fine-tuner with the reference ``TFPLBFGS`` API, on a
    model's own parameters (the port's ``TrainState.params``).

    Args:
      model: a port model (``apply``, ``param_items``, ``regularization_loss``).
      loss_fn: ``loss(pred, target) -> 0-dim tensor``; default weighted MSE.
      inputs/targets: the full dataset (arrays or tensors).
      sample_weight: optional per-point weights folded into the MSE.
      reg: add the model's ``regularization_loss``.
      chunk_size: evaluate the objective by accumulation over fixed-size
        chunks (zero-weight padding; batch-mean regularization rows weighted
        by ``chunk_size / n``), so only one chunk's activations are live; the
        built-in weighted MSE only.
      mesh: a ``parallel.make_mesh`` mesh. The chunks' rows split over its
        batch axes (``chunk_size`` rounds up to a multiple of them; each
        rank its block of every chunk), and every evaluation's objective and
        gradient are averaged over them, so every rank reads the same values
        and its line search takes the same trials. Unchunked, every rank
        evaluates the whole set, as the JAX package does. A head split
        row-parallel over the mesh's ``'model'`` axis
        (``put_params_model_parallel``, ``shard_model_axis=True``) is taken
        as the model holds it: the flat vector holds the whole head (its
        rows and its gradient's gathered from the model group), every rank
        the same copy, and each rank writes its own rows back.
    """

    def __init__(self, model, loss_fn: Optional[Callable] = None, inputs=None, targets=None,
                 sample_weight=None, reg: bool = True, display_epoch: int = 0,
                 chunk_size: Optional[int] = None, mesh=None):
        self.model = model
        self.mesh = mesh
        self.display_epoch = display_epoch
        self._base_loss = loss_fn
        self._reg = reg
        self._history: list = []
        self.chunk_size = chunk_size
        self.counts = {"iterations": 0, "evaluations": 0, "host_reads": 0}
        dev = model.device
        put = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
        if chunk_size is None:
            self.inputs, self.targets = put(_to_f(inputs)), put(_to_f(targets))
            self.sample_weight = None if sample_weight is None else put(_to_f(sample_weight))
            return
        if loss_fn is not None:
            raise ValueError(
                "chunk_size only supports the built-in weighted MSE: a "
                "custom loss_fn may not decompose into per-row sums"
            )
        inputs, targets = _to_f(inputs), _to_f(targets)
        n = inputs.shape[0]
        n_div = 1
        if mesh is not None and not mesh.local_batches:
            from ..parallel.mesh import batch_axis_size

            n_div = batch_axis_size(mesh)
            chunk_size += (-chunk_size) % n_div
            self.chunk_size = chunk_size
        pad = (-n) % chunk_size
        w = (np.ones(n, np.float32) if sample_weight is None
             else _to_f(sample_weight).reshape(n))
        if pad:
            inputs = np.concatenate(
                [inputs, np.broadcast_to(inputs[:1], (pad,) + inputs.shape[1:])])
            targets = np.concatenate(
                [targets, np.broadcast_to(targets[:1], (pad,) + targets.shape[1:])])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        C = inputs.shape[0] // chunk_size
        self._n_real = n / n_div  # this rank's share of the mean's normalization
        mask = (w > 0) if sample_weight is None else np.concatenate(
            [np.ones(n, bool), np.zeros(pad, bool)])
        rw = mask.astype(np.float32) * (chunk_size / n)
        self._chunks = tuple(put(_chunk_block(a.reshape((C, chunk_size) + a.shape[1:]), mesh))
                             for a in (inputs, targets, w, rw))

    # ------------------------------------------------------------ objective
    def _params(self) -> List[torch.nn.Parameter]:
        return [p for _, p in self.model.param_items()]

    def _acc_dtype(self) -> torch.dtype:
        """The accumulator's dtype: float64 once the parameters are (the f64
        fine-tune), float32 otherwise."""
        return torch.float64 if self.model._any_f64() else torch.float32

    def _grads(self, value: torch.Tensor) -> List[torch.Tensor]:
        params = self._params()
        grads = torch.autograd.grad(value, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def _value_and_grads(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The objective at the model's parameters and its gradient (in
        ``param_items`` order), averaged over a mesh's batch axes (one flat
        bucket), so every rank holds the same values."""
        value, grads = self._local_value_and_grads()
        if self.mesh is None:
            return value, grads
        from ..parallel.collectives import average_over
        from ..parallel.mesh import batch_axes, batch_axis_size

        out = average_over([value.reshape(())] + grads,
                           [self.mesh.group(a) for a in batch_axes(self.mesh)],
                           batch_axis_size(self.mesh))
        return out[0], out[1:]

    def _local_value_and_grads(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        with torch.enable_grad():
            if self.chunk_size is not None:
                return self._chunked_value_and_grads()
            pred = self.model.apply(self.inputs)
            if self._base_loss is not None:
                loss = self._base_loss(pred, self.targets)
            else:
                err = torch.square(pred - self.targets.to(pred.dtype))
                if self.sample_weight is not None:
                    err = err * self.sample_weight.unsqueeze(-1).to(pred.dtype)
                loss = torch.mean(err)
            if self._reg:
                loss = loss + self.model.regularization_loss(inputs=self.inputs)
            return loss.detach(), self._grads(loss)

    def _chunked_value_and_grads(self):
        ci, ct, cw, crw = self._chunks
        so = ct.shape[-1]
        acc = self._acc_dtype()
        has_batch_reg = self._reg and self.model.has_regularization
        err_sum = torch.zeros((), dtype=acc, device=self.model.device)
        reg_sum = torch.zeros((), dtype=acc, device=self.model.device)
        grads = [torch.zeros_like(p) for p in self._params()]
        for i in range(ci.shape[0]):
            pred = self.model.apply(ci[i])
            err = torch.square(pred - ct[i].to(pred.dtype)) * cw[i].unsqueeze(-1).to(pred.dtype)
            part = torch.sum(err).to(acc)
            err_sum = err_sum + part.detach()
            part = part / (self._n_real * so)
            if has_batch_reg:
                r = self.model.regularization_loss(
                    inputs=ci[i], reg_weight=crw[i], parts="batch").to(acc)
                reg_sum = reg_sum + r.detach()
                part = part + r
            grads = [a + b for a, b in zip(grads, self._grads(part))]
        loss = err_sum / (self._n_real * so)
        if self._reg and self.model.has_regularization:
            params_reg = self.model.regularization_loss(parts="params")
            grads = [a + b for a, b in zip(grads, self._grads(params_reg))]
            loss = loss + reg_sum + params_reg.detach()
        return loss, grads

    def _objective(self) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``(value, grads)`` at the model's parameters, the grads keyed like
        the JAX params tree: the port's ``jax.value_and_grad(_objective)``."""
        value, grads = self._value_and_grads()
        return value, self.model._grad_tree(grads)

    # ------------------------------------------------------------ minimize
    def _run(self, max_iter: int, state: Optional[LBFGSState], dtype) -> LBFGSState:
        params = self._params()
        if dtype is not None:
            cast_parameters(self.model, dtype)
        # a row-parallel head enters the flat vector whole: its rows, and
        # those of its gradient, gathered from the model group (an
        # all_reduce of each rank's rows placed in zeros, exact), so every
        # rank runs the same iterates and writes back its own rows
        from ..parallel.state import _gather_rows, _head_index, _row_parallel

        rp = _row_parallel(self.model)
        head = None if rp is None else _head_index(self.model)
        shapes = [tuple(p.shape) for p in params]
        if head is not None:
            shapes[head] = (rp.full_rows,) + shapes[head][1:]
        opt_dtype = params[0].dtype

        def whole(tensors):
            return [_gather_rows(t, rp) if i == head else t for i, t in enumerate(tensors)]

        def write(flat):
            with torch.no_grad():
                for i, (p, v) in enumerate(zip(params, _split(flat, shapes))):
                    p.copy_(v[rp.rows] if i == head else v)

        def vg(flat):
            write(flat)
            value, grads = self._value_and_grads()
            return value.to(opt_dtype), torch.cat([g.reshape(-1).to(opt_dtype)
                                                   for g in whole(grads)])

        x = torch.cat([p.detach().reshape(-1) for p in whole(params)])
        with _highest_precision():
            if state is None:
                state = LBFGSState(x, 20)
            before = (state.iterations, state.evaluations, state.host_reads)
            x, losses = _run(vg, x, max_iter, state, 1e-15, None, self.display_epoch)
        write(x)
        for key, b in zip(("iterations", "evaluations", "host_reads"), before):
            self.counts[key] += getattr(state, key) - b
        self._history.extend(losses.tolist())
        return state

    def minimize(self, rounds: int = 1, max_iter: int = 500, resume: bool = False,
                 dtype=None):
        """Run ``rounds`` restarts of up to ``max_iter`` iterations each on the
        model's parameters, in place; returns ``model.param_tree()``.

        Restarting clears the curvature memory (the reference's outer rounds
        loop). With ``resume=True`` the curvature pairs carry across rounds
        and across calls, unless the parameters' paths, shapes or dtypes (or
        ``dtype``) differ from those the state was built from: then it
        starts afresh. ``dtype="float64"`` leaves the parameters float64
        (:func:`cast_parameters` casts them back)."""
        key = _params_key(self.model, dtype)
        state = getattr(self, "_opt_state", None) if resume else None
        if state is not None and getattr(self, "_state_key", None) != key:
            state = None
        for _ in range(rounds):
            state = self._run(max_iter, state if resume else None, dtype)
        if resume:
            self._opt_state = state
            self._state_key = _params_key(self.model, dtype)
        return self.model.param_tree()

    @property
    def history(self) -> Dict[str, Any]:
        h = list(self._history)
        return {"iteration": np.arange(1, len(h) + 1), "loss": h}


class GroupedLBFGS(LBFGS):
    """Full-batch L-BFGS over the grouped layout, with the trainers' objective
    ``w_value * mean(weight * (u_pred - u)^2) [+ w_jac * jacobian_mse] [+
    w_hess * hessian_mse] [+ regularization]``, so an Adam run of
    ``GroupedTrainer`` and its fine-tune optimize the same function.

    Each evaluation calls ``model.mse_value_and_grad`` (or
    ``sobolev_value_and_grad`` with derivative targets) with ``use_reg=False``
    (one K2, K4, K6 or K8 launch on the card where the model's gate takes
    the fused path) and adds the regularization through autograd.

    Args:
      t, x, u: grouped ``[G, pi]``, ``[G, P, si]``, ``[G, P, so]``.
      weight: optional ``[G, P]``.
      target_jac / target_hess: optional ``[G, P, so, si]`` /
        ``[G, P, so, si, si]`` derivative targets (full targets only).
      fused: force the fused path (True: the plain kernels on the CPU) or
        the eager one (False); None selects as the trainers do, eager once a
        parameter is float64.
      chunk_groups: evaluate by accumulation over chunks of this many groups
        (zero-weight padded groups; each chunk's mean scaled by ``cG /
        G``), one kernel launch per chunk.
      mesh: as :class:`LBFGS`'s: each chunk's groups split over the batch
        axes (``chunk_groups`` rounds up to a multiple of them), each rank
        runs its own kernel on its block, and the objective and gradient
        are averaged.
    """

    def __init__(self, model, t, x, u, weight=None, target_jac=None, target_hess=None,
                 reg: bool = True, w_value: float = 1.0, w_jac: float = 1.0,
                 w_hess: float = 1.0, display_epoch: int = 0,
                 chunk_groups: Optional[int] = None, mesh=None, fused: Optional[bool] = None):
        self.model = model
        self.mesh = mesh
        self.display_epoch = display_epoch
        self._base_loss = None
        self._reg = reg
        self._history = []
        self.chunk_size = None
        self.counts = {"iterations": 0, "evaluations": 0, "host_reads": 0}
        self.w_value, self.w_jac, self.w_hess = w_value, w_jac, w_hess
        self._fused = fused
        t, x, u = _to_f(t), _to_f(x), _to_f(u)
        G, P, si = x.shape
        so = u.shape[-1]
        w = None if weight is None else _to_f(weight).reshape(G, P)
        tj = None if target_jac is None else _to_f(target_jac)
        if tj is not None and tj.shape != (G, P, so, si):
            raise ValueError(
                f"GroupedLBFGS: target_jac shape {tj.shape} != "
                f"{(G, P, so, si)} (full [G, P, so, si] targets only)"
            )
        th = None if target_hess is None else _to_f(target_hess)
        if th is not None and th.shape != (G, P, so, si, si):
            raise ValueError(
                f"GroupedLBFGS: target_hess shape {th.shape} != "
                f"{(G, P, so, si, si)} (full [G, P, so, si, si] targets "
                f"only)"
            )
        dev = model.device
        put = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
        self._n_real_groups = G
        self.chunk_groups = chunk_groups
        self._has_jac, self._has_hess = tj is not None, th is not None
        if chunk_groups is None:
            self._data = tuple(put(a) for a in (t, x, u, w, tj, th))
            return
        if mesh is not None and not mesh.local_batches:
            from ..parallel.mesh import batch_axis_size

            chunk_groups += (-chunk_groups) % batch_axis_size(mesh)
            self.chunk_groups = chunk_groups
        self._chunk_scale = chunk_groups / G
        pad = (-G) % chunk_groups
        if w is None:
            w = np.ones((G, P), np.float32)
        if pad:
            def padg(a):
                return np.concatenate([a, np.broadcast_to(a[:1], (pad,) + a.shape[1:])])

            t, x, u = padg(t), padg(x), padg(u)
            w = np.concatenate([w, np.zeros((pad, P), np.float32)])
            tj = None if tj is None else padg(tj)
            th = None if th is None else padg(th)
        rw = np.concatenate([np.ones(G, np.float32), np.zeros(pad, np.float32)]) * (
            chunk_groups / G)
        C = t.shape[0] // chunk_groups
        self._chunks = tuple(
            None if a is None
            else put(_chunk_block(a.reshape((C, chunk_groups) + a.shape[1:]), mesh))
            for a in (t, x, u, w, rw, tj, th))

    def _fused_flag(self) -> Optional[bool]:
        """The user's ``fused`` if given, eager once a parameter is float64
        (the kernels take float32 or bfloat16), else None (the model's own
        selection)."""
        if self._fused is not None:
            return self._fused
        if self.model._any_f64():
            return False
        return None

    def _chunk_value_and_grads(self, t, x, u, w, tj, th):
        """One batch's ``(value, grads)`` without regularization, through the
        model's fused (or eager) value-and-gradient."""
        fused = self._fused_flag()
        if tj is None and th is None:
            value, tree = self.model.mse_value_and_grad(t, x, u, weight=w, fused=fused,
                                                        use_reg=False)
        else:
            value, _terms, tree = self.model.sobolev_value_and_grad(
                t, x, u, target_jac=tj, target_hess=th, w_value=self.w_value,
                w_jac=self.w_jac, w_hess=self.w_hess, weight=w, fused=fused, use_reg=False)
        grads = []
        for path, _ in self.model.param_items():
            g = tree
            for k in path:
                g = g[k]
            grads.append(g)
        return value, grads

    def _local_value_and_grads(self):
        acc = self._acc_dtype()
        has_reg = self._reg and self.model.has_regularization
        derivative = self._has_jac or self._has_hess
        if self.chunk_groups is None:
            t, x, u, w, tj, th = self._data
            scale = 1.0 if derivative else self.w_value
            value, grads = self._chunk_value_and_grads(t, x, u, w, tj, th)
            loss = value * scale
            grads = [g * _as(scale, value) for g in grads]
            if has_reg:
                with torch.enable_grad():
                    r = self.model.regularization_loss(t=t)
                    grads = [a + b for a, b in zip(grads, self._grads(r))]
                loss = loss + r.detach()
            return loss.to(acc), grads
        tC, xC, uC, wC, rwC, tjC, thC = self._chunks
        scale = self._chunk_scale
        if not derivative:
            scale = scale * self.w_value
        lsum = torch.zeros((), dtype=acc, device=self.model.device)
        rsum = torch.zeros((), dtype=acc, device=self.model.device)
        grads = None
        for i in range(tC.shape[0]):
            li, gi = self._chunk_value_and_grads(
                tC[i], xC[i], uC[i], wC[i], None if tjC is None else tjC[i],
                None if thC is None else thC[i])
            lsum = lsum + (li * scale).to(acc)
            gi = [g * _as(scale, li) for g in gi]
            if has_reg:
                with torch.enable_grad():
                    r = self.model.regularization_loss(t=tC[i], reg_weight=rwC[i],
                                                       parts="batch").to(acc)
                    gi = [a + b for a, b in zip(gi, self._grads(r))]
                rsum = rsum + r.detach()
            grads = gi if grads is None else [a + b for a, b in zip(grads, gi)]
        loss = lsum
        if has_reg:
            with torch.enable_grad():
                r = self.model.regularization_loss(parts="params")
                grads = [a + b for a, b in zip(grads, self._grads(r))]
            loss = loss + rsum + r.detach()
        return loss, grads
