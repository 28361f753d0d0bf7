"""The device-resident loop behind ``GroupedTrainer.fit_resident``.

``ResidentData`` stages a grouped dataset on the device once and draws each
step's batch there: whole groups without replacement (a prefix of a fresh
permutation) when ``group_batch < G``, and points i.i.d. with replacement
when ``point_batch < P`` or the sampling is residual, the residual draws by
inverse CDF from a ``[G, P]`` row CDF kept on the device. The draws come
from a ``torch.Generator`` on the data's device, seeded once per call; every
step draws the same count from it, so step i's batch depends on the seed and
i alone, never on where the chunks of a run fall.

``ResidentLoop`` runs the steps. On the CPU it is a Python loop over the
step. On the card the first step of a call runs eagerly on a side stream
(the warm-up a capture needs: the optimizer's state and the kernels' device
constants are made there), then one step is captured as a
``torch.cuda.CUDAGraph``, the generator registered with it, and replayed
for the rest: the whole step when the optimizer is a capturable Adam or
AdamW, otherwise the ParameterNet forward, the fused kernel and the
autograd backward, with ``opt.step()`` after each replay. The graph holds
the addresses of the data, the parameters and the optimizer's state, so a
loop captures anew for each call and keeps nothing across calls. The
whole-step graph is captured with each param group's learning rate in a
device tensor, which the loop fills from the group before its replays, so a
learning-rate schedule needs no new capture; a change of another
hyperparameter captures the whole step anew. An optimizer on a per-update
schedule (``optimizers.with_schedule``) has its learning rate evaluated on
the host before every replay and filled into that tensor; in the other form
``opt.step()`` evaluates it itself.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.nif import resolve_device
from ..optimizers.schedule import advance_schedule

__all__ = ["ResidentData", "ResidentLoop", "graph_form"]


class ResidentData:
    """A grouped dataset on one device and the batches drawn from it.

    ``t [G, pi]``, ``x [G, P, si]``, ``u [G, P, so]`` and the optional
    ``sample_weight [G, P]``, ``target_jac [G, P, so, si]`` and
    ``target_hess [G, P, so, si, si]`` (arrays or tensors) are copied to
    ``device`` (CUDA unless the caller names another) once. :meth:`batch`
    draws and gathers the next step's batch there. ``residual`` keeps a row
    CDF for :meth:`set_probs`, which residual draws follow."""

    def __init__(self, t, x, u, sample_weight=None, target_jac=None, target_hess=None, *,
                 group_batch: int, point_batch: int, seed: int, residual: bool = False,
                 device=None):
        dev = resolve_device(device)
        put = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
        self.t, self.x, self.u = put(t), put(x), put(u)
        self.w, self.jac, self.hess = put(sample_weight), put(target_jac), put(target_hess)
        self.device = self.x.device
        self.G, self.P = self.x.shape[0], self.x.shape[1]
        if not (1 <= group_batch <= self.G and 1 <= point_batch <= self.P):
            raise ValueError(f"group_batch {group_batch} and point_batch {point_batch} must lie "
                             f"in [1, G={self.G}] and [1, P={self.P}]")
        self.group_batch, self.point_batch = group_batch, point_batch
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
        self.sample_groups = group_batch < self.G
        self.sample_points = point_batch < self.P or residual
        self._g_lanes = torch.arange(self.G, dtype=torch.int64, device=self.device)
        self.cdf = (torch.ones((self.G, self.P), dtype=torch.float64, device=self.device)
                    if residual else None)

    def set_probs(self, probs) -> None:
        """Residual sampling: rebuild the row CDF from ``probs [G, P]`` (each
        row a distribution over its points) in place, so a captured step
        reads the new one."""
        cdf = np.cumsum(np.asarray(probs, np.float64), axis=1)
        cdf /= cdf[:, -1:]
        cdf[:, -1] = 1.0
        self.cdf.copy_(torch.from_numpy(cdf))

    def indices(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The next step's ``(groups [group_batch], points [group_batch,
        point_batch])`` on the data's device: None where the step takes every
        group, or every point, in order. Each call draws the same count from
        the generator."""
        gsel = idx = None
        gen, dev = self.generator, self.device
        if self.sample_groups:
            keys = torch.rand(self.G, dtype=torch.float64, generator=gen, device=dev)
            gsel = torch.argsort(keys)[: self.group_batch]
        if self.sample_points:
            shape = (self.group_batch, self.point_batch)
            if self.cdf is None:
                idx = torch.randint(self.P, shape, generator=gen, device=dev)
            else:
                rows = self.cdf if gsel is None else self.cdf.index_select(0, gsel)
                uniform = torch.rand(shape, dtype=torch.float64, generator=gen, device=dev)
                idx = torch.searchsorted(rows, uniform, right=True).clamp_(max=self.P - 1)
        return gsel, idx

    def batch(self) -> dict:
        """The next step's batch as ``GroupedTrainer.step``'s keywords
        ``{"t", "x", "u", "w", "target_jac", "target_hess"}``:
        ``[group_batch, ...]`` and ``[group_batch, point_batch, ...]``
        tensors gathered on the device (None for an absent one)."""
        gsel, idx = self.indices()
        t = self.t if gsel is None else self.t.index_select(0, gsel)
        rows = []
        for a in (self.x, self.u, self.w, self.jac, self.hess):
            if a is None:
                rows.append(None)
            elif idx is None:
                rows.append(a if gsel is None else a.index_select(0, gsel))
            else:
                base = (self._g_lanes if gsel is None else gsel).unsqueeze(1) * self.P
                flat = (idx + base).reshape(-1)
                rest = tuple(a.shape[2:])
                rows.append(a.reshape((self.G * self.P,) + rest).index_select(0, flat)
                            .view((self.group_batch, self.point_batch) + rest))
        x, u, w, jac, hess = rows
        return {"t": t, "x": x, "u": u, "w": w, "target_jac": jac, "target_hess": hess}


def graph_form(optimizer, device) -> Tuple[str, str]:
    """``(form, reason)``: what :class:`ResidentLoop` replays on ``device``
    for ``optimizer``: ``"step"`` (the whole step, ``opt.step()`` included:
    a capturable Adam or AdamW), ``"forward_backward"`` (``opt.step()`` runs
    after each replay) or ``"eager"`` (off CUDA: a Python loop)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "eager", f"not on CUDA (device {str(device)!r})"
    name = type(optimizer).__name__
    if (isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))
            and all(g.get("capturable", False) for g in optimizer.param_groups)):
        return "step", f"{name} with capturable=True: opt.step() is captured with the step"
    return "forward_backward", (f"{name} is not an Adam or AdamW with capturable=True: "
                                f"opt.step() runs after each replay")


def _hyperparameters(optimizer):
    """Each param group's settings but its learning rate and its schedule's
    count: a whole-step graph holds them as they were at its capture (a
    tensor by identity: it is read where it lies)."""
    return [tuple(sorted((k, id(v) if isinstance(v, torch.Tensor) else v)
                         for k, v in g.items()
                         if k not in ("params", "lr", "schedule_count")))
            for g in optimizer.param_groups]


class ResidentLoop:
    """The steps of one ``fit_resident`` call: ``trainer``'s step over the
    batches of ``data``, with ``optimizer``, ``n_total`` steps at most.

    :meth:`run` runs the next ``n`` steps; :meth:`losses` reads back the
    losses of a range of them (one host sync). ``capture_ms`` lists the host
    time of each capture and ``step_ms`` the device time (CUDA events) per
    replayed step of each :meth:`run` that replayed."""

    def __init__(self, trainer, optimizer, data: ResidentData, n_total: int):
        self.trainer, self.optimizer, self.data = trainer, optimizer, data
        dev = data.device
        self.step_index = torch.zeros((), dtype=torch.int64, device=dev)
        self._losses = torch.zeros(max(n_total, 1), dtype=torch.float64, device=dev)
        self.form, self.reason = graph_form(optimizer, dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._captured_with = None
        # whole-step form: each param group's lr as the graph reads it
        self._lr = [torch.zeros((), dtype=torch.float32, device=dev)
                    for _ in optimizer.param_groups] if self.form == "step" else []
        self._warm = False
        self.capture_ms: List[float] = []
        self.step_ms: List[float] = []

    def _body(self, opt_step: bool) -> None:
        """One step on the device, no host sync: draw, gather, loss and
        gradients, the optimizer's update (``opt_step``), the loss into its
        slot, the step index on."""
        loss = self.trainer._grads(**self.data.batch())
        if opt_step:
            self.optimizer.step()
        self._losses.index_copy_(0, self.step_index.view(1),
                                 loss.detach().to(torch.float64).view(1))
        self.step_index += 1

    def _fill_lr(self) -> None:
        """Put each param group's learning rate (a schedule writes a float
        between chunks) where the whole-step graph reads it."""
        for g, lr in zip(self.optimizer.param_groups, self._lr):
            lr.fill_(float(g["lr"]))

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.data.generator)
        groups = self.optimizer.param_groups
        own = [g["lr"] for g in groups]
        for g, lr in zip(groups, self._lr):
            g["lr"] = lr
        try:
            with torch.cuda.graph(graph):
                self._body(opt_step=self.form == "step")
        finally:
            for g, value in zip(groups, own):
                g["lr"] = value
        self.graph = graph
        self._captured_with = _hyperparameters(self.optimizer)
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)

    def run(self, n: int) -> None:
        """Run the next ``n`` steps."""
        if self.form == "eager":
            for _ in range(n):
                self._body(opt_step=True)
            return
        if n and not self._warm:
            main = torch.cuda.current_stream(self.data.device)
            side = torch.cuda.Stream(self.data.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._body(opt_step=True)
            main.wait_stream(side)
            self._warm = True
            n -= 1
        if not n:
            return
        self._fill_lr()
        if self.graph is None or (self.form == "step"
                                  and _hyperparameters(self.optimizer) != self._captured_with):
            self.graph = None
            self._capture()
        # a per-update schedule (optimizers.with_schedule): the captured
        # step's pre-hook did nothing, so each replay's learning rate is
        # evaluated here and filled into the tensor the graph reads
        scheduled = (self.form == "step"
                     and getattr(self.optimizer, "lr_schedule", None) is not None)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            if scheduled:
                advance_schedule(self.optimizer)
                self._fill_lr()
            self.graph.replay()
            if self.form == "forward_backward":
                self.optimizer.step()
        end.record()
        end.synchronize()
        self.step_ms.append(start.elapsed_time(end) / n)

    def losses(self, start: int, n: int) -> np.ndarray:
        """The losses of steps ``start .. start + n - 1`` of the call (float64)."""
        return self._losses[start: start + n].cpu().numpy()

    def close(self) -> None:
        """Drop the graph and the parameters' references to its gradients,
        so its memory pool is freed."""
        self.graph = None
        for _, p in self.trainer.model.param_items():
            p.grad = None
