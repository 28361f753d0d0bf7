"""Host-to-device prefetch for streaming training loops (counterpart of
``nif_tpu/data/prefetch.py``).

A loop that hands ``trainer.step`` host arrays copies each batch to the card
in the step, from pageable memory, while the card waits. ``prefetch_to_device``
copies the next batches ahead: each array goes into a pinned host buffer and
from there to the device on a side CUDA stream, so the copy runs while the
card works on the step before. The consumer's stream waits on the copy's
event before it reads the batch, and ``record_stream`` keeps the batch's
device memory from being reused while that stream may still read it. A
ring of ``size + 1`` pinned buffer sets is refilled only after the copy out
of a set has ended (its event is synchronized first).
"""
from __future__ import annotations

import collections
import itertools

import numpy as np
import torch

from ..models.nif import resolve_device

__all__ = ["prefetch_to_device"]


def prefetch_to_device(iterator, size: int = 2, device=None, mesh=None):
    """Yield the items of ``iterator`` (tuples, as the datasets'
    ``iter_batches`` yield them) with their numpy arrays as tensors on
    ``device`` (CUDA unless the caller names another), keeping up to
    ``size`` items in flight. Other elements (epoch counters, ``None``
    weights) pass through. ``size=2`` is the double buffer: one batch being
    consumed, one in flight. On the CPU the arrays become tensors without a
    copy.

    With ``mesh`` (``parallel.make_mesh``) each array's dim 0 is cut to this
    rank's block on the host (all of it under ``local_batches``), only that
    block is staged, onto the rank's device, and the tensors are marked as
    placed, so the trainers' step takes them without a second cut."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if mesh is not None:
        from ..parallel.mesh import host_block, mark_placed

        dev = mesh.device
        cut = lambda a: host_block(a, mesh)  # noqa: E731
        mark = lambda t: mark_placed(t, mesh)  # noqa: E731
    else:
        dev = resolve_device(device)
        cut = mark = lambda a: a  # noqa: E731
    if dev.type != "cuda":
        return _host(iterator, size, dev, cut, mark)
    return _cuda(iterator, size, dev, cut, mark)


def _host(iterator, size, dev, cut, mark):
    def place(item):
        return tuple(mark(torch.as_tensor(cut(a), device=dev)) if isinstance(a, np.ndarray)
                     else a for a in item)

    return _pipeline(iterator, size, place, lambda out: out)


def _cuda(iterator, size, dev, cut, mark):
    side = torch.cuda.Stream(dev)
    n_slots = size + 1
    buffers = [dict() for _ in range(n_slots)]
    events = [None] * n_slots
    count = itertools.count()

    def place(item):
        slot = next(count) % n_slots
        if events[slot] is not None:
            events[slot].synchronize()  # the last copy out of these buffers has ended
        bufs = buffers[slot]
        out = []
        with torch.cuda.stream(side):
            for j, a in enumerate(item):
                if not isinstance(a, np.ndarray):
                    out.append(a)
                    continue
                src = torch.from_numpy(np.ascontiguousarray(cut(a)))
                buf = bufs.get(j)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = bufs[j] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out.append(mark(buf.to(dev, non_blocking=True)))
            event = torch.cuda.Event()
            event.record(side)
        events[slot] = event
        return tuple(out), event

    def deliver(placed):
        out, event = placed
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(event)
        for a in out:
            if isinstance(a, torch.Tensor):
                a.record_stream(stream)
        return out

    return _pipeline(iterator, size, place, deliver)


def _pipeline(iterator, size, place, deliver):
    it = iter(iterator)
    q: collections.deque = collections.deque()

    def fill(n):
        for item in itertools.islice(it, n):
            q.append(place(item))

    fill(size)
    while q:
        out = q.popleft()
        fill(1)
        yield deliver(out)
