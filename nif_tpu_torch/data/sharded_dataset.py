"""Sharded streaming datasets (counterpart of
``nif_tpu/data/sharded_dataset.py``; the same code, so one seed streams the
same batches, bit for bit, in both packages).

``ShardedDataset`` streams point-wise rows from ``.npy`` shards
(memory-mapped reads; the shuffle's gather runs in the native reader of
:mod:`nif_tpu_torch.data.nifio` when it builds, numpy otherwise), with
global epoch accounting across shards. ``GroupedDataset`` streams
``(group_batch, point_batch)`` batches of whole snapshots from ``.npz``
shards for the grouped trainer, optionally with Jacobian and Hessian
targets and a residual point sampler. A background thread loads the next
shard while the current one is consumed; :func:`~nif_tpu_torch.data.
prefetch_to_device` then overlaps each batch's copy to the card with the
step before it.

Multi-host striping: pass ``(host_id, num_hosts)`` to ``open`` to take
every ``num_hosts``-th shard file.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .nifio import gather_rows, permute_rows

__all__ = ["ShardedDataset", "GroupedDataset"]


class ShardedDataset:
    """Point-cloud dataset sharded into .npy files.

    Layout: ``<dir>/<prefix>_<i>.npy`` each of shape ``[n_pts, n_cols]``
    (float32), plus ``<dir>/meta.json`` with the column split.
    Rows are ``[features..., targets..., (weight)]`` — identical to the
    reference's column convention (nif/data/tfr_dataset.py:36-42).
    """

    def __init__(self, n_feature: int, n_target: int, area_weight: bool = False):
        self.n_feature = n_feature
        self.n_target = n_target
        self.area_weight = area_weight
        self.path: Optional[str] = None
        self.files: Sequence[str] = ()

    # ------------------------------------------------------------- creation
    def create_from_npz(
        self,
        num_pts_per_file: int,
        npz_path: str,
        npz_key: str,
        out_path: str,
        prefix: str = "shard",
        shuffle: bool = True,
        seed: int = 0,
        verbose: bool = False,
    ) -> None:
        """Shuffle a big npz and chop it into .npy shard files.

        API-parity with ``TFRDataset.create_from_npz`` (reference
        nif/data/tfr_dataset.py:22-83), minus the serialization cost: the
        global permutation is applied with the multithreaded gather and
        shards are written with raw ``tofile``.
        """
        num_pts_per_file = int(num_pts_per_file)
        if npz_path.endswith(".npy"):
            # true mmap: shard creation streams from disk at constant RSS
            data = np.load(npz_path, mmap_mode="r")
        else:
            # .npz members are zip streams — numpy silently IGNORES
            # mmap_mode and materializes the whole array on first access.
            # For datasets larger than RAM, convert to .npy (np.save) and
            # pass that path instead.
            data = np.load(npz_path)[npz_key]
        n_total, n_col = data.shape
        expected = self.n_feature + self.n_target + (1 if self.area_weight else 0)
        if n_col != expected:
            raise ValueError(f"expected {expected} columns, npz has {n_col}")

        os.makedirs(out_path, exist_ok=True)
        n_files = int(np.ceil(n_total / num_pts_per_file))
        perm = None
        if shuffle:
            perm = np.random.default_rng(seed).permutation(n_total)
        for i in range(n_files):
            i0, i1 = i * num_pts_per_file, min((i + 1) * num_pts_per_file, n_total)
            if perm is not None:
                chunk = gather_rows(data, perm[i0:i1])
            else:
                chunk = np.asarray(data[i0:i1], dtype=np.float32)
            np.save(os.path.join(out_path, f"{prefix}_{i}.npy"), chunk.astype(np.float32))
            if verbose:
                print(f"wrote shard {i + 1}/{n_files} ({i1 - i0} pts)")
        with open(os.path.join(out_path, "meta.json"), "w") as f:
            json.dump(
                {
                    "n_feature": self.n_feature,
                    "n_target": self.n_target,
                    "area_weight": self.area_weight,
                    "num_pts_per_file": num_pts_per_file,
                    "n_total": int(n_total),
                    "n_files": n_files,
                    "prefix": prefix,
                },
                f,
            )

    # -------------------------------------------------------------- loading
    def open(self, path: str, host_id: int = 0, num_hosts: int = 1) -> "ShardedDataset":
        """Point at a shard directory; stripes files across hosts."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if (meta["n_feature"], meta["n_target"]) != (self.n_feature, self.n_target):
            raise ValueError(
                f"meta.json column split {meta['n_feature']}/{meta['n_target']} "
                f"does not match dataset ({self.n_feature}/{self.n_target})"
            )
        if bool(meta.get("area_weight", False)) != self.area_weight:
            # Silently mismatched flags would split the last TARGET column
            # off as a sample weight (or drop stored weights).
            raise ValueError(
                f"meta.json area_weight={meta.get('area_weight', False)} does "
                f"not match dataset (area_weight={self.area_weight})"
            )
        files = sorted(
            (
                os.path.join(path, fn)
                for fn in os.listdir(path)
                if fn.endswith(".npy")
            ),
            key=lambda p: int(os.path.basename(p).rsplit("_", 1)[1][:-4]),
        )
        self.path = path
        self.files = files[host_id::num_hosts]
        self.meta = meta
        return self

    @classmethod
    def from_dir(cls, path: str, host_id: int = 0, num_hosts: int = 1):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        ds = cls(meta["n_feature"], meta["n_target"], meta["area_weight"])
        return ds.open(path, host_id, num_hosts)

    def _split(self, arr: np.ndarray):
        nf, nt = self.n_feature, self.n_target
        feats = arr[:, :nf]
        targets = arr[:, nf : nf + nt]
        weight = arr[:, -1] if self.area_weight else None
        return feats, targets, weight

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        """Number of batches one epoch of ``iter_batches`` yields for this
        host's stripe (0 means the batch size exceeds every shard — a
        consumer loop would silently take no steps)."""
        total = 0
        for f in self.files:
            n = np.load(f, mmap_mode="r").shape[0]
            total += n // batch_size if drop_remainder else -(-n // batch_size)
        return total

    def iter_batches(
        self,
        batch_size: int,
        epochs: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        prefetch: int = 2,
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]]:
        """Yield ``(epoch, features, targets, weight)`` batches.

        Global epoch accounting: ``epoch`` increments once per full pass
        over ALL shards (not per shard — the reference wart). Shard order
        and intra-shard order reshuffle every epoch. A background thread
        prefetches and shuffles the next shard while the current one is
        being consumed.
        """
        if not self.files:
            raise ValueError("no shards opened; call .open(path) first")
        rng = np.random.default_rng(seed)

        def produce(q: "queue.Queue"):
            try:
                for epoch in range(epochs):
                    order = (
                        rng.permutation(len(self.files))
                        if shuffle
                        else np.arange(len(self.files))
                    )
                    for fi in order:
                        arr = np.load(self.files[fi], mmap_mode="r")
                        if shuffle:
                            chunk = permute_rows(
                                arr, int(rng.integers(0, 2**31 - 1))
                            )
                        else:
                            chunk = np.asarray(arr)
                        q.put((epoch, chunk))
            finally:
                q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            epoch, chunk = item
            n = chunk.shape[0]
            end = n - batch_size + 1 if drop_remainder else n
            for s in range(0, max(end, 0), batch_size):
                feats, targets, weight = self._split(chunk[s : s + batch_size])
                yield epoch, feats, targets, weight

    @property
    def num_points(self) -> int:
        return int(self.meta["n_total"]) if hasattr(self, "meta") else sum(
            np.load(f, mmap_mode="r").shape[0] for f in self.files
        )


class GroupedDataset:
    """Snapshot-structured streaming for the grouped fast path.

    Stores whole snapshots — ``t [G, pi]``, ``x [G, P, si]``, ``u [G, P, so]``
    (optional ``w [G, P]``) — as npz shards of ``groups_per_file`` snapshots,
    and streams (group_batch, point_batch) training batches with background
    prefetch. This is the large-scale companion of
    ``PointWiseData.as_grouped()``: the reference's streaming story is
    point-wise only (nif/data/tfr_dataset.py); grouped streaming is what
    feeds the fused train kernel at scale.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.files: Sequence[str] = ()
        if path is not None:
            self.open(path)

    @staticmethod
    def create_from_arrays(
        t: np.ndarray,
        x: np.ndarray,
        u: np.ndarray,
        out_path: str,
        groups_per_file: int = 16,
        weight: Optional[np.ndarray] = None,
        target_jac: Optional[np.ndarray] = None,
        target_hess: Optional[np.ndarray] = None,
        prefix: str = "snap",
    ) -> None:
        """``target_jac [G, P, so, si]`` (optional) stores per-point
        Jacobian targets alongside u — Sobolev training (tutorial-8
        semantics) as a streaming dataset; consumers opt in with
        ``iter_batches(with_jac=True)``. ``target_hess [G, P, so, si, si]``
        (optional) adds second-order targets (HessianLayer semantics,
        reference nif/layers/gradient.py:234-261) behind
        ``with_hess=True``."""
        os.makedirs(out_path, exist_ok=True)
        G = t.shape[0]
        n_files = int(np.ceil(G / groups_per_file))
        for i in range(n_files):
            sl = slice(i * groups_per_file, (i + 1) * groups_per_file)
            payload = {"t": t[sl], "x": x[sl], "u": u[sl]}
            if weight is not None:
                payload["w"] = weight[sl]
            if target_jac is not None:
                payload["ju"] = target_jac[sl]
            if target_hess is not None:
                payload["hu"] = target_hess[sl]
            np.savez(os.path.join(out_path, f"{prefix}_{i}.npz"), **payload)
        with open(os.path.join(out_path, "meta.json"), "w") as f:
            json.dump(
                {"n_groups": int(G), "points_per_group": int(x.shape[1]),
                 "groups_per_file": groups_per_file, "n_files": n_files,
                 "weighted": weight is not None,
                 "sobolev": target_jac is not None,
                 "hessian": target_hess is not None},
                f,
            )

    def open(self, path: str, host_id: int = 0, num_hosts: int = 1):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        files = sorted(
            (os.path.join(path, fn) for fn in os.listdir(path)
             if fn.endswith(".npz")),
            key=lambda p: int(os.path.basename(p).rsplit("_", 1)[1][:-4]),
        )
        self.path = path
        self.files = files[host_id::num_hosts]
        return self

    def steps_per_epoch(self, group_batch: int,
                        drop_remainder: bool = True) -> int:
        """Number of batches one epoch of ``iter_batches`` yields for this
        host's stripe. Multi-host loops need this to truncate every host to
        the same step count (collectives deadlock if one host takes more
        steps than another)."""
        total = 0
        for f in self.files:
            with np.load(f) as z:
                g = z["t"].shape[0]  # t is [G, pi] — tiny
            total += g // group_batch if drop_remainder else -(-g // group_batch)
        return total

    def iter_batches(
        self,
        group_batch: int,
        point_batch: Optional[int] = None,
        epochs: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        drop_remainder: bool = False,
        with_jac: bool = False,
        with_hess: bool = False,
        point_sampler=None,
    ):
        """Yield ``(epoch, t, x, u, w)`` with a fresh point subsample per
        batch. Global epoch accounting, background shard prefetch. Tail
        group batches within a shard file are yielded (smaller) unless
        ``drop_remainder=True`` — note a consumer then sees one more
        batch shape, the tail's.

        ``with_jac=True`` (requires a dataset created with ``target_jac``)
        appends the subsampled Jacobian targets: ``(epoch, t, x, u, w,
        ju)`` — the streaming form of Sobolev training. ``with_hess=True``
        (requires ``target_hess``) appends the second-order targets after
        them: ``(..., ju, hu)`` (``ju`` is ``None`` in the tuple when only
        ``with_hess`` is set).

        ``point_sampler`` (optional; residual
        sampling for data that does NOT fit in host memory): a callable
        ``(t, x, u) -> probs [g, P]`` scoring each loaded shard window,
        e.g. ``lambda t, x, u: trainer.residual_probs(state, t, x, u)``.
        Point subsampling then draws without replacement proportionally to
        the scores (Gumbel top-k) instead of uniformly — per-SHARD residual
        refresh: the distribution is recomputed each time a shard window
        is loaded (the current params at that moment are whatever the
        closure reads), so hard-point mining composes with streaming at
        zero extra host memory. Scoring runs on the consumer thread (it
        runs the model), not the prefetch thread."""
        if not self.files:
            raise ValueError("no shards opened")
        if with_jac and not self.meta.get("sobolev"):
            raise ValueError(
                "with_jac=True but this dataset has no Jacobian targets — "
                "create it with GroupedDataset.create_from_arrays("
                "..., target_jac=...)"
            )
        if with_hess and not self.meta.get("hessian"):
            raise ValueError(
                "with_hess=True but this dataset has no Hessian targets — "
                "create it with GroupedDataset.create_from_arrays("
                "..., target_hess=...)"
            )
        # numpy Generators are not thread-safe: the producer thread gets its
        # own spawned stream so concurrent use can't corrupt either.
        prod_rng, rng = np.random.default_rng(seed).spawn(2)
        P = self.meta["points_per_group"]
        point_batch = min(point_batch or P, P)

        def produce(q):
            try:
                for epoch in range(epochs):
                    for fi in prod_rng.permutation(len(self.files)):
                        with np.load(self.files[fi]) as z:
                            # ju/hu are so*si(*si) times the size of u —
                            # only pay their decompression when asked
                            skip = ({"ju"} if not with_jac else set()) | (
                                {"hu"} if not with_hess else set())
                            payload = {k: z[k] for k in z.files
                                       if k not in skip}
                        q.put((epoch, payload))
            finally:
                q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        threading.Thread(target=produce, args=(q,), daemon=True).start()
        probs = None
        while True:
            item = q.get()
            if item is None:
                break
            epoch, payload = item
            t, x, u = payload["t"], payload["x"], payload["u"]
            w = payload.get("w")
            ju = payload.get("ju") if with_jac else None
            hu = payload.get("hu") if with_hess else None
            if point_sampler is not None:
                # scores are shard-local, so they refresh on every shard
                # window load, against whatever params the closure reads
                probs = np.asarray(point_sampler(t, x, u), np.float64)
                if probs.shape != (t.shape[0], P):
                    raise ValueError(
                        f"point_sampler returned {probs.shape}, "
                        f"expected {(t.shape[0], P)}"
                    )
            g = t.shape[0]
            order = rng.permutation(g)
            end = g - group_batch + 1 if drop_remainder else g
            for s in range(0, max(end, 0), group_batch):
                gsel = order[s : s + group_batch]
                if probs is None:
                    psel = rng.choice(P, size=point_batch, replace=False)
                    take = lambda a: a[gsel][:, psel]  # noqa: E731
                else:
                    # per-group Gumbel top-k: [b, point_batch] hard points
                    gmb = rng.gumbel(size=(len(gsel), P))
                    keys = np.log(np.maximum(probs[gsel], 1e-300)) + gmb
                    psel = np.argpartition(
                        -keys, point_batch - 1, axis=1)[:, :point_batch]
                    r2 = np.arange(len(gsel))[:, None]
                    take = lambda a: a[gsel][r2, psel]  # noqa: E731
                batch = (
                    epoch,
                    t[gsel],
                    take(x),
                    take(u),
                    None if w is None else take(w),
                )
                if with_jac or with_hess:
                    batch = batch + (None if ju is None else take(ju),)
                if with_hess:
                    batch = batch + (take(hu),)
                yield batch
