"""Point-wise data container (counterpart of
``nif_tpu/data/point_wise_data.py``, of which it is a copy: the code is
pure numpy, so it crosses unchanged and ``tests/test_torch_pointwise.py``
pins it equal by AST, this docstring aside).

``PointWiseData`` matches the reference's container (reference
nif/data/point_wise_data.py:4-114): every training sample is one row
``[params..., x..., u..., (weight)]``. ``standard_normalize`` z-scores each
column (in ``area_weighted`` mode the trailing cell-area column becomes the
sample weights); ``minmax_normalize`` maps inputs to [-1, 1] and divides the
targets by max |u|; ``as_grouped`` re-lays the rows out as ``(t [G, pi],
x [G, P, si], u [G, P, so])`` for ``GroupedTrainer``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["PointWiseData"]


class PointWiseData:
    def __init__(
        self,
        parameter_data: np.ndarray,
        x_data: np.ndarray,
        u_data: np.ndarray,
        sample_weight: Optional[np.ndarray] = None,
    ):
        if sample_weight is not None:
            self.data_raw = np.hstack([parameter_data, x_data, u_data, sample_weight])
        else:
            self.data_raw = np.hstack([parameter_data, x_data, u_data])
        self.data: Optional[np.ndarray] = None
        self.sample_weight: Optional[np.ndarray] = None
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.n_p = parameter_data.shape[-1]
        self.n_x = x_data.shape[-1]
        self.n_o = u_data.shape[-1]

    @property
    def parameter(self) -> np.ndarray:
        return self.data[:, : self.n_p]

    @property
    def x(self) -> np.ndarray:
        return self.data[:, self.n_p : self.n_p + self.n_x]

    @property
    def u(self) -> np.ndarray:
        return self.data[:, self.n_p + self.n_x : self.n_p + self.n_x + self.n_o]

    @staticmethod
    def standard_normalize(raw_data: np.ndarray, area_weighted: bool = False):
        """Z-score normalize; see module docstring for area_weighted mode."""
        mean = raw_data.mean(axis=0)
        std = raw_data.std(axis=0)
        if area_weighted:
            mean[-1] = 0.0
            std[-1] = np.mean(raw_data[:, -1])
            normalized = (raw_data - mean) / std
            return normalized[:, :-1], mean, std, normalized[:, -1]
        normalized = (raw_data - mean) / std
        return normalized, mean, std

    @staticmethod
    def minmax_normalize(
        raw_data: np.ndarray,
        n_para: int,
        n_x: int,
        n_target: int,
        area_weighted: bool = False,
    ):
        """Min-max normalize inputs to [-1, 1], scale targets by max |u|."""
        mean = raw_data.mean(axis=0)
        std = raw_data.std(axis=0)
        for i in range(n_para + n_x):
            col = raw_data[:, i]
            mean[i] = 0.5 * (col.min() + col.max())
            std[i] = 0.5 * (col.max() - col.min())
        for j in range(n_para + n_x, n_para + n_x + n_target):
            std[j] = np.max(np.abs(raw_data[:, j]))
        if area_weighted:
            mean[-1] = 0.0
            std[-1] = np.mean(raw_data[:, -1])
            normalized = (raw_data - mean) / std
            return normalized[:, :-1], mean, std, normalized[:, -1]
        normalized = (raw_data - mean) / std
        return normalized, mean, std

    # ------------------------------------------------------------ utilities
    def denormalize_u(self, u_norm: np.ndarray) -> np.ndarray:
        """Invert the target normalization (extra convenience; no reference
        equivalent — users of the reference invert by hand)."""
        if self.mean is None or self.std is None:
            raise ValueError("data has not been normalized")
        lo = self.n_p + self.n_x
        hi = lo + self.n_o
        return u_norm * self.std[lo:hi] + self.mean[lo:hi]

    def as_grouped(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Re-layout the flat point cloud as (t_groups, x[G, P, nx], u[G, P, no]).

        Groups rows by identical parameter tuples; requires every group to
        have the same number of points (true for snapshot data on a fixed or
        per-snapshot mesh of constant size). This is the layout consumed by
        the grouped MXU fast path.
        """
        params = self.parameter
        uniq, inverse = np.unique(params, axis=0, return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse)
        if counts.min() != counts.max():
            raise ValueError(
                "grouped layout requires the same number of points per "
                f"parameter value (got counts in [{counts.min()}, {counts.max()}])"
            )
        p = counts[0]
        g = len(uniq)
        x = self.x[order].reshape(g, p, self.n_x)
        u = self.u[order].reshape(g, p, self.n_o)
        return uniq, x, u
