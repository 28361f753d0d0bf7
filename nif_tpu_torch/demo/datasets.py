"""Bundled demo datasets (counterpart of ``nif_tpu/demo/datasets.py``, of
which it is a copy: the data is analytic numpy, so it crosses unchanged and
``tests/test_torch_pointwise.py`` pins the code equal by AST, docstrings
and the import line aside).

Each class is a ``PointWiseData`` with ``.data/.parameter/.x/.u`` and
``.mean/.std`` (and ``.sample_weight`` for the area-weighted case), as the
reference's demo classes (reference nif/demo/traveling_wave.py:9-37,
traveling_wave_high_freq.py:9-41, cylinderflow.py:8-40). The two 1-D waves
are the reference fixtures' Gaussian-modulated packet

    u(x, t) = exp(-1000 z^2) * sin(K z),   z = x - 0.2 - 0.006 t

on t in {0, 10, ..., 90}, x in {0, 0.005, ..., 0.995}, with K = 4
(``TravelingWave``) or K = 400 (``TravelingWaveHighFreq``). Pass ``path=``
to load a reference-layout ``.npz`` (one ``data`` array of ``[t, x, u]``
rows) instead of generating.

* ``TravelingWave``         — K=4 packet, standard-normalized (tutorial 1).
* ``TravelingWaveHighFreq`` — K=400 packet, minmax-normalized
  (tutorials 2/6/8).
* ``CylinderFlow``          — a 2-D analytic vortex-street-like (u, v)
  field on scattered points with nonuniform cell areas, minmax +
  area-weighted, with the schema ``[t, x, y, u, v, area]`` of the
  reference's cylinder-flow data; ``path=`` loads such a file.
"""
from __future__ import annotations

import numpy as np

from ..data.point_wise_data import PointWiseData

__all__ = ["TravelingWave", "TravelingWaveHighFreq", "CylinderFlow"]

# Reference-fixture field constants (see module docstring).
_X0 = 0.2
_SPEED = 0.006
_ENVELOPE = 1000.0
_T_MAX = 90.0


def traveling_wave_field(t, x, wavenumber):
    """The reference fixtures' closed-form field u(x, t) (f64 in/out)."""
    z = x - _X0 - _SPEED * t
    return np.exp(-_ENVELOPE * z * z) * np.sin(wavenumber * z)


def traveling_wave_dudx(t, x, wavenumber):
    """Analytic du/dx of :func:`traveling_wave_field` (for Sobolev demos)."""
    z = x - _X0 - _SPEED * t
    env = np.exp(-_ENVELOPE * z * z)
    return env * (
        wavenumber * np.cos(wavenumber * z)
        - 2.0 * _ENVELOPE * z * np.sin(wavenumber * z)
    )


def traveling_wave_d2udx2(t, x, wavenumber):
    """Analytic d2u/dx2 of :func:`traveling_wave_field` (second-order
    Sobolev / HessianLayer demos): for u = exp(-a z^2) sin(k z),
    u'' = env * ((4 a^2 z^2 - k^2 - 2a) sin(kz) - 4 a k z cos(kz))."""
    a, k = _ENVELOPE, wavenumber
    z = x - _X0 - _SPEED * t
    env = np.exp(-a * z * z)
    return env * (
        (4.0 * a * a * z * z - k * k - 2.0 * a) * np.sin(k * z)
        - 4.0 * a * k * z * np.cos(k * z)
    )


def _traveling_wave_raw(n_t, n_x, wavenumber):
    """Rows of [t, x, u] on the reference grid layout (t-major), f32.

    Defaults (n_t=10, n_x=200) reproduce the reference ``.npz`` exactly;
    other grid sizes sample the same field more/less densely (t keeps the
    0..90 span, x keeps the [0, 1) span).
    """
    t = np.linspace(0.0, _T_MAX, n_t)
    x = np.linspace(0.0, 1.0, n_x, endpoint=False)
    tt, xx = np.meshgrid(t, x, indexing="ij")
    u = traveling_wave_field(tt, xx, wavenumber)
    return np.stack(
        [tt.ravel(), xx.ravel(), u.ravel()], axis=-1
    ).astype(np.float32)


def _load_reference_npz(path):
    data = np.load(path)["data"]
    if data.ndim != 2 or data.shape[1] != 3:
        raise ValueError(
            f"expected a (N, 3) [t, x, u] array in {path!r}, got {data.shape}"
        )
    return np.asarray(data, np.float32)


class TravelingWave(PointWiseData):
    """1-D K=4 wave packet, 2000 points, standard-normalized (tutorial 1).

    Defaults reproduce the reference's ``traveling_wave.npz`` to f32
    rounding; ``path=`` loads such a file directly (reference
    traveling_wave.py:29-36 semantics)."""

    wavenumber = 4.0

    def __init__(self, n_t: int = 10, n_x: int = 200, path: str = None):
        if path is not None:
            data = _load_reference_npz(path)
            n_t = len(np.unique(data[:, 0]))
            n_x = data.shape[0] // max(n_t, 1)
        else:
            data = _traveling_wave_raw(n_t, n_x, self.wavenumber)
        super().__init__(data[:, [0]], data[:, [1]], data[:, [2]])
        self.data, self.mean, self.std = self.standard_normalize(self.data_raw)
        self.n_t, self.n_x_grid = n_t, n_x


class TravelingWaveHighFreq(PointWiseData):
    """K=400 wave packet, minmax-normalized (tutorials 2/6/8).

    Defaults reproduce the reference's ``traveling_wave_high_freq.npz`` to
    f32 rounding (reference traveling_wave_high_freq.py:32-41 semantics)."""

    wavenumber = 400.0

    def __init__(self, n_t: int = 10, n_x: int = 200, path: str = None):
        if path is not None:
            data = _load_reference_npz(path)
            n_t = len(np.unique(data[:, 0]))
            n_x = data.shape[0] // max(n_t, 1)
        else:
            data = _traveling_wave_raw(n_t, n_x, self.wavenumber)
        super().__init__(data[:, [0]], data[:, [1]], data[:, [2]])
        self.data, self.mean, self.std = self.minmax_normalize(
            self.data_raw, n_para=self.n_p, n_x=self.n_x, n_target=1
        )
        self.n_t, self.n_x_grid = n_t, n_x


class CylinderFlow(PointWiseData):
    """2-D cylinder-flow data with AMR-style area weights (tutorial 3
    schema: [t, x, y, u, v, area], minmax + area-weighted normalization —
    reference cylinderflow.py:8-40).

    The reference's ``cylinderflow.npz`` blob is stripped from its own
    mirror, so the default is a synthetic vortex-street-like stand-in with
    the same schema; pass ``path=`` to load a real reference-layout file
    (single ``data`` array of ``[t, x, y, u, v, area]`` rows)."""

    def __init__(self, n_t: int = 10, n_pts: int = 600, seed: int = 0,
                 path: str = None):
        if path is not None:
            data = np.asarray(np.load(path)["data"], np.float32)
            if data.ndim != 2 or data.shape[1] != 6:
                raise ValueError(
                    f"expected a (N, 6) [t, x, y, u, v, area] array in "
                    f"{path!r}, got {data.shape}"
                )
        else:
            rng = np.random.default_rng(seed)
            t = np.repeat(np.linspace(0.0, 1.0, n_t, endpoint=False), n_pts)
            # Scattered points, denser near the "cylinder" at the origin —
            # mimicking adaptive mesh refinement.
            r = rng.uniform(0.15, 1.0, size=n_t * n_pts) ** 1.5 * 4.0 + 0.5
            th = rng.uniform(-np.pi, np.pi, size=n_t * n_pts)
            x = r * np.cos(th)
            y = r * np.sin(th) * 0.5
            # Cell area grows with distance from the body (coarser cells).
            area = (0.05 + 0.1 * r) ** 2
            # Advecting vortex street: alternating vortices downstream.
            k, om = 2.0 * np.pi / 2.0, 2.0 * np.pi
            psi = np.exp(-(y**2) * 2.0) * np.sin(k * x - om * t)
            u = 1.0 - np.exp(-(y**2)) * np.cos(k * x - om * t) * 0.5
            v = psi * 0.5
            data = np.stack([t, x, y, u, v, area], axis=-1).astype(np.float32)
        super().__init__(data[:, [0]], data[:, [1, 2]], data[:, [3, 4]], data[:, -1:])
        self.data, self.mean, self.std, self.sample_weight = self.minmax_normalize(
            self.data_raw, n_para=self.n_p, n_x=self.n_x, n_target=2, area_weighted=True
        )
