"""ctypes binding of the native data-loading kernels (counterpart of
``nif_tpu/data/nifio.py``; ``_nifio.cpp`` beside this file is a byte-for-byte
copy of the JAX package's).

The library is built with ``g++`` on first use into ``build/nif_tpu_torch/``
at the root of the checkout (its file name carries a hash of the source and
the flags, so a stale build is never loaded), never at import time. Without
a compiler, or with ``NIF_NO_NATIVE`` set, the numpy versions run;
:func:`native_available` says which.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["gather_rows", "permute_rows", "f32_to_bf16", "native_available"]

_SRC = Path(__file__).resolve().parent / "_nifio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nif_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnifio-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile into a temporary file renamed into place, so a concurrent
    build never sees a partial library."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get("NIF_NO_NATIVE"):  # force the numpy fallback
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        target = _target()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        i64 = ctypes.c_int64
        lib.nifio_gather_rows.argtypes = [
            ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64, ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.nifio_gather_rows.restype = i64
        lib.nifio_permute_rows.argtypes = [
            ctypes.c_void_p, i64, i64, ctypes.c_uint64, ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.nifio_f32_to_bf16.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library is built and loaded (the numpy versions
    run otherwise)."""
    return _load() is not None


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """out[i] = src[idx[i]] — multithreaded when the native lib is built."""
    lib = _load()
    if lib is None or src.dtype != np.float32 or not src.flags["C_CONTIGUOUS"]:
        return np.ascontiguousarray(src, dtype=np.float32)[idx]
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((idx.shape[0], src.shape[1]), dtype=np.float32)
    n_bad = lib.nifio_gather_rows(
        src.ctypes.data, src.shape[0], src.shape[1],
        idx.ctypes.data, idx.shape[0], out.ctypes.data, n_threads,
    )
    if n_bad:
        raise IndexError(
            f"gather_rows: {n_bad} indices out of range [0, {src.shape[0]})"
        )
    return out


def permute_rows(src: np.ndarray, seed: int, n_threads: int = 0) -> np.ndarray:
    """Return src with rows shuffled (Fisher-Yates inside the native lib)."""
    lib = _load()
    if lib is None or src.dtype != np.float32:
        rng = np.random.default_rng(seed)
        return np.ascontiguousarray(src, dtype=np.float32)[
            rng.permutation(src.shape[0])
        ]
    src = np.ascontiguousarray(src, dtype=np.float32)
    out = np.empty_like(src)
    lib.nifio_permute_rows(
        src.ctypes.data, src.shape[0], src.shape[1],
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), out.ctypes.data, n_threads,
    )
    return out


def f32_to_bf16(src: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 conversion (returns uint16 view)."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    if lib is None:
        bits = src.view(np.uint32)
        lsb = (bits >> 16) & 1
        rounded = (
            ((bits.astype(np.uint64) + 0x7FFF + lsb) >> 16)
        ).astype(np.uint16)
        # NaN guard (mirrors the native kernel): the rounding carry wraps
        # high-payload NaNs to +/-0 — emit a sign-preserving quiet NaN.
        nan = (bits & 0x7FFFFFFF) > 0x7F800000
        return np.where(nan, ((bits >> 16) | 0x0040).astype(np.uint16),
                        rounded)
    out = np.empty(src.shape, dtype=np.uint16)
    lib.nifio_f32_to_bf16(src.ctypes.data, src.size, out.ctypes.data, n_threads)
    return out
