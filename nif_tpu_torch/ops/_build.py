"""Build and load the port's hand-written CUDA kernels.

Each ``nif_tpu_torch/csrc/<name>.cu`` has a plain C interface. On first use
it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/nif_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``. The sources share device helpers through ``csrc/*.cuh``. The
library's file name carries a hash of the source, the headers it includes
(followed transitively) and the flags, so an edited source or header
rebuilds the libraries that use it, and only those, and a stale library is
never loaded.
Nothing here runs at import time: this module imports on a CPU-only torch.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a caller can show that a
path really ran through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["LAUNCHES", "build", "load_library", "reset_launches"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nif_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {"shapenet_fwd": 0, "shapenet_fwd_tc": 0, "shapenet_fwd_wg": 0,
                            "shapenet_mse_grads": 0,
                            "shapenet_mse_grads_tc": 0, "shapenet_mse_grads_wg": 0,
                            "shapenet_bwd": 0, "shapenet_bwd_tc": 0, "shapenet_bwd_wg": 0,
                            "shapenet_fwd_jac": 0, "shapenet_fwd_jac_tc": 0,
                            "shapenet_fwd_jac_wg": 0,
                            "shapenet_sobolev_grads": 0,
                            "shapenet_sobolev_grads_tc": 0,
                            "shapenet_fwd_hess": 0, "shapenet_fwd_hess_tc": 0,
                            "shapenet_fwd_hess_wg": 0,
                            "shapenet_hessian_grads": 0, "shapenet_hessian_grads_tc": 0,
                            "shapenet_hessian_grads_wg": 0,
                            "niflinear_mse_grads": 0, "niflinear_mse_grads_tc": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: ptxas's report (registers, shared memory, spills) of each build
BUILD_LOGS: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
            "the CUDA kernels are built from source on first use"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it ``#include``s in
    quotes, followed transitively, each once, in the order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists():
                todo.append(header)
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    # the source and the headers it includes, so a header's edit rebuilds
    # only the libraries that use it
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless it is built; returns the library path.
    nvcc writes a temporary file that is renamed into place, so a concurrent
    build never sees a partial library."""
    target = _target(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOGS[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
