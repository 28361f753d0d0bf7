"""The port imports neither JAX nor the JAX package: every module of
``nif_tpu_torch/`` (``parallel/``, ``cli.py``, ``__main__.py``,
``utils/profiling.py``, ``entry.py`` and the thirteen tutorials of
``examples/`` among them), ``chip_smoke.py`` and the port's scripts
(``scripts/port_*.py``) is parsed, and any import of ``jax``/``jaxlib``, of
the libraries of the JAX stack that import JAX (``optax``, ``flax``,
``orbax``) or of ``nif_tpu`` (other than ``nif_tpu_torch``) fails, relative
imports resolved against the module's package. The worker's and the
command line's entry points also run in a process where those imports
raise, and so do the entry module's and every tutorial's."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "nif_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]
    + [p.relative_to(REPO).as_posix() for p in (REPO / "scripts").glob("port_*.py")]
)
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "orbax", "nif_tpu"}


def _imports(root: pathlib.Path, rel: str):
    """Every absolute module name the file ``root/rel`` imports (for
    ``from X import a``, X and X.a: either may be a module)."""
    package = list(pathlib.PurePosixPath(rel).parent.parts)
    for node in ast.walk(ast.parse((root / rel).read_text(), rel)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                if node.level - 1 >= len(package):
                    raise AssertionError(f"{rel}: a relative import climbs out of the package")
                base = ".".join(package[: len(package) - node.level + 1])
                name = f"{base}.{node.module}" if node.module else base
            else:
                name = node.module
            yield name
            yield from (f"{name}.{alias.name}" for alias in node.names)


def _forbidden(names):
    return [m for m in names if m.split(".")[0] in FORBIDDEN]


def test_the_port_has_modules_to_check():
    assert "nif_tpu_torch/__init__.py" in FILES and "chip_smoke.py" in FILES
    assert "nif_tpu_torch/ops/fused_shapenet.py" in FILES
    assert "nif_tpu_torch/ops/fused_hessian.py" in FILES
    assert "nif_tpu_torch/optimizers/lbfgs.py" in FILES
    assert "nif_tpu_torch/data/sharded_dataset.py" in FILES
    assert "nif_tpu_torch/compression/pruning.py" in FILES
    assert "nif_tpu_torch/compression/quantization.py" in FILES
    assert "nif_tpu_torch/serving/export.py" in FILES
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                "parallel/launch.py", "parallel/state.py", "parallel/zero.py",
                "parallel/collectives.py", "cli.py", "__main__.py", "utils/profiling.py"):
        assert f"nif_tpu_torch/{rel}" in FILES, rel
    assert "nif_tpu_torch/entry.py" in FILES
    examples = sorted(p.name for p in (REPO / "examples").glob("[0-9][0-9]_*.py"))
    assert len(examples) == 13
    for name in examples:  # each JAX tutorial has its port, under the same name
        assert f"nif_tpu_torch/examples/{name}" in FILES, name
    assert any(f.startswith("scripts/port_") for f in FILES)


@pytest.mark.parametrize("rel", FILES)
def test_module_imports_no_jax(rel):
    bad = _forbidden(_imports(REPO, rel))
    assert not bad, f"{rel} imports {bad}"


def test_the_check_catches_jax_imports(tmp_path):
    """The checker itself: absolute imports of JAX and of the JAX package
    are caught, the port's own imports (absolute or relative) are not, and
    a relative import out of the package fails."""
    sub = tmp_path / "nif_tpu_torch" / "sub"
    sub.mkdir(parents=True)
    (sub / "ok.py").write_text(
        "import numpy\nfrom nif_tpu_torch.config import NIFConfig\n"
        "from ..ops import _build\nfrom . import sibling\n")
    (sub / "bad.py").write_text(
        "import jax.numpy as jnp\nfrom nif_tpu.config import ShapeNetConfig\n"
        "from jaxlib import xla_client\nimport optax\nfrom orbax import checkpoint\n"
        "import flax.linen\n")
    (sub / "out.py").write_text("from ... import nif_tpu\n")
    assert _forbidden(_imports(tmp_path, "nif_tpu_torch/sub/ok.py")) == []
    assert "nif_tpu_torch.ops._build" in list(_imports(tmp_path, "nif_tpu_torch/sub/ok.py"))
    assert _forbidden(_imports(tmp_path, "nif_tpu_torch/sub/bad.py")) == [
        "jax.numpy", "nif_tpu.config", "nif_tpu.config.ShapeNetConfig", "jaxlib",
        "jaxlib.xla_client", "optax", "orbax", "orbax.checkpoint", "flax.linen"]
    with pytest.raises(AssertionError, match="climbs out"):
        list(_imports(tmp_path, "nif_tpu_torch/sub/out.py"))


# JAX and the JAX package made unimportable: any import of them raises.
_NO_JAX = ("import runpy, sys\n"
           "for m in ('jax', 'jaxlib', 'optax', 'flax', 'orbax', 'nif_tpu'):\n"
           "    sys.modules[m] = None\n"
           "sys.argv = [sys.argv[1], '--help']\n"
           "runpy.run_module(sys.argv[0], run_name='__main__')\n")


_EXAMPLES = sorted(p.stem for p in (REPO / "nif_tpu_torch" / "examples").glob("[0-9]*.py"))
_ENTRY_POINTS = [
    ("nif_tpu_torch.parallel.multihost", "--coordinator"),
    ("nif_tpu_torch", "{train,eval,export}"),
    ("nif_tpu_torch.entry", "--device"),
] + [(f"nif_tpu_torch.examples.{name}", "--" if name.startswith("12_") else "--device")
     for name in _EXAMPLES]


@pytest.fixture(scope="module")
def helps():
    """Every entry point's ``--help`` without JAX, the processes started at
    once: ``{module: (returncode, stdout, stderr)}``."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = {m: subprocess.Popen([sys.executable, "-c", _NO_JAX, m], env=env, cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m, _ in _ENTRY_POINTS}
    out = {}
    try:
        for m, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[m] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("module, want", _ENTRY_POINTS, ids=[m for m, _ in _ENTRY_POINTS])
def test_entry_points_run_without_jax(helps, module, want):
    """``python -m nif_tpu_torch.parallel.multihost --help`` (the worker's
    entry point), ``python -m nif_tpu_torch --help`` (the command line),
    ``python -m nif_tpu_torch.entry --help`` and each tutorial's ``--help``
    run in a process where importing JAX or the JAX package raises."""
    rc, stdout, stderr = helps[module]
    assert rc == 0, stderr[-2000:]
    assert "usage:" in stdout and want in stdout, stdout
