"""The port imports neither JAX nor the JAX package: every module of
``nif_tpu_torch/``, ``chip_smoke.py`` and the port's scripts
(``scripts/port_*.py``) is parsed, and any import of ``jax``/``jaxlib``, of
the libraries of the JAX stack that import JAX (``optax``, ``flax``,
``orbax``) or of ``nif_tpu`` (other than ``nif_tpu_torch``) fails, relative
imports resolved against the module's package."""
import ast
import pathlib

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
