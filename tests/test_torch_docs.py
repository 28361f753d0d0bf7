"""The port's documentation, ``docs/torch/``: every public name of
``nif_tpu_torch`` and its subpackages and modules (each ``__all__``) is on
the API page, and the migration and performance pages say what they must."""
import importlib
import pathlib
import pkgutil

import pytest

import nif_tpu_torch

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "torch"


def _modules():
    """``nif_tpu_torch`` and every module under it with an ``__all__`` (the
    tutorials of ``examples/`` and the ``__main__`` scripts aside)."""
    names = ["nif_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(nif_tpu_torch.__path__, "nif_tpu_torch.")
        if ".examples" not in m.name and not m.name.rsplit(".", 1)[1].startswith("__")]
    return [n for n in names if hasattr(importlib.import_module(n), "__all__")]


_MODULES = _modules()


def test_every_subpackage_is_covered():
    packages = {m.name for m in pkgutil.iter_modules(nif_tpu_torch.__path__) if m.ispkg}
    assert packages - {"examples"} <= {n.split(".")[1] for n in _MODULES[1:]}
    assert "nif_tpu_torch.utils.roofline" in _MODULES


@pytest.mark.parametrize("module", _MODULES)
def test_api_page_names_every_public_name(module):
    text = (DOCS / "API.md").read_text()
    missing = [n for n in importlib.import_module(module).__all__ if f"`{n}`" not in text]
    assert not missing, f"{module}: not on docs/torch/API.md: {missing}"
    assert f"### `{module}`" in text


def test_migration_and_performance_pages():
    migration = (DOCS / "MIGRATION.md").read_text()
    for must in ("convert", "from_jax_params", "to_numpy_params", "torch.save", "orbax",
                 "--device", "precision.py", "_VMEM_", "NIF_COLSUM_MXU"):
        assert must in migration, must
    performance = (DOCS / "PERFORMANCE.md").read_text()
    for must in ("PERF.md", "kernel_cost", "kernel_bound_ms", "card_peaks", "step_report",
                 "mfu", "train_kernel_cost_model"):
        assert must in performance, must
