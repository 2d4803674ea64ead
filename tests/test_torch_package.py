"""Package rules of the torch port: no JAX anywhere, no silent fallback.

The import scan reads the sources (AST), not sys.modules, because the
interpreter may preload JAX on its own.
"""

import ast
import pathlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu_torch.ops.kernels import _build
from mundy_tpu_torch.ops.kernels import row_central as k1

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mundy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "mundy_tpu"), f"{path} imports {mod}"


def test_cuda_sim_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RowSpheresSim(SpheresConfig(num_spheres=100, box_size=16.0), device="cuda")


def test_k1_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor never takes the plain version: with no library and no
    compiler the wrapper raises (a fake CUDA tensor stands in for a card)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k1, "row_hertzian_forces_plain", no_plain)
    before = k1.row_hertzian_forces_sym.launches
    with FakeTensorMode():
        pos = torch.zeros((8, 8, 16, 3), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k1.row_hertzian_forces_sym(pos, (12.0,) * 3, 0.5, 1000.0, 0.3)
    assert k1.row_hertzian_forces_sym.launches == before
    _build.load.cache_clear()


def test_k1_library_is_keyed_by_source():
    lib = _build.library_path("row_central")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("row_central_") and lib.suffix == ".so"
