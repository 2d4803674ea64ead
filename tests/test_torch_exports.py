"""The port's public names: every name that a subpackage __init__ of the
JAX package imports from the package is importable from the port's
subpackage of the same name, and every module of the JAX package has a
module of the port at the same path that defines each of its public
top-level functions, classes (with their public methods) and assignments.
The reference is read with `ast`, so JAX is not imported; the exceptions
carry their reasons.

`ops/pallas/` is left out of the module check: its modules hold the TPU
layouts of the kernels (VMEM planners, MXU tile contractions), and their
counterparts are the modules of `ops/kernels/` of the same file names,
whose kernels and plain versions tests/test_torch_kernels.py and the
kernel files' own tests hold against the reference."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "mundy_tpu"
REF_INITS = sorted(REF.glob("*/__init__.py"))

# names the port leaves out, with the reason
EXCEPTIONS = {
    ("core", "pytree_dataclass"):
        "PyTorch has no pytrees: the port's container is "
        "core.containers.frozen_dataclass",
}


def _exports():
    for init in REF_INITS:
        sub = init.parent.name
        tree = ast.parse(init.read_text())
        for node in tree.body:
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.split(".")[0] == "mundy_tpu"):
                for alias in node.names:
                    yield sub, alias.asname or alias.name


EXPORTS = sorted(set(_exports()))

# (port module, name) pairs of the module check that the port leaves out
MODULE_EXCEPTIONS = {("mundy_tpu_torch.core.containers", "pytree_dataclass"):
                     EXCEPTIONS[("core", "pytree_dataclass")]}


_ABSENT = object()


def _public(name: str) -> bool:
    return not name.startswith("_")


def _defined_names(path: pathlib.Path) -> list:
    """Public top-level functions, classes, `Class.method`s and assigned
    names of a reference module, in source order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and _public(node.name):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and _public(m.name)]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name) and _public(t.id)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names += [node.target.id] if _public(node.target.id) else []
    return names


def _port_module(path: pathlib.Path) -> str:
    parts = path.relative_to(REF).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("mundy_tpu_torch",) + parts)


REF_MODULES = sorted(p for p in REF.rglob("*.py")
                     if p.relative_to(REF).parts[:2] != ("ops", "pallas"))


def test_the_reference_exports_were_read():
    subs = {sub for sub, _ in EXPORTS}
    assert {"forces", "math", "geom", "state", "neighbor", "mobility", "core",
            "constraints", "dynamics", "kmc", "mech", "io", "parallel"} <= subs
    assert len(EXPORTS) > 150


@pytest.mark.parametrize("sub,name", EXPORTS, ids=lambda v: str(v))
def test_reference_name_importable_from_port(sub, name):
    if (sub, name) in EXCEPTIONS:
        mod = importlib.import_module(f"mundy_tpu_torch.{sub}")
        assert not hasattr(mod, name), f"{name} is exported now: drop the exception"
        return
    mod = importlib.import_module(f"mundy_tpu_torch.{sub}")
    assert hasattr(mod, name), f"mundy_tpu_torch.{sub} lacks {name}"
    assert name in getattr(mod, "__all__", [name]) or not name[0].isalpha()


def test_the_reference_modules_were_read():
    assert len(REF_MODULES) > 80
    names = {(_port_module(p), n) for p in REF_MODULES for n in _defined_names(p)}
    assert ("mundy_tpu_torch.geom.periodicity", "Metric.shift_image") in names
    assert ("mundy_tpu_torch.parallel.spectral_shard", "make_sharded_se_rpy_apply") in names
    assert len(names) > 400


@pytest.mark.parametrize("path", REF_MODULES, ids=lambda p: str(p.relative_to(REF)))
def test_port_module_defines_the_reference_names(path):
    modname = _port_module(path)
    mod = importlib.import_module(modname)
    missing = []
    for name in _defined_names(path):
        obj = mod
        for attr in name.split("."):
            obj = getattr(obj, attr, _ABSENT)
        if (modname, name) in MODULE_EXCEPTIONS:
            assert obj is _ABSENT, f"{modname} defines {name} now: drop the exception"
        elif obj is _ABSENT:
            missing.append(name)
    assert not missing, f"{modname} lacks {missing}"


def test_frozen_dataclass_stands_in_for_pytree_dataclass():
    from mundy_tpu_torch.core import frozen_dataclass

    @frozen_dataclass
    class P:
        a: int = 1

    assert P().replace(a=2).a == 2
