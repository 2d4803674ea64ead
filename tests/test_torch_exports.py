"""The port's public names: every name that a subpackage __init__ of the
JAX package imports from the package is importable from the port's
subpackage of the same name. The reference's __init__s are read with
`ast`, so JAX is not imported; the exceptions carry their reasons."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_INITS = sorted((ROOT / "mundy_tpu").glob("*/__init__.py"))

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


def test_frozen_dataclass_stands_in_for_pytree_dataclass():
    from mundy_tpu_torch.core import frozen_dataclass

    @frozen_dataclass
    class P:
        a: int = 1

    assert P().replace(a=2).a == 2
