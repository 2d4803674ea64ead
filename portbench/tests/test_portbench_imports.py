"""What a run may load: nothing of JAX or the JAX package, and references
that load nothing of the program."""

import glob
import json
import os
import subprocess
import sys

from .conftest import ROOT

_PROBE = r"""
import importlib, json, os, sys
sys.path.insert(0, {root!r})
from portbench import harness
mods = [harness.load_module(p) for p in {paths!r}]
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def _loaded(paths) -> set:
    code = _PROBE.format(root=ROOT, paths=paths)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _files(sub: str) -> list:
    return sorted(p for p in glob.glob(os.path.join(ROOT, "portbench", sub, "*.py"))
                  if not p.endswith("__init__.py"))


def test_the_harness_loads_no_jax_and_no_jax_package():
    tops = _loaded(_files("apps") + _files("reference") + _files("metrics")
                   + [os.path.join(ROOT, "portbench", "run.py")])
    assert "mundy_tpu_torch" in tops  # the program is what it drives
    assert not tops & {"jax", "jaxlib", "flax", "mundy_tpu"}


def test_the_references_load_nothing_of_the_program():
    tops = _loaded(_files("reference"))
    assert not tops & {"jax", "jaxlib", "flax", "mundy_tpu", "mundy_tpu_torch"}


def test_the_forbidden_check_compares_whole_top_level_names():
    from portbench import harness

    assert harness.loaded_forbidden(["mundy_tpu_torch.driver", "mundy_tpu_torch", "numpy"]) == []
    assert harness.loaded_forbidden(["mundy_tpu.driver.apps", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "mundy_tpu"]


def test_benchmark_json_names_only_what_exists():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in spec["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert os.path.exists(os.path.join(ROOT, "portbench", "apps", cfg["app"] + ".py"))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", w["name"] + ".json"))
    for m in spec["per_layer"]:
        name = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", name + ".py"))
