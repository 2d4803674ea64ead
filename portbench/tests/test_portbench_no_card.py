"""A run without a card, or without the program beside the benchmark, fails
and prints no result: it never falls back to the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

ARGS = ["--workload", "spheres_1m.steady", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd: str):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.strip().splitlines()[-1:]:
        try:
            return not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            return True
    return True


def test_without_a_card_the_run_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out.stdout)
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and _no_result(out.stdout)
