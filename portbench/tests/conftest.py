"""Shared pieces of the benchmark's tests: the repository root on the path,
tiny cells for the CPU and the card fixture.

Run with `python -m pytest portbench/tests -q` from the repository root; the
tests that need the card carry the `cuda` marker and skip here."""

import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("spheres_1m.steady", "spheres_1m.f64", "lcp_4m.steady")
TINY_N = 400


def tiny(n: int = TINY_N) -> dict:
    """The configuration overrides of a cell cut to n spheres at its
    volume fraction 0.05 (radius 0.5)."""
    return {"num_spheres": n, "box_size": (n * 4.0 / 3.0 * math.pi * 0.125 / 0.05) ** (1 / 3)}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch sees no CUDA device)")
    return "cuda"
