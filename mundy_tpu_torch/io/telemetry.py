"""Step telemetry: tps logging and profiler regions.

Port of mundy_tpu/io/telemetry.py (the reference's per-step tps reporting,
`HP1...neigh_linker.cpp:1375-1376,1496-1546`, and its Kokkos profiling
regions): `torch.profiler` owns deep traces; StepLogger owns the light
steady-state telemetry.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


class StepLogger:
    def __init__(self, total_steps: int, log_every: int = 100, log: Callable = print):
        self.total = total_steps
        self.every = log_every
        self.log = log
        self.t0 = time.perf_counter()
        self.last_t = self.t0
        self.last_step = 0

    def update(self, step: int, **extra) -> None:
        if step % self.every != 0 and step != self.total:
            return
        now = time.perf_counter()
        window_tps = (step - self.last_step) / max(now - self.last_t, 1e-12)
        overall_tps = step / max(now - self.t0, 1e-12)
        fields = "  ".join(f"{k}={v}" for k, v in extra.items())
        self.log(f"step {step}/{self.total}  tps={window_tps:.2f} (avg {overall_tps:.2f})  "
                 f"{fields}")
        self.last_t = now
        self.last_step = step

    def final_stats(self, **extra) -> dict:
        elapsed = time.perf_counter() - self.t0
        stats = {"total_steps": self.total, "elapsed_sec": elapsed,
                 "tps": self.total / max(elapsed, 1e-12), **extra}
        self.log("  ".join(f"{k}={v}" for k, v in stats.items()))
        return stats


@contextlib.contextmanager
def trace(name: str):
    """Named profiler region (the Kokkos::Profiling::pushRegion role)."""
    with torch.profiler.record_function(name):
        yield
