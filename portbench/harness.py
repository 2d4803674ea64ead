"""The benchmark's general part: it finds a cell's configuration, traffic
mix, driver, reference, limits and per-layer readers by name, runs the
cell once and returns its result line.

Layout (everything found by the names in BENCHMARK.json):
- `configs/<config>.json`: the app, its parameters, source and guarantees;
- `traffic/<mix>.json`: precision, set-up blocks, block length (the start
  state is uniform in the box, drawn on the device from the seed);
- `apps/<app>.py`: `Driver`, which drives the program's app;
- `reference/<app>.py`: `follow`, the plain reference of the app's steps,
  and optionally `guarantees`, what it reads off the program's end state;
- `limits/<cell>.json`: the limit of each number compared;
- `metrics/<quantity>.py`: `read(ctx)`, one per per-layer quantity.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
import types

import torch

from portbench import devtrace
from portbench.reference.common import max_gap

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
MASK = 0xFFFFFFFF
# top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "mundy_tpu")
# the control's precision: the nearest below the one the traffic states
CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def load_module(path: str):
    """Import a file of the benchmark by its path."""
    name = "portbench_" + os.path.relpath(path, BENCH).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def quantity(name: str) -> str:
    """A metric's quantity: its name before the first dot. The cells of one
    quantity that need different bounds report it under names of their own
    (`body_steps_per_s.lcp`), read by the one reader of the quantity."""
    return name.split(".")[0]


class Cell:
    """One workload of BENCHMARK.json and the files it names."""

    def __init__(self, name: str, root: str = ROOT, bench: str = BENCH, overrides=None,
                 app: str = None, fault=None):
        """`overrides` change the configuration for both sides (a smaller
        size in a test); `fault` changes the program's parameters alone,
        as a fault planted in it (a solver tolerance loosened)."""
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            spec = json.load(f)
        self.name = name
        self.workload = _by_name(spec["workloads"], name, "workload")
        entry = _by_name(spec["configs"], self.workload["config"], "configuration")
        with open(os.path.join(root, entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(bench, "traffic", self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(bench, "limits", name + ".json")) as f:
            self.limits = json.load(f)
        self.params = dict(self.config["params"], **(overrides or {}))
        self.program_params = dict(self.params, **(fault or {}))
        self.app = load_module(os.path.join(bench, "apps", (app or self.config["app"]) + ".py"))
        self.reference = load_module(os.path.join(bench, "reference", self.config["app"] + ".py"))
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
        self.readers = {m["name"]: load_module(os.path.join(
            bench, "metrics", quantity(m["name"]) + ".py")) for m in self.per_layer}
        self.dtype = getattr(torch, self.traffic["dtype"])


def key_words(seed: int) -> tuple:
    return ((seed >> 32) & MASK, seed & MASK)


def start_positions(seed: int, n: int, box: float, dtype, device) -> torch.Tensor:
    """(n, 3) positions uniform in the periodic box, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, 3), generator=gen, dtype=dtype, device=device) * box


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def loaded_forbidden(modules=None) -> list:
    """The FORBIDDEN top-level names among `modules` (default: those this
    process has loaded), each name compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float = None, log=None, control: bool = False) -> dict:
    """Run the cell once: set-up, the measured window, with `trace` a traced
    window of whole blocks after it, then the comparison with the reference.
    Returns the result line's object. With `control`, it also holds under
    "control" the gaps of the reference computed in CONTROL's precision in
    the program's place, from the same positions, and those of a step that
    returns its state unchanged (`<gap>.unchanged`)."""
    t_process = time.perf_counter() if t_process is None else t_process
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    p, tr = cell.params, cell.traffic
    n = int(p["num_spheres"])
    box = float(p["box_size"])
    kw = key_words(seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- set-up: the program built, started from the seed's inputs and
    # warmed up through the set-up blocks of the traffic mix
    pos0 = start_positions(seed, n, box, cell.dtype, device)
    drv = cell.app.Driver(cell.program_params, tr, device)
    state = drv.start(pos0, kw)
    steps_done, start_check = 0, None
    for k, blk in enumerate(tr["setup"]):
        before = pos0.clone() if k == 0 else drv.positions(state)
        state = drv.setup_block(state, blk)
        if blk.get("check"):
            start_check = (before, steps_done, blk["steps"], drv.positions(state))
        del before
        steps_done += blk["steps"]
    del pos0
    _sync(device)
    setup_s = time.perf_counter() - t_process

    # ---- the measured window: whole blocks until `seconds` have passed
    first = drv.counters(state)
    per_block = []
    regrows0 = drv.regrows
    t0 = time.perf_counter()
    while True:
        prev, prev_steps = state, steps_done
        state = drv.block(state)
        steps_done += drv.block_steps
        per_block.append(drv.counters(state))
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    win_steps = len(per_block) * drv.block_steps

    traced = None
    if trace:  # whole blocks under the profiler, after the measured window
        held = [state]
        k = int(tr.get("trace_blocks", 1))

        def window():
            for _ in range(k):
                held[0] = drv.block(held[0])

        prev, prev_steps = state, steps_done
        before = drv.counters(state)
        traced = devtrace.traced(window, k * drv.block_steps, on_card)
        state = held[0]
        steps_done += k * drv.block_steps
        traced.counters = (before, drv.counters(state))
        per_block.append(traced.counters[1])
    regrows = drv.regrows - regrows0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"memory peak {peak} bytes")

    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(trace=traced, driver=drv, state=state, device=device,
                                    per_block=per_block, first_counters=first)
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"body_steps_per_s": n * win_steps / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[quantity(m["name"])], "unit": m["unit"]}

    # ---- what the timed path produced; then the program is freed
    last = (drv.positions(prev), prev_steps, steps_done - prev_steps, drv.positions(state))
    checks = drv.checks(state)
    checks["regrows"] = (regrows, 0)
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        info["busy_s"] = traced.busy_s
        info["window_s"] = traced.wall_s
    del drv, state, prev
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the reference follows the checked set-up block and the last blocks
    t_ref = time.perf_counter()
    compared, ctrl = {}, {}
    for label, (before, step0, count, after) in (("start_gap", start_check), ("end_gap", last)):
        ref = cell.reference.follow(p, before, kw, step0, count)
        compared[label] = (max_gap(after, ref, box), float(cell.limits[label]))
        if control:
            low = cell.reference.follow(p, before, kw, step0, count, dtype=CONTROL[cell.dtype])
            ctrl[label] = max_gap(low, ref, box)
            ctrl[label + ".unchanged"] = max_gap(before, ref, box)
        del ref
    # the guarantees the reference reads off the program's end positions
    if hasattr(cell.reference, "guarantees"):
        for label, v in cell.reference.guarantees(p, last[3]).items():
            compared[label] = (v, float(cell.limits[label]))
    compared.update(checks)
    reference_s = time.perf_counter() - t_ref
    log(f"reference {reference_s:.1f} s")
    correct = all(math.isfinite(v) and v <= lim for v, lim in compared.values())

    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"portbench: modules of JAX or the JAX package loaded: {bad}")
    out = {"correct": correct, "attempted": len(per_block), "failed": regrows,
           "metrics": metrics, "device": info}
    if trace:
        out["breakdown"] = traced.breakdown()
    out["reference_s"] = reference_s
    if control:
        out["control"] = ctrl
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out

