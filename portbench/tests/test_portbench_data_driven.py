"""A configuration, traffic mix, driver, reference, limits and per-layer
metric that live only in a temporary directory are found by name and run
by the harness, with no file of portbench edited."""

import json
import textwrap

from portbench import harness

DRIVER = '''
import torch

class Driver:
    """A drift of every body by `drift` a step: the smallest app."""

    def __init__(self, params, traffic, device):
        self.drift = float(params["drift"])
        self.box = float(params["box_size"])
        self.block_steps = int(traffic["block_steps"])
        self.regrows = 0

    def start(self, pos, key_words):
        return {"pos": pos, "step": 0}

    def _steps(self, state, n):
        return {"pos": torch.remainder(state["pos"] + n * self.drift, self.box),
                "step": state["step"] + n}

    def setup_block(self, state, block):
        return self._steps(state, block["steps"])

    def block(self, state):
        return self._steps(state, self.block_steps)

    def positions(self, state):
        return state["pos"].clone()

    def checks(self, state):
        return {"nonfinite": (int((~torch.isfinite(state["pos"])).sum()), 0)}

    def counters(self, state):
        return {"step": state["step"]}
'''

REFERENCE = '''
def follow(params, pos, key_words, step0, n_steps, dtype=None):
    import torch
    p = pos.to(dtype or torch.float64)
    for _ in range(n_steps):
        p = torch.remainder(p + float(params["drift"]), float(params["box_size"]))
    return p
'''

METRIC = '''
def read(ctx):
    """Blocks driven, as a stand-in for a per-layer reading."""
    return float(len(ctx.per_block))
'''


def _bench(tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "apps", "reference", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
    (bench / "apps" / "drift.py").write_text(textwrap.dedent(DRIVER))
    (bench / "reference" / "drift.py").write_text(textwrap.dedent(REFERENCE))
    (bench / "metrics" / "blocks_driven.py").write_text(textwrap.dedent(METRIC))
    (bench / "configs" / "drift_small.json").write_text(json.dumps(
        {"name": "drift_small", "app": "drift",
         "params": {"num_spheres": 64, "box_size": 10.0, "drift": 0.01}}))
    (bench / "traffic" / "steady.json").write_text(json.dumps(
        {"dtype": "float64", "setup": [{"steps": 2, "check": True}],
         "block_steps": 5, "trace_blocks": 2}))
    (bench / "limits" / "drift.steady.json").write_text(json.dumps(
        {"start_gap": 1e-12, "end_gap": 1e-12}))
    spec = {"configs": [{"name": "drift_small", "file": "portbench/configs/drift_small.json"}],
            "workloads": [{"name": "drift.steady", "config": "drift_small",
                           "traffic": "steady", "chips": 1}],
            "end_to_end": [{"name": "body_steps_per_s", "unit": "body-steps/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "blocks_driven", "unit": "blocks",
                           "workloads": ["drift.steady"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def test_a_cell_of_new_files_runs_untraced_and_traced(tmp_path):
    bench = _bench(tmp_path)
    cell = harness.Cell("drift.steady", root=str(tmp_path), bench=str(bench))
    out = harness.run(cell, 2 ** 33 + 5, 0.05, False, "cpu")
    assert out["correct"] and set(out["metrics"]) == {"body_steps_per_s", "setup_s"}
    assert out["compared"]["end_gap"]["value"] < 1e-12
    out = harness.run(cell, 2 ** 33 + 5, 0.05, True, "cpu")
    assert out["correct"] and out["metrics"]["blocks_driven"]["value"] >= 3
    assert list(out)[-1] == "compared"
