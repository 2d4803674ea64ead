"""Each cell's driver and reference agree at a tiny size on the CPU, where
the program runs its plain paths; the control, the reference in the next
lower precision put in the program's place, fails the cell's limits; and a
run with the timed path broken underneath comes out not correct."""

import pytest
import torch

from portbench import harness

from .conftest import CELLS, tiny

SEED = 2 ** 32 + 2 ** 31 + 17


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name in CELLS:
        cell = harness.Cell(name, overrides=tiny())
        out[name] = harness.run(cell, SEED, 0.01, False, "cpu", control=True)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_is_correct_at_a_tiny_size(runs, name):
    out = runs[name]
    assert out["correct"], out["compared"]
    for label in ("start_gap", "end_gap"):
        assert out["compared"][label]["value"] < out["compared"][label]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(runs, name):
    out = runs[name]
    assert any(out["control"][k] > out["compared"][k]["limit"] for k in out["control"])


def _unchanged(orig):
    def step(self, state):
        return state.replace(step=state.step + 1)
    return step


def _half(orig):
    def step(self, state):
        new = orig(self, state)
        pos = new.pos.clone()
        pos[: pos.shape[0] // 2] = state.pos[: pos.shape[0] // 2]
        return new.replace(pos=pos)
    return step


def _altered(orig):
    def step(self, state):
        new = orig(self, state)
        pos = new.pos.clone()
        pos[7, 1] += 0.01
        return new.replace(pos=pos)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", ["spheres_1m.steady", "lcp_4m.steady"])
def test_a_broken_step_in_the_window_is_not_correct(monkeypatch, name, fault):
    cell = harness.Cell(name, overrides=tiny())
    sim_cls = type(cell.app.Driver(cell.params, cell.traffic, "cpu").sim)
    orig_block = cell.app.Driver.block

    def block(self, state):  # the fault enters with the measured window
        if not getattr(sim_cls, "_faulty", False):
            monkeypatch.setattr(sim_cls, "_inner_step", fault(sim_cls._inner_step))
            monkeypatch.setattr(sim_cls, "_faulty", True, raising=False)
        return orig_block(self, state)

    monkeypatch.setattr(cell.app.Driver, "block", block)
    out = harness.run(cell, SEED, 0.01, False, "cpu")
    assert out["compared"]["start_gap"]["value"] <= out["compared"]["start_gap"]["limit"]
    assert not out["correct"]
    assert out["compared"]["end_gap"]["value"] > out["compared"]["end_gap"]["limit"]


def test_a_loosened_solver_tolerance_is_not_correct():
    """The program's BBPGD stopped at a tolerance 1000 times the stated one
    leaves overlaps past the cell's limit, which the stated tolerance keeps
    (the position gaps alone would not see it)."""
    cell = harness.Cell("lcp_4m.steady", overrides=tiny(), fault={"max_allowable_overlap": 1e-2})
    out = harness.run(cell, SEED, 0.01, False, "cpu")
    assert out["compared"]["overlap"]["value"] > out["compared"]["overlap"]["limit"]
    assert not out["correct"]
