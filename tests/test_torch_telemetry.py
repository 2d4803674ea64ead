"""The port's span and host-read recorder (io/telemetry.py): spans nest
with their parents, nothing is recorded and no clock read outside a
recording, the spans share the profiler's absolute clock, and on a block
of each benchmarked app every scalar read the profiler sees
(`aten::_local_scalar_dense`) is a counted `host_read`, under the span tree
of the step."""

import math
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim
from mundy_tpu_torch.driver.regrow import run_blocks
from mundy_tpu_torch.io import telemetry
from mundy_tpu_torch.io.telemetry import at_step, host_read, recording, trace


def _box(n: int) -> float:
    """The periodic box of n spheres of radius 0.5 at volume fraction 0.05."""
    return (n * 4.0 / 3.0 * math.pi * 0.125 / 0.05) ** (1 / 3)


def test_spans_nest_with_their_parents_and_steps():
    with recording() as rec:
        at_step(4)
        with trace("block"):
            with trace("step"):
                with trace("forces"):
                    pass
                host_read("probe", torch.tensor(3))
            at_step(5)
            with trace("step"):
                pass
        with trace("after"):
            pass
    names = [s[0] for s in rec.spans]
    assert names == ["block", "step", "forces", "read:probe", "step", "after"]
    parents = [s[3] for s in rec.spans]
    assert parents == [-1, 0, 1, 1, 0, -1]
    assert [s[4] for s in rec.spans] == [4, 4, 4, 4, 5, 5]
    for name, a, b, parent, _ in rec.spans:
        assert a <= b
        if parent >= 0:
            assert rec.spans[parent][1] <= a and b <= rec.spans[parent][2]
    with pytest.raises(RuntimeError, match="already open"):
        with recording():
            with recording():
                pass


def test_nothing_is_recorded_and_no_clock_read_outside_a_recording(monkeypatch):
    def clock():
        raise AssertionError("a clock was read outside a recording")

    monkeypatch.setattr(time, "time_ns", clock)
    assert trace("a") is trace("b")  # one shared no-op
    with trace("a"):
        at_step(3)
    before = dict(telemetry.reads)
    assert host_read("probe", torch.tensor(2.5)) == 2.5
    assert telemetry.reads["probe"] == before.get("probe", 0) + 1
    copied = host_read("probe.copy", torch.arange(3))
    assert copied.tolist() == [0, 1, 2] and telemetry.copies["probe.copy"] >= 1
    sim = SpheresSim(SpheresConfig(num_spheres=64, box_size=_box(64), diffusion_coeff=0.1,
                                   dtype="float32"), device="cpu")
    run_blocks(sim, sim.init(), 2, 2, log=lambda s: None)
    assert telemetry._rec is None


def test_a_span_brackets_the_profiler_event_on_the_absolute_clock():
    a = torch.rand((96, 96))
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace("mm"):
            torch.mm(a, a)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "aten::mm"]
    (_, s0, s1, _, _), = rec.spans
    assert s0 <= start_ns + round(1e3 * ev.time_range.start)
    assert start_ns + round(1e3 * ev.time_range.end) <= s1


# the parent each span of a benchmarked block may have (None: outside any)
TREE = {
    "block": {None}, "regrow": {None}, "read:overflow": {None},
    "rebuild": {"block", "refit"}, "step": {"block"}, "read:skin": {"block"},
    "forces": {"step"}, "integrate": {"step"}, "noise": {"step"},
    "assemble": {"step"}, "solve": {"step"},
    "bbpgd.iter": {"solve"}, "read:bbpgd.exit": {"solve"},
    "read:seg_sum.plain": {"solve", "bbpgd.iter"},
    "refit": {"block"}, "read:refit.overflow": {"refit"}, "read:refit.kmax": {"refit"},
    "refit.rows_slack": {"refit"}, "read:refit.occ_max": {"refit.rows_slack"},
    "read:resize.blk_max": {"refit"},
}


def _traced_block(sim, state, steps):
    """One run_blocks block under the profiler and a recording: (spans,
    scalar host reads counted, `aten::_local_scalar_dense` events)."""
    reads0 = sum(telemetry.reads.values())
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        run_blocks(sim, state, steps, steps, log=lambda s: None)
    reads = sum(telemetry.reads.values()) - reads0
    dense = sum(1 for e in prof.events() if e.name == "aten::_local_scalar_dense")
    return rec.spans, reads, dense


def _tree(spans) -> dict:
    """name -> the names of the parents its spans have."""
    out = {}
    for name, _, _, parent, _ in spans:
        out.setdefault(name, set()).add(spans[parent][0] if parent >= 0 else None)
    return out


@pytest.mark.parametrize("app", ["spheres", "lcp"])
def test_every_scalar_read_of_a_block_is_a_counted_host_read_in_the_span_tree(app):
    torch.manual_seed(0)
    if app == "spheres":
        n, steps = 2048, 6
        sim = SpheresSim(SpheresConfig(num_spheres=n, box_size=_box(n), diffusion_coeff=0.1,
                                       skin=0.4, max_neighbors=32, cell_capacity=8,
                                       dtype="float32"), device="cpu")
        want = {"block", "rebuild", "step", "forces", "noise", "integrate", "read:skin",
                "read:overflow"}
    else:
        n, steps = 2048, 3
        sim = LCPSpheresSim(LCPSpheresConfig(num_spheres=n, box_size=_box(n),
                                             diffusion_coeff=0.1, constraint_buffer=0.45,
                                             dtype="float32"), device="cpu")
        want = {"block", "step", "assemble", "noise", "solve", "bbpgd.iter",
                "read:bbpgd.exit", "integrate", "read:skin", "refit", "read:refit.overflow",
                "read:refit.kmax", "refit.rows_slack", "read:refit.occ_max",
                "read:resize.blk_max", "read:overflow"}
    state = sim.init()
    spans, reads, dense = _traced_block(sim, state, steps)
    assert reads == dense > 0
    assert reads == sum(1 for s in spans if s[0].startswith("read:"))
    tree = _tree(spans)
    assert want <= set(tree), want - set(tree)
    for name, parents in tree.items():
        assert parents <= TREE[name], (name, parents)
    assert sum(1 for s in spans if s[0] == "step") == steps
    steps_seen = [s[4] for s in spans if s[0] == "step"]
    assert steps_seen == list(range(steps_seen[0], steps_seen[0] + steps))
