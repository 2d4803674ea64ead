"""The program's spans read against a trace (`portbench/spans.py`): device
time goes to the span in which its launch call was made, idle time is
split at span boundaries and sums to the window's idle, and against a
program that records no spans every reader of them reports nothing."""

import types

import pytest
import torch

from portbench import devtrace, harness, spans

from .conftest import ROOT

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
T0 = 1_700_000_000_000_000_000  # the trace's absolute start, ns


class _Ev:
    def __init__(self, name, a, b, dev, cid=0):
        self.name = name
        self.time_range = type("T", (), {"start": a, "end": b})
        self.device_type = dev
        self.id = cid


def _span(name, a_us, b_us, parent, step=0):
    return (name, T0 + int(1e3 * a_us), T0 + int(1e3 * b_us), parent, step)


# block [0, 100] > step [5, 60] > noise [10, 20], solve [20, 55] > bbpgd.iter
# [25, 40]; block > refit [70, 95]
SPANS = [_span("block", 0, 100, -1), _span("step", 5, 60, 0), _span("noise", 10, 20, 1),
         _span("solve", 20, 55, 1), _span("bbpgd.iter", 25, 40, 3), _span("refit", 70, 95, 0)]
EVENTS = [_Ev("aten::x", 0, 100, CPU, 7), _Ev("aten::y", 100, 110, CPU, 8),
          _Ev("cudaLaunchKernel", 12, 13, CPU, 1), _Ev("cudaLaunchKernel", 30, 31, CPU, 2),
          _Ev("cudaLaunchKernel", 62, 63, CPU, 3), _Ev("cuLaunchKernel", 75, 76, CPU, 4),
          _Ev("k_noise", 14, 18, CUDA, 1), _Ev("k_iter", 32, 45, CUDA, 2),
          _Ev("k_block", 64, 66, CUDA, 3), _Ev("k_refit", 80, 85, CUDA, 4),
          _Ev("memcpy", 90, 91, CUDA, 99)]


def test_device_time_goes_to_the_span_of_its_launch():
    t = spans.SpanTrace(EVENTS, 110e-6, steps=2, start_ns=T0, spans=SPANS)
    got = {k: pytest.approx(v * 1e6) for k, v in t.device_by_span.items()}
    assert got == {"noise": 4, "bbpgd.iter": 13, "block": 2, "refit": 5, "": 1}
    assert t.span_device_s("solve") == 0.0
    assert t.span_device_s("solve", inclusive=True) == pytest.approx(13e-6)
    assert t.span_device_s("step", inclusive=True) == pytest.approx(17e-6)
    assert t.unlaunched == 1  # the op whose correlation id no launch call has
    # the readings devtrace.Trace makes of the same events are unchanged
    base = devtrace.Trace(EVENTS, 110e-6, steps=2)
    assert (t.busy_s, dict(t.idle_by_host)) == (base.busy_s, dict(base.idle_by_host))


def test_idle_is_split_by_overlap_and_sums_to_the_windows_idle():
    t = spans.SpanTrace(EVENTS, 110e-6, steps=2, start_ns=T0, spans=SPANS)
    got = {k: pytest.approx(v * 1e6) for k, v in t.idle_by_span.items()}
    # gaps [0,14] [18,32] [45,64] [66,80] [85,90] [91,110], cut at the spans
    assert got == {"block": 18, "step": 10, "noise": 6, "solve": 15, "bbpgd.iter": 7,
                   "refit": 19, "": 10}
    assert sum(t.idle_by_span.values()) == pytest.approx(sum(t.idle_by_host.values()))
    assert t.span_idle_s("solve", inclusive=True) == pytest.approx(22e-6)
    assert t.span_idle_s("block", inclusive=True) == pytest.approx(75e-6)
    s = t.summary()
    assert s["idle_s"] == pytest.approx(s["idle_by_host_s"]) and s["idle_by_span"][0][0] == "refit"


def test_a_traced_run_on_the_cpu_records_spans_and_reads():
    from mundy_tpu_torch.io.telemetry import host_read, trace

    def run():
        with trace("block"):
            with trace("step"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
            host_read("skin", torch.tensor(True))

    t = spans.traced(run, 1, on_card=False)
    assert [s[0] for s in t.spans] == ["block", "step", "read:skin"]
    assert t.reads == 1 == t.per_step(devtrace.HOST_READS)
    assert t.busy_s == 0.0 and sum(t.idle_by_span.values()) == pytest.approx(
        sum(t.idle_by_host.values()))


NEW = ("host_reads_per_step", "noise_device_ms_per_step", "contact_device_ms_per_step",
       "rebuild_device_ms_per_step", "assemble_device_ms_per_step", "solve_device_ms_per_step",
       "solve_idle_ms_per_step", "refit_idle_ms_per_step")


def _ctx(block):
    drv = types.SimpleNamespace(block=block, block_steps=2)
    return types.SimpleNamespace(driver=drv, state="state", device="cpu")


def test_against_a_program_without_spans_the_readers_report_nothing(monkeypatch):
    from mundy_tpu_torch.io import telemetry

    monkeypatch.delattr(telemetry, "recording")

    def block(state):
        raise AssertionError("no block runs for a program without spans")

    ctx = _ctx(block)
    for name in NEW:
        mod = harness.load_module(f"{ROOT}/portbench/metrics/{name}.py")
        assert mod.read(ctx) is None


def test_the_readers_on_the_cpu_report_reads_and_no_device_time():
    from mundy_tpu_torch.io.telemetry import host_read, trace

    runs = []

    def block(state):
        runs.append(state)
        with trace("block"):
            host_read("skin", torch.tensor(False))
        return state

    ctx = _ctx(block)
    values = {name: harness.load_module(f"{ROOT}/portbench/metrics/{name}.py").read(ctx)
              for name in NEW}
    assert runs == ["state"]  # one block, shared by every reader
    assert values.pop("host_reads_per_step") == 0.5
    assert set(values.values()) == {None}  # no device: no device time or idle
