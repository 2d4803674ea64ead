"""The program's spans read against a profiler trace: device time and
device idle time by phase of the step, and the host reads the program
counts.

The program records spans while a `recording()` of
`mundy_tpu_torch.io.telemetry` is open: (name, start_ns, end_ns, parent,
step), stamped with `time.time_ns()`, the clock of the profiler's events
(the trace's `trace_start_ns()` plus an event's relative start). `of(ctx)`
runs one more block of the cell's run loop after the traced window, under
the profiler and a recording, and reads it as a `SpanTrace`:
- each device operation goes to the innermost span in which the host made
  its launch call (the runtime or driver call of the same correlation id);
- each stretch of device idle time goes to the innermost span that covers
  it, each gap split at the span boundaries inside it, so the pieces sum to
  the idle that `devtrace.Trace.idle_by_host` takes over the same window
  ("" where no span covers a piece).

Against a program that records no spans (one without `recording`), `of`
returns None and runs nothing, and the readers of these metrics report
nothing.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
import sys
import time

import torch

from portbench import devtrace

# the host calls that launch device work: CUDA runtime and driver API calls
LAUNCH_CALL = re.compile(r"cu(da)?[A-Z]")
# the profiler's own events that `prof.events()` leaves out
SKIPPED = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                     "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                     "aten::is_leaf", "aten::output_nr", "aten::_version"))

_Range = collections.namedtuple("_Range", "start end")
_Event = collections.namedtuple("_Event", "name time_range device_type id")


def kineto_events(results) -> list:
    """The events of a profiler's `kineto_results` in the shape
    `devtrace.Trace` reads (`name`, `time_range` in microseconds from the
    trace's start, `device_type`, `id` the correlation id), without the
    tree of `prof.events()`, whose building takes most of a large trace's
    reading time (and which merges an op nested in one of its own name, so
    host counts of such ops differ; busy and idle time do not)."""
    t0 = results.trace_start_ns()
    out = []
    for e in results.events():
        name = e.name()
        if name in SKIPPED or getattr(e, "is_hidden_event", lambda: False)():
            continue
        out.append(_Event(name, _Range(1e-3 * (e.start_ns() - t0), 1e-3 * (e.end_ns() - t0)),
                          e.device_type(), e.correlation_id()))
    return out


class SpanTrace(devtrace.Trace):
    """A traced window read as `devtrace.Trace` reads it, with the program's
    spans of the same window. `start_ns` is the trace's absolute start;
    `spans` the recording's (name, start_ns, end_ns, parent, step) in the
    order they opened; `reads` the program's scalar host reads in the
    window."""

    def __init__(self, events, wall_s: float, steps: int, start_ns: int, spans, reads: int = 0):
        super().__init__(events, wall_s, steps)
        self.start_ns = start_ns
        self.spans = list(spans)
        self.reads = reads
        # span bounds on the events' clock: microseconds from the trace's
        # start (a span left open ends where it started)
        self._a = [1e-3 * (s[1] - start_ns) for s in self.spans]
        self._b = [1e-3 * ((s[1] if s[2] is None else s[2]) - start_ns) for s in self.spans]
        self._parent = [s[3] for s in self.spans]
        self._bounds = sorted(self._a + self._b)
        cpu_t = torch.autograd.DeviceType.CPU
        launch = {}  # correlation id -> host start of the launch call
        host, device = [], []
        for e in events:
            if e.device_type == cpu_t:
                host.append((e.time_range.start, e.time_range.end))
                if LAUNCH_CALL.match(e.name):
                    launch[getattr(e, "id", None)] = e.time_range.start
            else:
                device.append((e.time_range.start, e.time_range.end, e.name,
                               getattr(e, "id", None)))
        # (start, end, name, host start of the launch or None) of each device op
        self.ops = [(a, b, name, launch.get(cid)) for a, b, name, cid in device]
        self.unlaunched = sum(1 for op in self.ops if op[3] is None)
        self.device_by_span = collections.defaultdict(float)  # innermost
        self._device_in = collections.defaultdict(float)  # any covering span
        for a, b, _, t in self.ops:
            k = self._innermost(t) if t is not None else -1
            self._add(self.device_by_span, self._device_in, k, 1e-6 * (b - a))
        self.idle_by_span = collections.defaultdict(float)
        self._idle_in = collections.defaultdict(float)
        for a, b in self._idle_gaps(device, host):
            self._split(a, b)

    @staticmethod
    def _idle_gaps(device, host) -> list:
        """The device idle gaps of the window, as `devtrace.Trace` takes
        them: between the merged device intervals, from the first host
        event's start to the last host end."""
        if not host:
            return []
        merged = []
        for a, b, *_ in sorted(device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        lo, hi = min(h[0] for h in host), max(h[1] for h in host)
        edges = [(lo, lo)] + [tuple(m) for m in merged] + [(hi, hi)]
        return [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]

    def _innermost(self, t: float) -> int:
        """Index of the innermost span covering time t, or -1. Spans nest
        (one thread, opened and closed in order), so the covering spans of
        t are the last span opened by t and those of its ancestors that
        have not closed."""
        k = bisect.bisect_right(self._a, t) - 1
        while k >= 0 and self._b[k] < t:
            k = self._parent[k]
        return k

    def _add(self, inner: dict, within: dict, k: int, v: float) -> None:
        inner[self.spans[k][0] if k >= 0 else ""] += v
        seen = set()
        while k >= 0:
            name = self.spans[k][0]
            if name not in seen:
                seen.add(name)
                within[name] += v
            k = self._parent[k]

    def _split(self, a: float, b: float) -> None:
        """Attribute the idle gap [a, b] piece by piece: the innermost span
        is constant between consecutive span boundaries."""
        i = bisect.bisect_right(self._bounds, a)
        cuts = [a]
        while i < len(self._bounds) and self._bounds[i] < b:
            cuts.append(self._bounds[i])
            i += 1
        cuts.append(b)
        for p, q in zip(cuts, cuts[1:]):
            if q > p:
                k = self._innermost(0.5 * (p + q))
                self._add(self.idle_by_span, self._idle_in, k, 1e-6 * (q - p))

    def span_device_s(self, name: str, inclusive: bool = False) -> float:
        """Device time of the ops whose launch falls innermost in a span
        named `name` (with `inclusive`: in such a span or its children)."""
        return (self._device_in if inclusive else self.device_by_span).get(name, 0.0)

    def span_idle_s(self, name: str, inclusive: bool = False) -> float:
        """Device idle time of the window whose innermost covering span is
        named `name` (with `inclusive`: covered by such a span at any
        depth)."""
        return (self._idle_in if inclusive else self.idle_by_span).get(name, 0.0)

    def summary(self) -> dict:
        def top(d):
            return [[n, s] for n, s in sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:10]]

        return {"idle_by_span": top(self.idle_by_span), "device_by_span": top(self.device_by_span),
                "idle_s": sum(self.idle_by_span.values()),
                "idle_by_host_s": sum(self.idle_by_host.values()),
                "busy_s": self.busy_s, "wall_s": self.wall_s, "steps": self.steps,
                "reads": self.reads, "host_syncs": self.per_step(devtrace.HOST_READS) * self.steps,
                "ops": len(self.ops), "unlaunched": self.unlaunched}


def _telemetry():
    """The program's telemetry module, where it records spans; else None."""
    try:
        from mundy_tpu_torch.io import telemetry
    except ImportError:
        return None
    return telemetry if hasattr(telemetry, "recording") and hasattr(telemetry, "reads") else None


def traced(run, steps: int, on_card: bool = True):
    """Run `run()`, `steps` steps, under torch.profiler (the device's
    activity too where `on_card`) and a recording of the program's spans;
    read both as a SpanTrace. None where the program records no spans."""
    from torch.profiler import ProfilerActivity, profile

    tel = _telemetry()
    if tel is None:
        return None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    reads0 = sum(tel.reads.values())
    with tel.recording() as rec, profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    reads = sum(tel.reads.values()) - reads0
    results = prof.profiler.kineto_results
    return SpanTrace(kineto_events(results), wall, steps, results.trace_start_ns(), rec.spans,
                     reads)


def of(ctx):
    """The SpanTrace of one more block of the cell's run loop from the
    traced window's end state (made once per run, kept on `ctx`), or None
    where the program records no spans. Prints its summary to stderr."""
    if not hasattr(ctx, "span_trace"):
        drv = ctx.driver
        held = [ctx.state]

        def block():
            held[0] = drv.block(held[0])

        on_card = torch.device(ctx.device).type == "cuda"
        ctx.span_trace = traced(block, drv.block_steps, on_card)
        if ctx.span_trace is not None:
            print("spans: " + json.dumps(ctx.span_trace.summary()), file=sys.stderr, flush=True)
    return ctx.span_trace


def device_ms_per_step(ctx, name: str):
    """Device ms a step of the ops launched inside spans named `name` (their
    children included), or None off the card or without spans."""
    t = of(ctx)
    if t is None or t.busy_s <= 0:
        return None
    return 1e3 * t.span_device_s(name, inclusive=True) / t.steps


def idle_ms_per_step(ctx, name: str):
    """Device idle ms a step inside spans named `name` (their children
    included), or None off the card or without spans."""
    t = of(ctx)
    if t is None or t.busy_s <= 0:
        return None
    return 1e3 * t.span_idle_s(name, inclusive=True) / t.steps
