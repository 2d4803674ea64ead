"""Step telemetry: spans and host-read counters inside the step, and tps
logging.

Port of mundy_tpu/io/telemetry.py (the reference's per-step tps reporting,
`HP1...neigh_linker.cpp:1375-1376,1496-1546`, and its Kokkos profiling
regions). The reference's regions are `jax.profiler` annotations; here
`trace(name)` records a span into the open `recording()` instead, stamped
with `time.time_ns()`, the clock of `torch.profiler`'s events (a trace's
`kineto_results.trace_start_ns()` plus an event's relative start), so a
reader of a profiler trace can attribute each device operation to the span
its launch fell in, and each stretch of device idle time to the span the
host was in. No `record_function` is opened: on the card the profiler
records a device-side interval for each such range, which a reader taking
every device event as work would count as busy time.

`host_read(site, tensor)` is the one way the step loops bring a device
value to the host. It counts each read under its site, always (`reads`
for scalars, `copies` for bulk copies), and while recording adds a span
`read:<site>` around the wait.

Outside a recording `trace` returns one shared no-op context manager and
reads no clock.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

# scalar host reads (each a wait for the device) and bulk copies to the
# host, by site; always on, like the kernel wrappers' `.launches`
reads: collections.Counter = collections.Counter()
copies: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()
_rec: Optional["Recording"] = None  # the open recording


class Recording:
    """The spans of one `recording()`: `spans[i]` is (name, start_ns,
    end_ns, parent index or -1, step), in the order they opened (so by
    start); end_ns is None while a span is open."""

    def __init__(self):
        self.spans: list = []
        self.step = -1  # the step index spans are stamped with (`at_step`)
        self._open: list = []  # indices of the open spans, innermost last


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.i = len(rec.spans)
        rec.spans.append((self.name, time.time_ns(), None,
                          rec._open[-1] if rec._open else -1, rec.step))
        rec._open.append(self.i)

    def __exit__(self, *exc):
        rec = self.rec
        name, start, _, parent, step = rec.spans[self.i]
        rec.spans[self.i] = (name, start, time.time_ns(), parent, step)
        rec._open.pop()
        return False


@contextlib.contextmanager
def recording():
    """Record the spans of `trace` and `host_read` until the block ends;
    yields the Recording. One recording at a time."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a telemetry recording is already open")
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None


def trace(name: str):
    """A span named `name` in the open recording (the role of
    Kokkos::Profiling::pushRegion); a shared no-op outside one."""
    if _rec is None:
        return _OFF
    return _Span(_rec, name)


def at_step(step: int) -> None:
    """Stamp the spans that open from here on with step index `step`, so
    the spans of one step share it."""
    if _rec is not None:
        _rec.step = step


def host_read(site: str, tensor):
    """The value of `tensor` on the host, counted under `site`: a Python
    number for a 0-d tensor (a scalar read, in `reads`), else a numpy array
    (a bulk copy, in `copies`). On the card either waits for the device."""
    scalar = tensor.dim() == 0
    (reads if scalar else copies)[site] += 1
    if _rec is None:
        return tensor.item() if scalar else tensor.cpu().numpy()
    with _Span(_rec, "read:" + site):
        return tensor.item() if scalar else tensor.cpu().numpy()


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
