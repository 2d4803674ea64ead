"""Reading a torch.profiler trace of a window of blocks: device busy time,
idle gaps by what the host was doing, kernel time by name, and the counts
of host reads and kernel launches.

A copy of the smoke script's `profile_window` reading (`chip_smoke.py`),
frozen here: busy time is the union of the intervals in which an operation
(kernel, copy or fill) ran on the device, and the idle share is taken
against the traced window's own wall clock, which the profiler's host
overhead inflates: it is the traced window's share, not the untraced one's.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

HOST_READS = ("aten::_local_scalar_dense",)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")


class Trace:
    """What the readers take from one traced window of `steps` steps."""

    def __init__(self, events, wall_s: float, steps: int):
        self.wall_s = wall_s
        self.steps = steps
        self.counters = None  # the program's counters (before, after), set by the harness
        cpu_t = torch.autograd.DeviceType.CPU
        self.host_counts = collections.Counter()
        host = []
        device = []
        for e in events:
            if e.device_type == cpu_t:
                self.host_counts[e.name] += 1
                host.append((e.time_range.start, e.time_range.end, e.name))
            else:
                device.append((e.time_range.start, e.time_range.end, e.name))
        self.device_time = collections.defaultdict(float)  # name -> seconds
        self.device_count = collections.Counter()
        for a, b, name in device:
            self.device_time[name] += 1e-6 * (b - a)
            self.device_count[name] += 1
        device.sort()
        merged = []
        for a, b, _ in device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = 1e-6 * sum(b - a for a, b in merged)
        self.idle_by_host = self._gaps(merged, sorted(host))

    @staticmethod
    def _gaps(merged, host) -> dict:
        """Seconds of device idle time, summed by the innermost host event
        that covers each gap's midpoint ("host" where none does), between
        the first and the last host event of the window."""
        out = collections.defaultdict(float)
        if not host:
            return out
        starts = [h[0] for h in host]
        lo, hi = host[0][0], max(h[1] for h in host)
        edges = [(lo, lo)] + [tuple(m) for m in merged] + [(hi, hi)]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid) - 1
            name = "host"
            for h in range(k, max(-1, k - 64), -1):
                if host[h][1] >= mid:
                    name = host[h][2]
                    break
            out[name] += 1e-6 * (b - a)
        return out

    def per_step(self, names) -> float:
        return sum(self.host_counts[n] for n in names) / self.steps

    def kernel(self, fragment: str) -> tuple:
        """(launches, seconds) of the device operations whose name holds
        `fragment`."""
        names = [n for n in self.device_time if fragment in n]
        return (sum(self.device_count[n] for n in names),
                sum(self.device_time[n] for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_time.items(), key=lambda kv: kv[1], reverse=True)[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: kv[1], reverse=True)[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def traced(run, steps: int, on_card: bool = True) -> Trace:
    """Run `run()`, a window of `steps` steps, under torch.profiler (the
    device's activity too where `on_card`) and read its trace."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    return Trace(prof.events(), wall, steps)
