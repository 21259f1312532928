"""The traced slice of a ``--trace 1`` run, and what is read from it.

One ``torch.profiler`` session (CPU and CUDA activity) covers a steady
slice of the window.  Its events are mapped onto the host's
``time.perf_counter`` clock (the profiler stamps events on the wall clock;
the offset between the two is read when the session starts), so the
readers can set device activity beside the harness's own host times.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass
from typing import List, Tuple

import torch


class Tracer:
    """Starts the profiler ``start_s`` into the window and stops it
    ``seconds`` later (or when the window closes).  Starting sets up CUPTI
    and stopping collects the events, seconds each, inside the window: the
    run's schedule is shifted by both.  The dispatches before the slice are
    the ones the profiler never touched."""

    def __init__(self, start_s: float, seconds: float):
        self.start_s, self.seconds = start_s, seconds
        self.prof = None
        self.on = False
        self.t_on = self.t_off = 0.0
        self.offset_ns = 0

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    def tick(self, elapsed: float) -> float:
        """Start or stop the session as the window's clock says; returns
        the seconds that took (the profiler's own set-up, or collecting its
        events), by which the caller shifts its schedule."""
        t = time.perf_counter()
        if self.prof is None and elapsed >= self.start_s:
            self._start()
        elif self.on and elapsed >= self.start_s + self.seconds:
            self.close()
        return time.perf_counter() - t

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t_on = time.perf_counter()
        self.on = True

    def close(self) -> None:
        if not self.on:
            return
        torch.cuda.synchronize()
        self.t_off = time.perf_counter()
        self.prof.stop()
        self.on = False

    def view(self) -> "TraceView":
        if self.prof is None or self.on:
            raise RuntimeError("the traced slice did not run to its end")
        to_s = lambda ns: (ns - self.offset_ns) * 1e-9  # noqa: E731
        dev, cpu, launches = [], [], 0
        for e in self.prof.profiler.kineto_results.events():
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith("limo_bench."):
                    continue       # a host span's shadow on the device, not work
                dev.append((to_s(s), to_s(s + d), name))
            else:
                cpu.append((to_s(s), to_s(s + d), name))
                launches += name.startswith("cudaLaunch")
        dev.sort()
        cpu.sort()
        return TraceView(self.t_on, self.t_off, dev, cpu, launches)


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """Sorted disjoint cover of ``intervals`` ((start, end, …), sorted by
    start) clipped to [lo, hi]."""
    out = []
    for iv in intervals:
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(cover) -> float:
    return sum(e - s for s, e in cover)


def overlap(cover, lo: float, hi: float) -> float:
    """Time of ``cover`` (sorted, disjoint) inside [lo, hi]."""
    i = max(0, bisect.bisect_right(cover, (lo, float("inf"))) - 1)
    t = 0.0
    while i < len(cover) and cover[i][0] < hi:
        t += max(0.0, min(cover[i][1], hi) - max(cover[i][0], lo))
        i += 1
    return t


@dataclass
class TraceView:
    t_on: float
    t_off: float
    device: list           # (start, end, name) on the host clock, sorted
    cpu: list              # (start, end, name)
    launches: int          # host calls named cudaLaunch*

    def __post_init__(self):
        self.spans = [ev for ev in self.cpu if ev[2].startswith("limo_bench.")]

    @property
    def window_s(self) -> float:
        return self.t_off - self.t_on

    def busy(self):
        return union(self.device, self.t_on, self.t_off)

    def kernels(self, prefix: str):
        """Device (start, end) of the kernels whose name starts with ``prefix``."""
        return [(s, e) for s, e, n in self.device if n.startswith(prefix)]

    def gaps(self, spans):
        """The device's idle intervals inside ``spans`` (sorted, disjoint)."""
        busy = self.busy()
        out = []
        for lo, hi in spans:
            t = lo
            i = max(0, bisect.bisect_right(busy, (lo, float("inf"))) - 1)
            while i < len(busy) and busy[i][0] < hi:
                if busy[i][0] > t:
                    out.append((t, busy[i][0]))
                t = max(t, busy[i][1])
                i += 1
            if t < hi:
                out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t``: among the last 64
        to start before it, else the harness's span around it."""
        i = bisect.bisect_right(self.cpu, (t, float("inf"), "")) - 1
        best, best_start = None, -float("inf")
        for j in range(i, max(-1, i - 64), -1):
            s, e, n = self.cpu[j]
            if s <= t < e and s > best_start:
                best, best_start = n, s
        if best is None:
            outer = [n for s, e, n in self.spans if s <= t < e]
            best = outer[-1] if outer else "idle host"
        return best

    def breakdown(self, spans) -> dict:
        """The ten device operations that took most time in the slice, and
        the idle time inside ``spans`` by what the host was doing."""
        ops = {}
        for s, e, n in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s)
        idle = {}
        for s, e in self.gaps(spans):
            n = self.host_at(0.5 * (s + e)) if e - s >= 5e-6 else "gaps under 5 us"
            idle[n] = idle.get(n, 0.0) + (e - s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
