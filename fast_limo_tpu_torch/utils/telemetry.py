"""Performance telemetry: the board, and the span and counter recorder of
the dispatch path (the board is a copy of fast_limo_tpu/utils/telemetry.py;
NumPy only).

Counterpart of the reference's live terminal board (`Localizer::debugVerbose`,
Modules/Localizer.cpp:990-1222): rolling windows of per-scan enqueue time and
sensor rates, plus state/bias/extrinsics readouts — rendered on demand rather
than from a detached thread.  The enqueue time is host wall time around the
dispatch: the step reads nothing back, so the device work runs on after it.

``Spans`` records the dispatch path from inside: a span at each stage of a
scan (host clock, ``time.perf_counter_ns``), a CUDA event at each boundary
of the step's stages, each dispatch's ``pose_ready`` event and the caching
allocator's device allocations.  It is off until ``Telemetry.trace(True)``;
a span site then costs one attribute check (``Spans.live``), and the two
root sites of a scan a call that also asks whether a ``torch.profiler``
session records: while one does, every span enters the trace as a
``record_function`` range, switched on or not.  ``Telemetry.export()``
hands out what was recorded as plain JSON types.  ``GraphCounts`` counts,
always, how the step's update stage ran: replayed as a CUDA graph, or
eagerly and why.  ``Spans.downsample_scans`` and ``downsample_points_in``
count, always, the sweeps larger than the scan slots that the host
stride-downsampled and their returns.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np
import torch


@dataclass
class RollingStat:
    capacity: int = 1000
    buf: Deque[float] = field(default_factory=collections.deque)

    def push(self, v: float) -> None:
        self.buf.append(float(v))
        while len(self.buf) > self.capacity:
            self.buf.popleft()

    @property
    def last(self) -> float:
        return self.buf[-1] if self.buf else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.buf)) if self.buf else 0.0

    @property
    def max(self) -> float:
        return float(np.max(self.buf)) if self.buf else 0.0


def _cpu_model() -> str:
    """Host CPU brand string (getCPUinfo's __cpuid readout,
    Localizer.cpp:951-972 — here via /proc/cpuinfo)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _rss_gb() -> float:
    """Resident set size in GB (the board's RAM line, Localizer.cpp:1002)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * 4096 / 1e9
    except (OSError, ValueError, IndexError):
        return 0.0


def _profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) session records."""
    return torch.autograd.profiler._is_profiler_enabled


class Ready:
    """A dispatch's ``pose_ready`` where the step ran on the host: done at
    once, at ``host_ns``."""

    __slots__ = ("host_ns",)

    def __init__(self, host_ns: int):
        self.host_ns = host_ns

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class GraphCounts:
    """How a step's captured stage ran (``models/graphs.StageGraph``):
    ``captures``, ``replays``, and ``eager`` calls by reason ("warm-up"
    before a capture; "cpu", "split_body", "sharded" or "debug" where the
    call cannot be captured)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager = {}

    def eager_call(self, reason: str) -> None:
        self.eager[reason] = self.eager.get(reason, 0) + 1

    def export(self) -> dict:
        return {"captures": self.captures, "replays": self.replays, "eager": dict(self.eager)}


class Spans:
    """Spans and counters of the dispatch path (see the module docstring).

    A span is a row ``[name, t0, t1, parent, ordinal, stamp, ev0, ev1]``:
    host ``perf_counter_ns`` at its start and end, the row of the span that
    caused it (-1 for a root), the dispatch ordinal (the request it serves,
    shared by every span of a scan), the scan's stamp, and the CUDA events
    at its start and end (the step's stages only).  ``root`` opens a span
    with no parent and drops whatever the thread left open; ``open`` and
    ``close`` nest; ``stage`` closes the thread's open stage and opens the
    next one as a child of the innermost open span, so one event marks each
    boundary.  The open spans are per thread (the sharded step's ranks are
    threads).  Rows go to a buffer of ``capacity``; past it they are
    counted in ``dropped``."""

    def __init__(self, device=None, capacity: int = 1 << 16):
        self.device = device          # a CUDA device (its events), or None
        self.capacity = capacity
        self.on = False               # the switch: rows, events and counters
        self.live = False             # read at every span site: on, or profiled
        self.evictions = 0            # map evictions that freed (always counted)
        self.update_graph = GraphCounts()   # the update stage's graph (always counted)
        self.downsample_scans = 0       # sweeps over the slots, stride-cut (always counted)
        self.downsample_points_in = 0   # their returns (always counted)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._clear()

    def _clear(self) -> None:
        self.rows = []
        self.dispatches = []          # [ordinal, stamp, arrive_ns, pose_ready, allocs]
        self.dropped = 0
        self._arrivals = {}           # ordinal → the first arrive's t0
        self._anchor = None           # (event, host ns, ± ns)
        self._scale = 1.0             # host ns a device ns, from two anchors (export)
        self._allocs = 0

    # ---- the switch ----
    def start(self) -> None:
        """Clear the buffer and record from now on; on CUDA, anchor the
        device's events to the host clock (a sync, here and never in the
        step)."""
        self._clear()
        if self.device is not None:
            self._anchor = self._mark()
            self._allocs = self._device_allocs()
        self.on = self.live = True

    def stop(self) -> None:
        self.on = self.live = False

    def _mark(self):
        """(event, host ns, half-width): an event recorded on the idle
        device and polled until done, the host clock read on both sides."""
        torch.cuda.synchronize(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(torch.cuda.current_stream(self.device))
        while not ev.query():
            pass
        t1 = time.perf_counter_ns()
        return ev, (t0 + t1) // 2, (t1 - t0) // 2

    def _device_allocs(self) -> int:
        return int(torch.cuda.memory_stats_as_nested_dict(self.device).get("num_device_alloc", 0))

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ---- span sites ----
    def _state(self):
        tl = self._tls
        if not hasattr(tl, "stack"):
            tl.stack, tl.stage, tl.mirror = [], None, False
            tl.ordinal, tl.stamp, tl.stamps = -1, None, ()
        return tl

    def _row(self, name, t, parent, ordinal, stamp, ev=None) -> int:
        with self._lock:
            if len(self.rows) >= self.capacity:
                self.dropped += 1
                return -1
            self.rows.append([name, t, None, parent, ordinal, stamp, ev, None])
            return len(self.rows) - 1

    def root(self, name: str, ordinal: int, stamp, stamps=()) -> bool:
        """Open a root span for dispatch ``ordinal``; ``stamps``: each
        element's stamp in a chunked dispatch.  Returns ``live``."""
        mirror = _profiling()
        live = self.live = self.on or mirror
        if not live:
            return False
        tl = self._state()
        while tl.stack:
            self.close()
        tl.mirror, tl.ordinal, tl.stamp, tl.stamps = mirror, ordinal, stamp, tuple(stamps)
        if self.on and name == "localizer.arrive":
            self._arrivals.setdefault(ordinal, time.perf_counter_ns())
        self.open(name)
        return True

    def open(self, name: str) -> None:
        tl = self._state()
        parent = tl.stack[-1][0] if tl.stack else -1
        row = (self._row(name, time.perf_counter_ns(), parent, tl.ordinal, tl.stamp)
               if self.on else -1)
        rf = torch.autograd.profiler.record_function(name).__enter__() if tl.mirror else None
        tl.stack.append((row, rf))

    def close(self) -> None:
        tl = self._state()
        if tl.stage is not None:
            self.stage(None)
        if not tl.stack:
            return
        row, rf = tl.stack.pop()
        if row >= 0:
            self.rows[row][2] = time.perf_counter_ns()
        if rf is not None:
            rf.__exit__(None, None, None)

    def stage(self, name: Optional[str]) -> None:
        """End the thread's open stage, if any, and open ``name`` (None:
        none) as a child of the innermost open span."""
        tl = self._state()
        t = time.perf_counter_ns()
        ev = self._event() if self.on and self.device is not None else None
        if tl.stage is not None:
            row, rf = tl.stage
            tl.stage = None
            if row >= 0:
                self.rows[row][2], self.rows[row][7] = t, ev
            if rf is not None:
                rf.__exit__(None, None, None)
        if name is not None:
            parent = tl.stack[-1][0] if tl.stack else -1
            row = self._row(name, t, parent, tl.ordinal, tl.stamp, ev) if self.on else -1
            rf = torch.autograd.profiler.record_function(name).__enter__() if tl.mirror else None
            tl.stage = (row, rf)

    def element(self, i: int) -> None:
        """The spans opened from now on belong to element ``i`` of a chunk."""
        tl = self._state()
        if i < len(tl.stamps):
            tl.stamp = tl.stamps[i]

    # ---- the dispatch's end ----
    def pose_event(self):
        """An event on the compute stream after a dispatch's step (timing
        only while on); a caller polls ``query()`` instead of syncing."""
        if self.device is None:
            return Ready(time.perf_counter_ns())
        ev = torch.cuda.Event(enable_timing=self.on)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def dispatched(self, ordinal: int, stamp, ready) -> None:
        """Keep a dispatch's pose event and the device allocations since
        the last one (while on)."""
        allocs = None
        if self.device is not None:
            n = self._device_allocs()
            allocs, self._allocs = n - self._allocs, n
        with self._lock:
            if len(self.dispatches) < self.capacity:
                self.dispatches.append([ordinal, stamp, self._arrivals.pop(ordinal, None),
                                        ready, allocs])
            else:
                self.dropped += 1

    def ready_ns(self, ready) -> Optional[int]:
        """A pose event's time on the host clock, None until it is done."""
        if isinstance(ready, Ready):
            return ready.host_ns
        if ready is None or self._anchor is None or not ready.query():
            return None
        ev, ns, _ = self._anchor
        return ns + int(round(ev.elapsed_time(ready) * 1e6 * self._scale))

    # ---- export ----
    def export(self) -> dict:
        """Everything recorded, as plain JSON types (times in host ns).  On
        CUDA it waits for the device and anchors again: ``anchor.drift_ns``
        is the second anchor's host time less the first's plus the device's
        elapsed time between them, and the device's clock rate against the
        host's, ``anchor.scale``, maps the events' times from here on."""
        anchor = None
        if self._anchor is not None:
            ev0, ns0, err0 = self._anchor
            ev1, ns1, err1 = self._mark()
            elapsed = ev0.elapsed_time(ev1) * 1e6
            self._scale = (ns1 - ns0) / elapsed if elapsed > 0 else 1.0
            anchor = {"ns": ns0, "error_ns": max(err0, err1), "over_ns": ns1 - ns0,
                      "drift_ns": ns1 - ns0 - int(round(elapsed)), "scale": self._scale}
        dev = self.ready_ns
        spans = [{"name": n, "t0": t0, "t1": t1, "parent": p, "ordinal": k, "stamp": st,
                  "dev0": dev(e0) if e0 is not None else None,
                  "dev1": dev(e1) if e1 is not None else None}
                 for n, t0, t1, p, k, st, e0, e1 in self.rows]
        dispatches = [{"ordinal": k, "stamp": st, "arrive": a, "pose_ready": dev(r),
                       "device_allocs": n} for k, st, a, r, n in self.dispatches]
        return {"spans": spans, "dispatches": dispatches, "anchor": anchor,
                "capacity": self.capacity, "dropped": self.dropped}


class Telemetry:
    """Collects per-scan timings and renders the performance board; its
    ``spans`` record the dispatch path while ``trace(True)`` holds."""

    def __init__(self, capacity: int = 1000, device=None):
        import os

        self.enqueue_ms = RollingStat(capacity)    # host wall of a dispatch's step call
        self.pose_ms = RollingStat(capacity)       # arrive → pose_ready, while tracing
        self.spans = Spans(device)
        self._read_upto = 0                        # spans.dispatches read into pose_ms
        self.imu_rate = RollingStat(capacity)
        self.lidar_rate = RollingStat(capacity)
        self.cpu_pct = RollingStat(capacity)       # cpu_percents equivalent
        self._prev_imu_stamp: Optional[float] = None
        self._prev_scan_stamp: Optional[float] = None
        self._t0: Optional[float] = None
        self.first_stamp: Optional[float] = None
        self.cpu_model = _cpu_model()
        self.n_cores = os.cpu_count() or 1
        t = os.times()
        self._last_cpu = (t.user + t.system, time.perf_counter())

    # ---- hooks ----
    def imu_tick(self, stamp: float) -> None:
        if self.first_stamp is None:
            self.first_stamp = stamp
        if self._prev_imu_stamp is not None and stamp > self._prev_imu_stamp:
            self.imu_rate.push(1.0 / (stamp - self._prev_imu_stamp))
        self._prev_imu_stamp = stamp

    def scan_begin(self) -> None:
        self._t0 = time.perf_counter()

    def scan_end(self, stamp: float) -> None:
        if self._t0 is not None:
            self.enqueue_ms.push(1e3 * (time.perf_counter() - self._t0))
            self._t0 = None
        if self._prev_scan_stamp is not None and stamp > self._prev_scan_stamp:
            self.lidar_rate.push(1.0 / (stamp - self._prev_scan_stamp))
        self._prev_scan_stamp = stamp
        # process CPU load normalized by cores (Localizer.cpp:1024-1033)
        import os

        t = os.times()
        cpu, wall = t.user + t.system, time.perf_counter()
        dcpu, dwall = cpu - self._last_cpu[0], wall - self._last_cpu[1]
        if dwall > 0.25:     # stable window: update a few times per second
            self.cpu_pct.push(100.0 * dcpu / dwall / self.n_cores)
            self._last_cpu = (cpu, wall)

    # ---- tracing ----
    def trace(self, on: bool = True) -> None:
        """The switch of the span and counter recorder (off by default).
        Switching it on clears what was recorded and, on CUDA, anchors the
        device's events to the host clock with one sync."""
        if on:
            self.pose_ms.buf.clear()
            self._read_upto = 0
            self.spans.start()
        else:
            self.spans.stop()

    def export(self) -> dict:
        """The recorder's spans, dispatches and anchor (``Spans.export``)
        and the counters: evictions, the update stage's graph
        (``GraphCounts``), the downsampled sweeps and their returns, and
        ``iekf.counters`` (its device count read here, one sync)."""
        from fast_limo_tpu_torch.models import iekf

        out = self.spans.export()
        c = iekf.counters
        out["counters"] = {"evictions": self.spans.evictions,
                           "update_graph": self.spans.update_graph.export(),
                           "downsample": {"scans": self.spans.downsample_scans,
                                          "points_in": self.spans.downsample_points_in},
                           "loop_fallbacks": c.loop_fallbacks,
                           "host_syncs": c.host_syncs, "guard_eighs": c.guard_eighs}
        return out

    def _read_poses(self) -> None:
        """Push the pose latency of every dispatch whose ``pose_ready`` is
        done, in order, without waiting for the others."""
        sp, ds = self.spans, self.spans.dispatches
        while self._read_upto < len(ds):
            _k, _st, arrive, ready, _n = ds[self._read_upto]
            t = sp.ready_ns(ready)
            if t is None:
                return
            if arrive is not None:
                self.pose_ms.push(1e-6 * (t - arrive))
            self._read_upto += 1

    # ---- reporting ----
    def stats(self) -> dict:
        self._read_poses()
        return {
            "enqueue_ms": self.enqueue_ms.last,
            "enqueue_ms_mean": self.enqueue_ms.mean,
            "enqueue_ms_max": self.enqueue_ms.max,
            "pose_ms": self.pose_ms.last,
            "pose_ms_mean": self.pose_ms.mean,
            "pose_ms_max": self.pose_ms.max,
            "evictions": self.spans.evictions,
            "imu_hz": self.imu_rate.mean,
            "lidar_hz": self.lidar_rate.mean,
            "enqueue_scans_per_s": 1e3 / self.enqueue_ms.mean if self.enqueue_ms.mean else 0.0,
            "cpu_pct": self.cpu_pct.last,
            "cpu_pct_max": self.cpu_pct.max,
            "ram_gb": _rss_gb(),
        }

    def board(self, state_info: dict = None) -> str:
        """ASCII board shaped after the reference's verbose output
        (Localizer.cpp:1042-1207)."""
        s = self.stats()
        W = 69
        line = "+" + "-" * (W - 2) + "+"
        rows = [line, "|{:^{w}}|".format(" fast_limo_tpu_torch ", w=W - 2), line]

        def row(text):
            rows.append("| " + text.ljust(W - 4) + " |")

        row(f"Sensor rates: LiDAR @ {s['lidar_hz']:.2f} Hz, IMU @ {s['imu_hz']:.2f} Hz")
        if state_info:
            p = state_info.get("pos")
            if p is not None:
                row(f"Position  {{W}} [xyz] :: {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}")
            q = state_info.get("quat")
            if q is not None:
                row(f"Attitude  {{W}} [wxyz] :: {q[0]:.4f} {q[1]:.4f} {q[2]:.4f} {q[3]:.4f}")
            v = state_info.get("vel")
            if v is not None:
                row(f"Velocity  {{B}} [xyz] :: {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}")
            for key, label in (("bg", "Gyro Bias"), ("ba", "Accel Bias"),
                               ("grav", "Gravity Est.")):
                val = state_info.get(key)
                if val is not None:
                    row(f"{label:12s} [xyz] :: {val[0]:.6f} {val[1]:.6f} {val[2]:.6f}")
            n = state_info.get("map_points")
            if n is not None:
                row(f"Map points: {n}")
            m = state_info.get("n_pc2match")
            if m is not None:
                row(f"Matched points: {m}")
        rows.append(line)
        row(f"Enqueue     :: {s['enqueue_ms']:7.2f} ms  // Avg: "
            f"{s['enqueue_ms_mean']:7.2f} / Max: {s['enqueue_ms_max']:7.2f}")
        row(f"Enqueue rate:: {s['enqueue_scans_per_s']:7.2f} scans/s (host; device runs on)")
        if self.spans.on:
            row(f"Pose latency:: {s['pose_ms']:7.2f} ms  // Avg: "
                f"{s['pose_ms_mean']:7.2f} / Max: {s['pose_ms_max']:7.2f}")
        row(f"Evictions   :: {s['evictions']}")
        g = self.spans.update_graph
        eager = ", ".join(f"{k} {v}" for k, v in sorted(g.eager.items())) or "0"
        row(f"Update graph:: {g.captures} captured, {g.replays} replays, eager {eager}")
        row(f"Downsample  :: {self.spans.downsample_scans} sweeps cut, "
            f"{self.spans.downsample_points_in} points in")
        row(f"Host :: {self.cpu_model[:40]} x{self.n_cores}")
        row(f"CPU Load :: {s['cpu_pct']:5.1f} % // Max: {s['cpu_pct_max']:5.1f} %"
            f"   RAM :: {s['ram_gb']:.2f} GB")
        rows.append(line)
        return "\n".join(rows)
