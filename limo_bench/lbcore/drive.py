"""The arrival loops that drive the program, and what they record.

``open``: the sensor's own schedule.  IMU samples are due at their stamps
and a sweep when it ends (its stamp plus one scan period); each is handed
to the ``Localizer`` at its due time on the host's clock, or at once when
the host is late.  After every call that dispatched a scan the pose
(``last_output``'s position and orientation) is copied to the host, as a
single-threaded sensor callback does.  A scan's latency runs from its due
time to that copy.

``closed``: a bag replay.  Events go in as fast as the ``Localizer``
takes them, in sensor order, and nothing is read back until the window
ends in ``flush()`` and ``torch.cuda.synchronize()``.

Each dispatch is seen through a wrapper around the ``Localizer``'s
``scan_step`` (called as ``scan_step(state, *packs)`` and returning
``(state, ScanOutput)``; the ``Localizer`` has no public hook that hands
out its state): for the dispatches drawn for the output check it keeps
copies of the state it was given and of what it returned.  The open loop's
draws are dispatch ordinals, since its dispatches follow the schedule; the
closed loop's are times in the window, and the first dispatch at or after
each is kept, so that the draws span the whole window at any rate.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

IMU, SCAN = 0, 1


def sync() -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def clone(tree):
    """A copy of every tensor in a (nested) NamedTuple, on its device."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, tuple):
        items = [clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


@dataclass
class Dispatch:
    ordinal: int
    scans: List[int]
    t_call0: float = 0.0      # host clock around the call that dispatched it
    t_call1: float = 0.0
    t_pose: float = float("nan")   # the pose on the host (open loop)


@dataclass
class Sample:
    ordinal: int
    scans: List[int]
    pre: object               # program state before the dispatch (None: the first)
    post: object = None       # program state after it
    out: object = None        # the dispatch's ScanOutput (pos, quat, vel)


class Recorder:
    """Wraps ``loc.scan_step``: numbers the dispatches, gives each its
    scans, and keeps the drawn ones' states and outputs."""

    def __init__(self, loc, chunk: int, drawn, times=()):
        self.loc, self.chunk, self.drawn = loc, chunk, set(drawn)
        self.times = sorted(times)     # window seconds still to be sampled
        self.clock_s = None            # seconds into the window (closed loop)
        self.dispatches: List[Dispatch] = []
        self.samples: Dict[int, Sample] = {}
        self._next_scan = 0
        inner = loc.scan_step

        def step(state, *packs):
            k = len(self.dispatches)
            scans = list(range(self._next_scan, self._next_scan + self.chunk))
            self._next_scan += self.chunk
            self.dispatches.append(Dispatch(k, scans))
            keep = k in self.drawn
            while self.clock_s is not None and self.times and self.clock_s >= self.times[0]:
                self.times.pop(0)
                keep = True
            if keep:
                self.samples[k] = Sample(k, scans, None if k == 0 else clone(state))
            new_state, out = inner(state, *packs)
            if keep:
                s = self.samples[k]
                s.post = clone(new_state)
                s.out = clone((out.pos, out.quat, out.vel))
            return new_state, out

        loc.scan_step = step


@dataclass
class Window:
    t0: float
    t1: float = 0.0
    scans: List[int] = field(default_factory=list)     # scans due (open) / dispatched (closed)
    due: Dict[int, float] = field(default_factory=dict)  # scan → due time on the host clock
    lag_s: float = 0.0        # how late the host delivered events, at most
    shift_s: float = 0.0      # the profiler's start and stop (a traced run), left out


def events(sweeps, imu_t, period: float):
    """(due sensor time, kind, index) of every IMU sample and sweep, in
    delivery order (an IMU sample before a sweep due at the same time)."""
    ev = [(float(t), IMU, k) for k, t in enumerate(imu_t)]
    ev += [(stamp + period, SCAN, i) for i, (stamp, _, _) in enumerate(sweeps)]
    ev.sort()
    return ev


class Driver:
    def __init__(self, loc, rec: Recorder, sweeps, imu, period: float, tracer=None):
        self.loc, self.rec, self.sweeps = loc, rec, sweeps
        self.imu_t, self.imu_acc, self.imu_gyro = imu
        self.ev = events(sweeps, self.imu_t, period)
        self.pos = 0            # next event
        self.tracer = tracer

    def _deliver(self, kind: int, i: int) -> None:
        if kind == IMU:
            self.loc.update_imu(float(self.imu_t[i]), self.imu_acc[i], self.imu_gyro[i])
        else:
            stamp, pts, t = self.sweeps[i]
            self.loc.update_pointcloud(pts, t, stamp)

    def _span(self, name: str):
        return self.tracer.span(name) if self.tracer else contextlib.nullcontext()

    def call(self, kind: int, i: int, read_pose: bool) -> List[Dispatch]:
        """One event into the Localizer; returns the dispatches it caused,
        with their host times (and the time their pose reached the host,
        if asked)."""
        rec = self.rec
        n0 = len(rec.dispatches)
        name = "limo_bench.update_imu" if kind == IMU else "limo_bench.update_pointcloud"
        t0 = time.perf_counter()
        with self._span(name):
            self._deliver(kind, i)
        t1 = time.perf_counter()
        new = rec.dispatches[n0:]
        for d in new:
            d.t_call0, d.t_call1 = t0, t1
        if new and read_pose:
            out = self.loc.last_output
            with self._span("limo_bench.pose_read"):
                torch.cat((out.pos.reshape(-1), out.quat.reshape(-1))).cpu()
            t2 = time.perf_counter()
            for d in new:
                d.t_pose = t2
        return new

    def warm_up(self, n_scans: int, read_pose: bool) -> None:
        """Deliver every event up to and including sweep ``n_scans − 1``,
        untimed, and wait for the device."""
        while self.pos < len(self.ev):
            _, kind, i = self.ev[self.pos]
            self.pos += 1
            self.call(kind, i, read_pose)
            if kind == SCAN and i == n_scans - 1:
                break
        sync()
        if len(self.rec.dispatches) * self.rec.chunk != n_scans:
            raise RuntimeError(f"warm-up dispatched {len(self.rec.dispatches)} times for "
                               f"{n_scans} scans (chunk {self.rec.chunk})")

    def open_loop(self, seconds: float) -> Window:
        """The sensor's schedule for ``seconds`` from now."""
        base = self.ev[self.pos][0]
        w = Window(t0=time.perf_counter())
        shift = 0.0           # the profiler's start and stop, in a traced run
        while self.pos < len(self.ev):
            due_s, kind, i = self.ev[self.pos]
            if due_s - base >= seconds:
                break
            if self.tracer:
                shift += self.tracer.tick(due_s - base)
            due = w.t0 + shift + (due_s - base)
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            else:
                w.lag_s = max(w.lag_s, now - due)
            self.pos += 1
            if kind == SCAN:
                w.scans.append(i)
                w.due[i] = due
            self.call(kind, i, read_pose=True)
        if self.tracer:
            self.tracer.close()
        # the sweeps due last may wait for one more IMU sample
        pending = set(w.scans) - {s for d in self.rec.dispatches for s in d.scans}
        while pending and self.pos < len(self.ev):
            _, kind, i = self.ev[self.pos]
            self.pos += 1
            if kind == IMU:
                for d in self.call(kind, i, read_pose=True):
                    pending -= set(d.scans)
            if self.ev[self.pos - 1][0] > base + seconds + 1.0:
                break
        w.shift_s = shift
        w.t1 = time.perf_counter()
        return w

    def closed_loop(self, seconds: float) -> Window:
        """Events as fast as they are taken, for ``seconds`` (longer only
        while a time drawn for the check waits for a dispatch); then
        ``flush()`` and a synchronize."""
        n0 = len(self.rec.dispatches)
        w = Window(t0=time.perf_counter())
        while True:
            if self.tracer:
                w.shift_s += self.tracer.tick(time.perf_counter() - w.t0 - w.shift_s)
            elapsed = time.perf_counter() - w.t0 - w.shift_s
            # a time drawn for the check and not yet reached by a dispatch
            # (a host slower than a dispatch in the window's last 5 %) holds
            # the window open until the next dispatch, which it then times
            if elapsed >= seconds and (not self.rec.times or elapsed >= 2 * seconds):
                break
            if self.pos >= len(self.ev):
                raise RuntimeError("the replay ran out of scans before the window closed: "
                                   "the traffic's max_rate_hz is too low")
            _, kind, i = self.ev[self.pos]
            self.pos += 1
            self.rec.clock_s = time.perf_counter() - w.t0 - w.shift_s
            self.call(kind, i, read_pose=False)
        self.rec.clock_s = None
        if self.tracer:
            self.tracer.close()
        n_before_flush = len(self.rec.dispatches)
        t0 = time.perf_counter()
        self.loc.flush()
        sync()
        w.t1 = time.perf_counter()
        flushed = self.rec.dispatches[n_before_flush:]
        for d in flushed:
            d.t_call0, d.t_call1 = t0, w.t1
            d.scans = d.scans[:self.loc.last_output_scans]
        w.scans = [s for d in self.rec.dispatches[n0:] for s in d.scans]
        return w
