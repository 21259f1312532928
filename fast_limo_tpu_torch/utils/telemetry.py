"""Performance telemetry board (a copy of fast_limo_tpu/utils/telemetry.py;
NumPy only).

Counterpart of the reference's live terminal board (`Localizer::debugVerbose`,
Modules/Localizer.cpp:990-1222): rolling windows of per-scan wall time and
sensor rates, plus state/bias/extrinsics readouts — rendered on demand rather
than from a detached thread.  Per-scan times are host wall time around the
dispatch (the device work runs on asynchronously and is not included);
per-kernel device time comes from ``torch.profiler`` (``chip_smoke.py
--profile``).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np


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


class Telemetry:
    """Collects per-scan timings and renders the performance board."""

    def __init__(self, capacity: int = 1000):
        import os

        self.scan_ms = RollingStat(capacity)       # cpu_times equivalent
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
            self.scan_ms.push(1e3 * (time.perf_counter() - self._t0))
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

    # ---- reporting ----
    def stats(self) -> dict:
        return {
            "ms_per_scan": self.scan_ms.last,
            "ms_per_scan_mean": self.scan_ms.mean,
            "ms_per_scan_max": self.scan_ms.max,
            "imu_hz": self.imu_rate.mean,
            "lidar_hz": self.lidar_rate.mean,
            "scans_per_s": 1e3 / self.scan_ms.mean if self.scan_ms.mean else 0.0,
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
        row(f"Computation :: {s['ms_per_scan']:7.2f} ms  // Avg: "
            f"{s['ms_per_scan_mean']:7.2f} / Max: {s['ms_per_scan_max']:7.2f}")
        row(f"Throughput  :: {s['scans_per_s']:7.2f} scans/s")
        row(f"Host :: {self.cpu_model[:40]} x{self.n_cores}")
        row(f"CPU Load :: {s['cpu_pct']:5.1f} % // Max: {s['cpu_pct_max']:5.1f} %"
            f"   RAM :: {s['ram_gb']:.2f} GB")
        rows.append(line)
        return "\n".join(rows)
