"""Generic extracted-sequence reader (port of fast_limo_tpu/io/generic.py) —
the dataset-side counterpart of the reference's rosbag replay workflow
(`launch/{utbm,cat,ona}.launch` + `rosbag play`, README.md:193-199), with
no ROS: sequences are directories of per-scan point files plus an IMU
table, extracted once from a bag (or exported from the synthetic world for
CI).

Layout (all stamps float64 seconds on one clock):

    <root>/
      scans/
        000000.npy          float32 (N,4) rows [x, y, z, t_raw]
        000001.npy          (t_raw stays in the SENSOR's native convention:
        ...                  OUSTER ns-relative / VELODYNE s-relative /
                             HESAI abs-s / LIVOX abs-ns — Localizer applies
                             the per-sensor semantics, Localizer.cpp:747-783)
      scans/timestamps.txt  one header stamp per scan (float seconds)
      imu.csv               rows: stamp,ax,ay,az,gx,gy,gz  (raw sensor frame)
      gps.csv               optional rows: stamp,x,y,z[,weight]  (world ENU,
                            shared origin — the loop branch's GPS factors)

`export_synthetic` writes this layout from the synthetic world in any of the
four sensor time conventions, so every profile config
(configs/{kitti,utbm,cat,ona}_tpu.yaml) is runnable end-to-end without real
data; `python -m fast_limo_tpu_torch.cli make-synthetic` exposes it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

OUSTER, VELODYNE, HESAI, LIVOX = 0, 1, 2, 3


def to_sensor_time(t_rel: np.ndarray, scan_stamp: float, sensor_type: int,
                   end_of_sweep: bool = False) -> np.ndarray:
    """Relative-seconds point times → the sensor's native t_raw field
    (inverse of preprocess.extract_point_times)."""
    sgn = -1.0 if end_of_sweep else 1.0
    if sensor_type == OUSTER:       # nanoseconds relative to header stamp
        return (sgn * t_rel * 1e9).astype(np.float32)
    if sensor_type == VELODYNE:     # seconds relative
        return (sgn * t_rel).astype(np.float32)
    if sensor_type == HESAI:        # absolute seconds
        return (scan_stamp + t_rel).astype(np.float64)
    if sensor_type == LIVOX:        # absolute nanoseconds
        return ((scan_stamp + t_rel) * 1e9).astype(np.float64)
    raise ValueError(f"unknown sensor type {sensor_type}")


@dataclass
class GenericSequence:
    """Reader over the extracted layout above (API mirrors io.kitti.KittiDrive)."""

    root: str
    max_points: int = 200_000

    def __post_init__(self):
        sdir = os.path.join(self.root, "scans")
        self.scan_files = sorted(
            os.path.join(sdir, f) for f in os.listdir(sdir)
            if f.endswith((".npy", ".bin")))
        self.scan_stamps = np.loadtxt(
            os.path.join(sdir, "timestamps.txt"), dtype=np.float64, ndmin=1)
        if len(self.scan_files) != len(self.scan_stamps):
            raise ValueError(f"{len(self.scan_files)} scan files vs "
                             f"{len(self.scan_stamps)} stamps in {sdir}")
        imu = np.loadtxt(os.path.join(self.root, "imu.csv"),
                         delimiter=",", dtype=np.float64, ndmin=2)
        self.imu_stamps = imu[:, 0]
        self.imu_acc = imu[:, 1:4]
        self.imu_gyro = imu[:, 4:7]
        gps_path = os.path.join(self.root, "gps.csv")
        if os.path.exists(gps_path):
            g = np.loadtxt(gps_path, delimiter=",", dtype=np.float64, ndmin=2)
            self.gps_stamps = g[:, 0]
            self.gps_pos = g[:, 1:4]
            self.gps_weight = g[:, 4] if g.shape[1] > 4 else None
        else:
            self.gps_stamps = np.zeros(0)
            self.gps_pos = np.zeros((0, 3))
            self.gps_weight = None

    def __len__(self):
        return len(self.scan_files)

    def imu(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        return float(self.imu_stamps[i]), self.imu_acc[i], self.imu_gyro[i]

    def scan(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        """(stamp, xyz (n,3) f32, t_raw (n,) in the sensor's native units)."""
        f = self.scan_files[i]
        if f.endswith(".npy"):
            arr = np.load(f)
        else:
            arr = np.fromfile(f, np.float32).reshape(-1, 4)
        if len(arr) > self.max_points:
            sel = np.linspace(0, len(arr) - 1, self.max_points).astype(np.int64)
            arr = arr[sel]
        return (float(self.scan_stamps[i]),
                np.ascontiguousarray(arr[:, :3], np.float32),
                np.ascontiguousarray(arr[:, 3], np.float32))

    def gps(self, i: int) -> Tuple[float, np.ndarray, Optional[float]]:
        w = float(self.gps_weight[i]) if self.gps_weight is not None else None
        return float(self.gps_stamps[i]), self.gps_pos[i], w

    def stream(self) -> Iterator[Tuple[str, int]]:
        """Time-merged event stream: ('imu'|'scan'|'gps', index)."""
        events: List[Tuple[float, int, str, int]] = []
        # tiebreak: imu before gps before scan at equal stamps
        events += [(t, 0, "imu", i) for i, t in enumerate(self.imu_stamps)]
        events += [(t, 1, "gps", i) for i, t in enumerate(self.gps_stamps)]
        events += [(t, 2, "scan", i) for i, t in enumerate(self.scan_stamps)]
        events.sort()
        for _, _, kind, i in events:
            yield kind, i


def run_sequence(engine, seq: GenericSequence, n_scans: Optional[int] = None,
                 start_scan: int = 0, start_time: Optional[float] = None) -> None:
    """Feed a sequence through a Localizer/SLAM instance in timestamp order.

    GPS events go to ``engine.update_gps`` when it exists (SLAM), else are
    skipped (plain odometry).  ``start_scan``/``start_time`` resume
    mid-sequence (multi-session relocalization: the first scans were
    consumed by the relocalizer, and IMU/GPS up to ``start_time`` belong to
    the pre-relocalization past).
    """
    gps_fn = getattr(engine, "update_gps", None)
    done = 0
    seen = 0
    try:
        for kind, i in seq.stream():
            if kind == "imu":
                stamp, acc, gyro = seq.imu(i)
                if start_time is not None and stamp <= start_time:
                    continue
                engine.update_imu(stamp, acc, gyro)
            elif kind == "gps":
                if gps_fn is not None:
                    stamp, pos, w = seq.gps(i)
                    if start_time is not None and stamp <= start_time:
                        continue
                    gps_fn(stamp, pos, weight=w)
            else:
                seen += 1
                if seen <= start_scan:
                    continue
                stamp, xyz, t_raw = seq.scan(i)
                engine.update_pointcloud(xyz, t_raw, stamp)
                done += 1
                if n_scans is not None and done >= n_scans:
                    return
    finally:
        flush = getattr(engine, "flush", None)
        if flush is not None:
            flush()


def export_synthetic(root: str, synth, sensor_type: int,
                     n_scans: Optional[int] = None, end_of_sweep: bool = False,
                     standstill: float = 0.0, gps_every: int = 0,
                     gps_noise: float = 0.0, seed: int = 0) -> None:
    """Write a SyntheticSequence in the extracted layout above.

    ``standstill`` seconds of stationary IMU (gravity only) are prepended so
    profiles with IMU calibration enabled (ONA) can calibrate; scan/imu
    stamps shift accordingly.  ``gps_every`` > 0 emits a gps.csv fix at every
    Nth scan stamp (ground-truth position + ``gps_noise``).
    """
    sdir = os.path.join(root, "scans")
    os.makedirs(sdir, exist_ok=True)
    n = n_scans if n_scans is not None else synth.n_scans
    rng = np.random.default_rng(seed + 77)

    stamps, acc, gyro = synth.imu_stream()
    rows = []
    if standstill > 0:
        dt = 1.0 / synth.imu_rate
        k = int(round(standstill * synth.imu_rate))
        g = 9.81
        for j in range(k):
            rows.append([j * dt, 0.0, 0.0, g, 0.0, 0.0, 0.0])
    shift = standstill
    for t, a, w in zip(stamps, acc, gyro):
        rows.append([t + shift, *a, *w])
    np.savetxt(os.path.join(root, "imu.csv"), np.asarray(rows),
               delimiter=",", fmt="%.9f")

    scan_stamps = []
    gps_rows = []
    for i in range(n):
        stamp, pts, t_rel = synth.scan(i)
        stamp = stamp + shift
        t_raw = to_sensor_time(t_rel.astype(np.float64), stamp, sensor_type,
                               end_of_sweep)
        arr = np.concatenate(
            [pts.astype(np.float32), t_raw.astype(np.float32)[:, None]], axis=1)
        np.save(os.path.join(sdir, f"{i:06d}.npy"), arr)
        scan_stamps.append(stamp)
        if gps_every and i % gps_every == 0:
            p = synth.traj.pos(stamp - shift) + rng.normal(0, gps_noise, 3)
            gps_rows.append([stamp, *p])
    np.savetxt(os.path.join(sdir, "timestamps.txt"),
               np.asarray(scan_stamps), fmt="%.9f")
    if gps_rows:
        np.savetxt(os.path.join(root, "gps.csv"), np.asarray(gps_rows),
                   delimiter=",", fmt="%.9f")
