"""KITTI raw-synced dataset reader (port of fast_limo_tpu/io/kitti.py; the
reference's kitti.launch workflow, `config/kitti.yaml` + rosbag replay,
README.md:193-199 — here read directly from the extracted raw layout, no
ROS).

Expected directory layout (raw *_sync drives):
    <drive>/velodyne_points/data/NNNNNNNNNN.bin
    <drive>/velodyne_points/timestamps.txt
    <drive>/oxts/data/NNNNNNNNNN.txt
    <drive>/oxts/timestamps.txt

OXTS rows: lat lon alt roll pitch yaw vn ve vf vl vu ax ay az af al au
wx wy wz wf wl wu … — we use body-frame accel (af, al, au → idx 14..16)
and body-frame rates (wf, wl, wu → idx 20..22).
"""

from __future__ import annotations

import datetime as _dt
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fast_limo_tpu_torch.io import native


def _parse_timestamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # 2011-09-26 13:02:25.594360375
            date, clock = line.split(" ")
            h, m, s = clock.split(":")
            y, mo, d = date.split("-")
            frac = float(s)
            base = _dt.datetime(int(y), int(mo), int(d), int(h), int(m)).timestamp()
            out.append(base + frac)
    return np.asarray(out, np.float64)


@dataclass
class KittiDrive:
    root: str
    max_points: int = 200_000

    def __post_init__(self):
        vp = os.path.join(self.root, "velodyne_points")
        ox = os.path.join(self.root, "oxts")
        self.scan_files = sorted(
            os.path.join(vp, "data", f) for f in os.listdir(os.path.join(vp, "data"))
            if f.endswith(".bin"))
        self.scan_stamps = _parse_timestamps(os.path.join(vp, "timestamps.txt"))
        self.oxts_files = sorted(
            os.path.join(ox, "data", f) for f in os.listdir(os.path.join(ox, "data"))
            if f.endswith(".txt"))
        self.imu_stamps = _parse_timestamps(os.path.join(ox, "timestamps.txt"))
        if len(self.scan_files) != len(self.scan_stamps):
            raise ValueError(f"{len(self.scan_files)} scan files vs {len(self.scan_stamps)} "
                             f"stamps in {vp}")
        if len(self.oxts_files) != len(self.imu_stamps):
            raise ValueError(f"{len(self.oxts_files)} OXTS files vs {len(self.imu_stamps)} "
                             f"stamps in {ox}")

    def __len__(self):
        return len(self.scan_files)

    def imu(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        """(stamp, accel (3,), gyro (3,)) — body-frame (f,l,u) OXTS channels."""
        row = np.loadtxt(self.oxts_files[i])
        acc = row[14:17]
        gyro = row[20:23]
        return float(self.imu_stamps[i]), acc, gyro

    def scan(self, i: int) -> Tuple[float, np.ndarray, np.ndarray]:
        """(stamp, xyz (n,3), t_rel (n,)) with azimuth-derived point times."""
        xyz, _inten, t_rel = native.parse_kitti_bin(
            self.scan_files[i], max_points=self.max_points)
        return float(self.scan_stamps[i]), xyz, t_rel

    def stream(self) -> Iterator[Tuple[str, int]]:
        """Time-merged event stream: yields ('imu'|'scan', index)."""
        events: List[Tuple[float, str, int]] = []
        events += [(t, "imu", i) for i, t in enumerate(self.imu_stamps)]
        events += [(t, "scan", i) for i, t in enumerate(self.scan_stamps)]
        events.sort()
        for _, kind, i in events:
            yield kind, i


def run_drive(localizer, drive: KittiDrive, n_scans: Optional[int] = None) -> None:
    """Feed a drive through a Localizer/SLAM instance (or an AsyncIngest
    over one) in timestamp order, then flush it."""
    done = 0
    try:
        for kind, i in drive.stream():
            if kind == "imu":
                stamp, acc, gyro = drive.imu(i)
                localizer.update_imu(stamp, acc, gyro)
            else:
                stamp, xyz, t_rel = drive.scan(i)
                localizer.update_pointcloud(xyz, t_rel, stamp)
                done += 1
                if n_scans is not None and done >= n_scans:
                    return
    finally:
        flush = getattr(localizer, "flush", None)
        if flush is not None:
            flush()   # end-of-stream partial chunk (chunked replay mode)
