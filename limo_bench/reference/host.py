"""The reference's side of a run: what the host does before the step.

From the generated sweeps and IMU stream (the same arrays the program was
given) this works out again what the port's ``Localizer`` hands its step:
which IMU samples go with each scan, the epochs, the int16 transfer of the
points, the initial state.  ``step`` then runs the frozen plain step
(``reference.lio``) over one dispatch's scans, from the program's state
before that dispatch or from the reference's own initial state.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from reference.lio import mapper, pipeline, so3
from reference.lio import state as st
from reference.lio.config import Config


def config(fields: dict) -> Config:
    """The reference's ``Config`` with the configuration file's fields."""
    cfg = Config()

    def assign(obj, values):
        for k, v in values.items():
            if isinstance(v, dict):
                assign(getattr(obj, k), v)
            else:
                setattr(obj, k, v)

    assign(cfg, fields)
    return cfg


class Stream:
    """The inputs of a run: sweeps [(stamp, points (M,3), t_rel (M,))] and
    the IMU stream (stamps, acc, gyro), with the IMU batch of every scan."""

    def __init__(self, cfg: Config, sweeps, imu):
        if cfg.sensor_type != 1 or cfg.end_of_sweep:
            raise ValueError("the reference takes Velodyne-relative point times only")
        self.cfg, self.sweeps = cfg, sweeps
        self.imu_t, self.imu_acc, self.imu_gyro = imu
        # a scan is dispatched with the queued samples up to the first one at
        # or after its last point (Localizer.cpp:878-915)
        ends = [stamp + float(np.max(t.astype(np.float64))) for stamp, _, t in sweeps]
        last = np.searchsorted(self.imu_t, np.asarray(ends), side="left")
        self.batch_end = last + 1                   # exclusive
        self.batch_start = np.concatenate([[0], self.batch_end[:-1]])

    def batch(self, i: int, device) -> pipeline.ScanBatch:
        """Scan i as the step receives it: int16 points at the configured
        LSB and its time scale, IMU rows relative to the scan's stamp."""
        cfg = self.cfg
        N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch
        stamp, pts, t_rel = self.sweeps[i]
        n = min(len(pts), N)
        if len(pts) > N:
            sel = np.linspace(0, len(pts) - 1, N).astype(np.int64)
            pts, t_rel = pts[sel], t_rel[sel]
        lsb = np.float32(cfg.tpu.quantize_transfer)
        if lsb > 0:
            t_max = float(np.max(np.abs(t_rel))) if n else 0.0
            t_scale = np.float32(max(t_max, 1e-12) / 32767.0)
            qp = np.clip(np.rint(pts.astype(np.float64) * (1.0 / float(lsb))), -32767, 32767)
            qt = np.clip(np.rint(t_rel.astype(np.float64) * (1.0 / float(t_scale))),
                         -32767, 32767)
            points = torch.from_numpy(qp.astype(np.int16)).to(device).float() * float(lsb)
            t_raw = torch.from_numpy(qt.astype(np.int16)).to(device).float() * float(t_scale)
        else:
            points = torch.from_numpy(pts).to(device)
            t_raw = torch.from_numpy(t_rel).to(device)
        pad = N - n
        points = torch.cat([points, torch.zeros((pad, 3), device=device)])
        t_raw = torch.cat([t_raw, torch.zeros(pad, device=device)])
        a, b = int(self.batch_start[i]), int(self.batch_end[i])
        if b - a > K:
            raise ValueError(f"scan {i} has {b - a} IMU samples, more than imu_batch {K}")
        rows = np.zeros((K, 7), np.float32)
        rows[:b - a, 0:3] = self.imu_acc[a:b]
        rows[:b - a, 3:6] = self.imu_gyro[a:b]
        rows[:b - a, 6] = self.imu_t[a:b] - stamp
        r = torch.from_numpy(rows).to(device)
        shift = 0.0 if i == 0 else stamp - self.sweeps[i - 1][0]
        zero = torch.zeros((), device=device)
        return pipeline.ScanBatch(
            points=points, t_raw=t_raw, valid=torch.arange(N, device=device) < n,
            stamp=zero, epoch_shift=torch.tensor(np.float32(shift), device=device),
            imu_acc=r[:, 0:3], imu_gyro=r[:, 3:6], imu_stamp=r[:, 6],
            imu_valid=torch.arange(K, device=device) < (b - a))

    def initial_state(self, device) -> pipeline.LIOState:
        """The state before the first scan (Localizer's first dispatch: no
        calibration, the configured biases, the first sample one IMU
        period before it)."""
        cfg = self.cfg
        s = pipeline.init_state(cfg, device)
        period = float(self.imu_t[1] - self.imu_t[0])
        prev = self.imu_t[0] - self.sweeps[0][0] - period
        return s._replace(last_prop_time=torch.tensor(np.float32(prev), device=device))


def adopt(program_state, device) -> pipeline.LIOState:
    """The reference's ``LIOState`` of a program state, field by field by
    name; the map's planar mirror is worked out again from its table."""
    ps = program_state

    def t(v):
        return v.detach().to(device)

    x = st.NavState(*(t(getattr(ps.x, f)) for f in st.NavState._fields))
    m = ps.map
    table = t(m.table)
    bucket = (table.shape[1] // mapper.ROW_E - 4) // 4
    vmap = mapper.VoxelHashMap(table=table, ptable=mapper._planarize(table, bucket),
                               num_points=t(m.num_points), last_time=t(m.last_time))
    rest = {f: t(getattr(ps, f)) for f in pipeline.LIOState._fields if f not in ("x", "map")}
    return pipeline.LIOState(x=x, map=vmap, **rest)


def step(stream: Stream, scans: List[int], pre: Optional[object], device,
         step_fn=None):
    """Run the reference over one dispatch's scans: from ``pre`` (a program
    state) or, when None, from the reference's own initial state.
    Returns (state after, [ScanOutput a scan])."""
    s = stream.initial_state(device) if pre is None else adopt(pre, device)
    step_fn = step_fn or pipeline.build_scan_step(stream.cfg, device)
    outs = []
    for i in scans:
        s, out = step_fn(s, stream.batch(i, device))
        outs.append(out)
    return s, outs


def quat_angle(qa, qb) -> float:
    """The rotation angle (rad) between two unit quaternions."""
    d = so3.quat_mul(so3.quat_conj(qb.double()), qa.double())
    return float(2 * torch.atan2(torch.linalg.norm(d[1:]), torch.abs(d[0])))
