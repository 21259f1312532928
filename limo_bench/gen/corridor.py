"""The benchmark's synthetic drive: a LiDAR-inertial corridor made from a seed.

A copy of the port's synthetic generator (``io/synthetic``: the smooth
corridor drive, the planar world of ground and wall segments, IMU specific
force and gyro with noise, sweeps observed from the exact pose at each
point's firing time), with two changes for long runs:

* the world is built as long as the drive needs, at the default world's
  point density (150 000 ground and 150 000 wall points over 420 m), where
  the original ends at 400 m (26.7 s at 15 m/s);
* sweeps are drawn with torch on the device the caller names, so that a
  262 144-point ring sweep costs milliseconds and not a second of host
  time.  Every draw of sweep ``i`` comes from a generator keyed by
  (seed, 1, i), so a sweep does not depend on which others were drawn.

Sensor model (``Sensor``): ``ring_beams = 0`` draws returns uniformly over
the visible surfaces with uniform firing times (the corridor the JAX bench
runs); ``ring_beams > 0`` keeps only returns near the beams' elevations and
times each return by its azimuth at the pose at firing time (one fixed-point
refinement), a spinning lidar.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import List, Tuple

import numpy as np
import torch

G = 9.81
_LEN0 = 420.0          # length of the original world: x in [-20, 400]
_PTS0 = 150_000        # its ground points, and its wall points
_SEG0 = 40             # its wall segments


@dataclass(frozen=True)
class Drive:
    """The corridor drive (``io/synthetic.Trajectory``), starting at rest."""

    v_forward: float = 15.0
    ramp_tau: float = 1.0
    weave_amp: float = 1.5
    weave_freq: float = 0.18
    yaw_amp: float = 0.5
    yaw_freq: float = 0.15
    z_amp: float = 0.1
    z_freq: float = 0.4

    def pos(self, t):
        """World positions (…, 3) at times ``t`` (numpy or torch float64)."""
        xp = torch if torch.is_tensor(t) else np
        tau, ww, wz = self.ramp_tau, 2 * math.pi * self.weave_freq, 2 * math.pi * self.z_freq
        return xp.stack([
            self.v_forward * (t + tau * (xp.exp(-t / tau) - 1.0)),
            self.weave_amp / 2 * (1 - xp.cos(ww * t)),
            self.z_amp / 2 * (1 - xp.cos(wz * t))], -1)

    def acc(self, t):
        tau, ww, wz = self.ramp_tau, 2 * math.pi * self.weave_freq, 2 * math.pi * self.z_freq
        return np.stack([
            self.v_forward / tau * np.exp(-t / tau),
            self.weave_amp / 2 * ww * ww * np.cos(ww * t),
            self.z_amp / 2 * wz * wz * np.cos(wz * t)], -1)

    def yaw(self, t):
        xp = torch if torch.is_tensor(t) else np
        return self.yaw_amp / 2 * (1 - xp.cos(2 * math.pi * self.yaw_freq * t))

    def yaw_rate(self, t):
        wy = 2 * math.pi * self.yaw_freq
        return self.yaw_amp / 2 * wy * np.sin(wy * t)

    def rot(self, t):
        """World←body rotations (…, 3, 3), yaw only."""
        xp = torch if torch.is_tensor(t) else np
        y = self.yaw(t)
        c, s = xp.cos(y), xp.sin(y)
        z, o = c * 0, c * 0 + 1
        return xp.stack([xp.stack([c, -s, z], -1), xp.stack([s, c, z], -1),
                         xp.stack([z, z, o], -1)], -2)


@dataclass(frozen=True)
class Sensor:
    """The lidar and IMU: rates, returns a sweep, range gate, noise, rings."""

    scan_rate: float = 10.0
    imu_rate: float = 100.0
    points_per_scan: int = 32768
    max_range: float = 60.0
    min_range: float = 2.0
    noise_pt: float = 0.01
    noise_gyro: float = 5e-4
    noise_acc: float = 5e-3
    ring_beams: int = 0
    beam_fov: Tuple[float, float] = (-0.4346, 0.0349)
    world_density: float = 1.0     # surface density, times the default world's


def from_dict(cls, d: dict):
    """``cls(**d)`` over the keys ``cls`` has (lists become tuples)."""
    names = {f.name for f in fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _torch_gen(device, *key) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed & (2 ** 63 - 1))
    return g


def world_extent(drive: Drive, sensor: Sensor, n_scans: int) -> float:
    """The far end of the world: the last sweep's position plus the range."""
    t_end = (n_scans + 1) / sensor.scan_rate
    return float(drive.pos(np.float64(t_end))[0]) + sensor.max_range + 20.0


def build_world(seed: int, sensor: Sensor, extent: float, device) -> torch.Tensor:
    """(P, 3) float32 points on the ground plane and on wall segments that
    alternate sides along the +x corridor over x in [-20, extent], at the
    default world's density times ``sensor.world_density``."""
    g = _torch_gen(device, seed, 3)
    length = extent + 20.0
    f32 = dict(dtype=torch.float32, device=device)
    n_ground = int(round(_PTS0 * sensor.world_density * length / _LEN0))
    gx = torch.rand(n_ground, generator=g, **f32) * length - 20.0
    gy = (torch.rand(n_ground, generator=g, **f32) * 2 - 1) * 14.0
    parts = [torch.stack([gx, gy, torch.zeros_like(gx)], 1)]
    seg_len = _LEN0 / _SEG0
    n_seg = int(math.ceil(length / seg_len))
    per = int(round(_PTS0 / _SEG0 * sensor.world_density))
    u = torch.rand((n_seg, 4), generator=g, dtype=torch.float64, device=device)
    tilt = torch.randn((n_seg, 2), generator=g, dtype=torch.float64, device=device) * 0.08
    x0 = -20.0 + seg_len * torch.arange(n_seg, dtype=torch.float64, device=device)
    side = torch.where(torch.arange(n_seg, device=device) % 2 == 1, -1.0, 1.0).double()
    yw = side * 14.0 * (0.8 + 0.2 * u[:, 0])
    xs = x0[:, None] + torch.rand((n_seg, per), generator=g, dtype=torch.float64,
                                  device=device) * seg_len * 1.4
    zs = torch.rand((n_seg, per), generator=g, dtype=torch.float64, device=device) * 6.0
    ys = yw[:, None] + tilt[:, :1] * (xs - x0[:, None]) + tilt[:, 1:] * zs
    parts.append(torch.stack([xs, ys, zs], -1).reshape(-1, 3).float())
    return torch.cat(parts)


def imu_stream(seed: int, drive: Drive, sensor: Sensor, n_scans: int):
    """All IMU samples of the drive: (stamps (K,) f64, acc (K,3) f32, gyro (K,3) f32)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
    t_end = (n_scans + 1) / sensor.scan_rate
    stamps = np.arange(1, int(t_end * sensor.imu_rate) + 2) / sensor.imu_rate
    R = drive.rot(stamps)
    f_w = drive.acc(stamps) - np.array([0.0, 0.0, -G])
    acc = np.einsum("kij,kj->ki", R.transpose(0, 2, 1), f_w)
    gyro = np.stack([0 * stamps, 0 * stamps, drive.yaw_rate(stamps)], -1)
    acc = acc + rng.normal(0, sensor.noise_acc, acc.shape)
    gyro = gyro + rng.normal(0, sensor.noise_gyro, gyro.shape)
    return stamps, acc.astype(np.float32), gyro.astype(np.float32)


def _sweep(seed: int, i: int, drive: Drive, sensor: Sensor, world: torch.Tensor):
    """Sweep ``i`` on the world's device: (stamp, points (M,3) f32 in the
    sensor frame, t_rel (M,) f32 seconds after the stamp)."""
    dev = world.device
    g = _torch_gen(dev, seed, 1, i)
    stamp = (i + 1) / sensor.scan_rate
    period = 1.0 / sensor.scan_rate
    M = sensor.points_per_scan
    p0 = drive.pos(np.float64(stamp))
    d = torch.linalg.norm(world - torch.tensor(p0, dtype=torch.float32, device=dev), dim=1)
    ok = (d > sensor.min_range) & (d < sensor.max_range)
    if sensor.ring_beams:
        R0 = torch.tensor(drive.rot(np.float64(stamp)), dtype=torch.float64, device=dev)
        body0 = (world.double() - torch.tensor(p0, dtype=torch.float64, device=dev)) @ R0
        el = torch.atan2(body0[:, 2], torch.hypot(body0[:, 0], body0[:, 1]))
        lo, hi = sensor.beam_fov
        spacing = (hi - lo) / max(sensor.ring_beams - 1, 1)
        bi = torch.clamp(torch.round((el - lo) / spacing), 0, sensor.ring_beams - 1)
        ok &= torch.abs(el - (lo + bi * spacing)) < 0.25 * spacing
    vis = torch.nonzero(ok).squeeze(1)
    if len(vis) >= M or sensor.ring_beams:
        pick = vis[torch.randperm(len(vis), generator=g, device=dev)[:M]]
    else:
        pick = vis[torch.randint(len(vis), (M,), generator=g, device=dev)]
    pw = world[pick].double()
    n = len(pick)
    if sensor.ring_beams:
        def az_time(t_abs):
            pb = torch.einsum("mji,mj->mi", drive.rot(t_abs), pw - drive.pos(t_abs))
            return torch.remainder(torch.atan2(pb[:, 1], pb[:, 0]), 2 * math.pi) / (2 * math.pi) * period

        t_rel = az_time(torch.full((n,), stamp, dtype=torch.float64, device=dev))
        t_rel = az_time(stamp + t_rel)
    else:
        t_rel = torch.rand(n, generator=g, dtype=torch.float64, device=dev) * period
    t_abs = stamp + t_rel
    pl = torch.einsum("mji,mj->mi", drive.rot(t_abs), pw - drive.pos(t_abs))
    pl = pl + torch.randn(pl.shape, generator=g, dtype=torch.float64, device=dev) * sensor.noise_pt
    return stamp, pl.float(), t_rel.float()


def sweeps(seed: int, drive: Drive, sensor: Sensor, n_scans: int, device) -> List[tuple]:
    """Sweeps 0 … n_scans−1 as host arrays: [(stamp, points (M,3) f32,
    t_rel (M,) f32)], drawn on ``device`` and copied to the host once."""
    world = build_world(seed, sensor, world_extent(drive, sensor, n_scans), device)
    raw = [_sweep(seed, i, drive, sensor, world) for i in range(n_scans)]
    sizes = [len(t) for _, _, t in raw]
    pts = torch.cat([p for _, p, _ in raw]).cpu().numpy()
    ts = torch.cat([t for _, _, t in raw]).cpu().numpy()
    out, o = [], 0
    for (stamp, _, _), n in zip(raw, sizes):
        out.append((stamp, pts[o:o + n], ts[o:o + n]))
        o += n
    return out
