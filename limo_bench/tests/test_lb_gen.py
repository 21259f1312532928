"""The generator: deterministic from the seed, a world as long as the
drive, ring structure, and sweeps that are the world seen from the true
pose at each return's firing time."""

import math

import numpy as np
import torch

from gen import corridor


def _sweeps(seed, n=3, **sensor):
    return corridor.sweeps(seed, corridor.Drive(), corridor.Sensor(**sensor), n, "cpu")


def test_deterministic_from_a_large_seed():
    seed = 2 ** 31 + 12345
    a, b = _sweeps(seed, points_per_scan=1024), _sweeps(seed, points_per_scan=1024)
    c = _sweeps(seed + 1, points_per_scan=1024)
    for (sa, pa, ta), (sb, pb, tb) in zip(a, b):
        assert sa == sb and np.array_equal(pa, pb) and np.array_equal(ta, tb)
    assert not np.array_equal(a[1][1], c[1][1])
    ia, ib = (corridor.imu_stream(seed, corridor.Drive(), corridor.Sensor(), 5) for _ in "ab")
    assert all(np.array_equal(x, y) for x, y in zip(ia, ib))


def test_a_sweep_does_not_depend_on_the_others():
    d, s = corridor.Drive(), corridor.Sensor(points_per_scan=512)
    world = corridor.build_world(9, s, corridor.world_extent(d, s, 6), "cpu")
    one = corridor._sweep(9, 4, d, s, world)
    again = corridor.sweeps(9, d, s, 6, "cpu")[4]
    assert np.array_equal(one[1].numpy(), again[1])


def test_world_is_extended_at_the_same_density():
    d, s = corridor.Drive(), corridor.Sensor()
    ext = corridor.world_extent(d, s, 320)        # a 32 s drive at 15 m/s
    assert ext > 400 + 60
    world = corridor.build_world(1, s, ext, "cpu")
    assert float(world[:, 0].max()) > ext - 1.0
    ground = world[world[:, 2] == 0]
    per_m = len(ground) / (ext + 20.0)
    assert abs(per_m - 150_000 / 420.0) / (150_000 / 420.0) < 0.01
    x = ground[:, 0]
    near, far = ((x > 0) & (x < 100)).sum(), ((x > ext - 120) & (x < ext - 20)).sum()
    assert abs(int(near) - int(far)) < 0.05 * int(near)


def test_ring_returns_lie_on_the_beams():
    s = corridor.Sensor(points_per_scan=4096, ring_beams=16, beam_fov=(-0.3, 0.1),
                        noise_pt=0.0, world_density=2.0)
    d = corridor.Drive()
    stamp, pts, t = corridor.sweeps(5, d, s, 2, "cpu")[1]
    assert 0 < len(pts) <= 4096 and float(t.min()) >= 0 and float(t.max()) < 0.1
    # elevation at scan start, body frame: near one of the 16 beams
    world = _world_points(d, stamp, pts, t)
    p0, R0 = d.pos(np.float64(stamp)), d.rot(np.float64(stamp))
    body0 = (world - p0) @ R0
    el = np.arctan2(body0[:, 2], np.hypot(body0[:, 0], body0[:, 1]))
    spacing = 0.4 / 15
    off = np.abs((el + 0.3) / spacing - np.round((el + 0.3) / spacing)) * spacing
    assert float(np.quantile(off, 0.99)) < 0.26 * spacing
    # azimuth-coupled times: time grows with azimuth in the body frame
    az = np.mod(np.arctan2(body0[:, 1], body0[:, 0]), 2 * math.pi)
    assert np.corrcoef(az, t)[0, 1] > 0.99


def _world_points(d, stamp, pts, t):
    t_abs = stamp + t.astype(np.float64)
    return np.einsum("mij,mj->mi", d.rot(t_abs), pts.astype(np.float64)) + d.pos(t_abs)


def test_sweeps_are_the_world_from_the_true_pose():
    s = corridor.Sensor(points_per_scan=2048, noise_pt=0.0)
    d = corridor.Drive()
    world = corridor.build_world(3, s, corridor.world_extent(d, s, 4), "cpu").double()
    for stamp, pts, t in corridor.sweeps(3, d, s, 4, "cpu"):
        w = torch.from_numpy(_world_points(d, stamp, pts, t))
        nearest = torch.cdist(w, world).min(1).values
        assert float(nearest.max()) < 1e-3      # float32 points hundreds of metres out
        # the range gate is taken at the sweep's start pose
        rng = np.linalg.norm(w.numpy() - d.pos(np.float64(stamp)), axis=1)
        assert rng.min() > 1.999 and rng.max() < 60.001
