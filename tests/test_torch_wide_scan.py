"""The 128-beam configuration (``presets.ouster128_cfg`` on
``presets.ouster128_sequence``: the bench's corridor seen by an Ouster
OS1-128, 128 rings over ±22.5°, azimuth-coupled point times), the port
against the JAX package on the CPU.

At full width a scan holds 262 144 points and both K9 sorts of a scan take
them all (``max_insert_points = 0``, the JAX ``Config`` default): on the
card that is K9's grid route.  Here the suite runs 4 scans of 16 384
returns each, the rest of the configuration unchanged: stamps equal,
per-scan positions within 1e-3 m (tests/test_torch_pipeline.py's replay
bound) and ATE < 0.15 m in both packages.  ``PYTHONPATH=. python
tests/test_torch_wide_scan.py --slots 262144 --scans 24`` runs both at
full width and prints both ATEs and the largest |Δpos|: the witness behind
``chip_smoke.JAX_WIDE_ATE``.
"""

import dataclasses

import numpy as np

import bench
from fast_limo_tpu.models.localizer import Localizer as JLocalizer
from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.utils import presets

from test_torch_sequence import one_thread, port_cfg  # noqa: F401 (fixture)

N_SCANS, SLOTS = 4, 16384


def _jax_cfg(slots):
    cfg = bench.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = slots
    cfg.tpu.max_insert_points = 0
    return cfg


def _replay(loc, imu, scans):
    si = 0
    for t, a, g in zip(*imu):
        loc.update_imu(t, a, g)
        while si < len(scans) and scans[si][0] <= t:
            loc.update_pointcloud(*scans[si][1:], scans[si][0])
            si += 1


def _both(n_scans, slots):
    seq = presets.ouster128_sequence(n_scans=n_scans, points_per_scan=slots)
    imu, scans = seq.imu_stream(), [seq.scan(i) for i in range(n_scans)]
    assert all(s[1].shape == (slots, 3) for s in scans)   # a full sweep, every slot a return
    cfg = presets.ouster128_cfg()
    cfg.tpu.max_points_per_scan = slots
    got, want = Localizer(cfg, device="cpu"), JLocalizer(_jax_cfg(slots))
    for loc in (got, want):
        _replay(loc, imu, scans)
    pos, jpos = got.positions(), np.asarray(want.positions())
    ate = synthetic.ate_rmse(pos, seq.traj.pos(got.stamps()))
    ate_jax = synthetic.ate_rmse(jpos, seq.traj.pos(want.stamps()))
    print(f"128-beam corridor, {n_scans} scans at {slots} points: ATE port {ate:.5f} m, "
          f"JAX {ate_jax:.5f} m; max |dpos| {np.abs(pos - jpos).max():.6f} m")
    return got, want, pos, jpos, ate, ate_jax


def test_ouster128_cfg_is_the_bench_cfg_at_a_128_beam_width():
    """The preset is the JAX bench's configuration with the scan width of
    an OS1-128 sweep and the JAX ``Config``'s own insert width."""
    assert dataclasses.asdict(presets.ouster128_cfg()) == dataclasses.asdict(
        port_cfg(_jax_cfg(128 * 2048)))
    seq = presets.ouster128_sequence()
    assert (seq.ring_beams, seq.beam_fov, seq.points_per_scan) == (128, (-0.3927, 0.3927), 262144)


def test_wide_scans_match_jax():
    got, want, pos, jpos, ate, ate_jax = _both(N_SCANS, SLOTS)
    assert pos.shape == jpos.shape == (N_SCANS, 3)
    np.testing.assert_allclose(got.stamps(), want.stamps(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-3)
    assert ate < 0.15 and ate_jax < 0.15, (ate, ate_jax)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=N_SCANS)
    ap.add_argument("--slots", type=int, default=SLOTS)
    a = ap.parse_args()
    _both(a.scans, a.slots)
