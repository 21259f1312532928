"""Packet streaming on the bench's fast corridor (15 m/s, ±0.5 rad yaw
weave; ``presets.bench_sequence``), the port against the JAX package.

A quarter-sweep packet of this corridor constrains the registration far
less than a sweep, and both packages drift by up to about 0.3 m between the
second sweep and the end of the run, on the same packets: over the 24
sweeps that ``chip_smoke.py`` phase 10 (c) replays, the JAX package's ATE in
4 packets exceeds tests/test_packets.py's max(3 × the sweep ATE, 0.15 m) at
8192 and 32768 slots (run this file as a script to print it).  That is the
reference's packet-mode behaviour on this corridor, not the port's.
At ``kitti_like_cfg`` with 8192 slots (32768-point sweeps stride-downsampled),
eight sweeps in four packets: the port's ATE within 25 % of the JAX
package's and every packet's position within 0.1 m of it.  The two float32
programs part by a few centimetres here (each registration of a 90° wedge
amplifies their summation-order differences), a tenth of the drift both
show; a port that tracked this corridor differently from the reference
would leave either bound.  ``python -m pytest
tests/test_torch_packet_corridor.py -s`` prints both ATEs and the largest
position difference; ``PYTHONPATH=. python tests/test_torch_packet_corridor.py
--sweeps 24 --slots 32768`` runs both packages at another length or width (32768 is
``kitti_like_cfg``'s own, left uncut) and prints the same line.
"""

import dataclasses

import numpy as np

import bench
from fast_limo_tpu.io.packets import PacketSlicer as JPacketSlicer
from fast_limo_tpu.models.slam import SLAM as JSLAM
from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.io.packets import PacketSlicer
from fast_limo_tpu_torch.models.slam import SLAM
from fast_limo_tpu_torch.utils import presets
from fast_limo_tpu_torch.utils.config import Config

from test_torch_sequence import one_thread  # noqa: F401 (fixture)

N_SWEEPS, N_PACKETS, SLOTS = 8, 4, 8192


def _cfg(cfg, slots=SLOTS):
    if slots != cfg.tpu.max_points_per_scan:
        cfg.tpu.max_points_per_scan = slots
        cfg.ikfom.mapping.MAX_NUM_PC2MATCH = slots // 2
        cfg.tpu.max_insert_points = slots // 2
    return cfg


def _port_cfg(src) -> Config:
    out = Config()
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        setattr(out, f.name, dataclasses.replace(v) if dataclasses.is_dataclass(v) else v)
    return out


def _replay(slam, seq, slicer):
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    si = 0
    for k in range(len(stamps)):
        slam.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            for p_pts, p_traw, p_st in slicer.packets(scans[si][1], scans[si][2], scans[si][0]):
                slam.update_pointcloud(p_pts, p_traw, p_st)
            si += 1
    slam.flush()
    return slam


def _both(n_sweeps, slots, n_packets):
    seq = presets.bench_sequence(n_scans=n_sweeps)
    got = _replay(SLAM(_cfg(_port_cfg(bench.kitti_like_cfg()), slots), device="cpu"), seq,
                  PacketSlicer(n_packets))
    want = _replay(JSLAM(_cfg(bench.kitti_like_cfg(), slots)), seq, JPacketSlicer(n_packets))
    pos, jpos = got.positions(), np.asarray(want.positions())
    ate = synthetic.ate_rmse(pos, seq.traj.pos(got.stamps()))
    ate_jax = synthetic.ate_rmse(jpos, seq.traj.pos(want.stamps()))
    print(f"corridor, {n_sweeps} sweeps in {n_packets} packets at {slots} slots: ATE port "
          f"{ate:.4f} m, JAX {ate_jax:.4f} m; max |dpos| {np.abs(pos - jpos).max():.4f} m")
    return got, want, pos, jpos, ate, ate_jax


def test_corridor_packets_match_jax():
    got, want, pos, jpos, ate, ate_jax = _both(N_SWEEPS, SLOTS, N_PACKETS)
    assert len(got.trajectory) == len(want.trajectory) == N_SWEEPS * N_PACKETS
    np.testing.assert_allclose(got.stamps(), want.stamps(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=0.1)
    assert abs(ate - ate_jax) <= 0.25 * ate_jax


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweeps", type=int, default=N_SWEEPS)
    ap.add_argument("--slots", type=int, default=SLOTS)
    ap.add_argument("--packets", type=int, default=N_PACKETS)
    a = ap.parse_args()
    _both(a.sweeps, a.slots, a.packets)
