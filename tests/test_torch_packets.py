"""Per-packet streaming on the port (io/packets.py; twins of
tests/test_packets.py:32,78 at CPU size): the engine tracks when fed
quarter-sweep packets, agrees with the JAX engine fed the same packets, and
``SLAM._flush_sweep`` stitches a sweep's packet clouds into one keyframe
candidate in the last packet's body frame.

Six sweeps of 4096 points, four packets a sweep (24 dispatches, each with
the sweep's header stamp, so packets 2-4 dispatch with epoch_shift 0).
Positions are held to the JAX SLAM's at 1e-3 m and stamps at 1e-9 s
(tests/test_torch_pipeline.py:156-157); the packet trajectory's ATE stays
under max(3 × the full-sweep ATE, 0.15 m) (tests/test_packets.py:51); each
stitched cloud equals body_L = R_Lᵀ(R_i·c_i + p_i − p_L) over the sweep's
packet outputs to 1e-4 m.
"""

import numpy as np
import pytest

from fast_limo_tpu.io.packets import PacketSlicer as JPacketSlicer
from fast_limo_tpu.models.slam import LoopConfig as JLoopConfig
from fast_limo_tpu.models.slam import SLAM as JSLAM
from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.io.packets import PacketSlicer
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.models.slam import SLAM, LoopConfig

from test_pipeline import small_cfg
from test_torch_sequence import one_thread, port_cfg  # noqa: F401 (fixture)

N_SWEEPS, N_PACKETS = 6, 4
LOOP_KW = dict(kf_dist=0.5, exclude_recent=8)


def _seq():
    return synthetic.SyntheticSequence(
        seed=4, n_scans=N_SWEEPS, points_per_scan=4096,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3)


def _drive(engine, seq, slicer=None):
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    si = 0
    for k in range(len(stamps)):
        engine.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            st, pts, traw = scans[si]
            if slicer is None:
                engine.update_pointcloud(pts, traw, st)
            else:
                for p_pts, p_traw, p_st in slicer.packets(pts, traw, st):
                    engine.update_pointcloud(p_pts, p_traw, p_st)
            si += 1
    engine.flush()
    return engine


def _quat_rotate(q, v):
    w, u = q[0], q[1:]
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


@pytest.fixture(scope="module")
def runs():
    seq = _seq()
    full = _drive(Localizer(port_cfg(small_cfg()), device="cpu"), seq)
    pk = SLAM(port_cfg(small_cfg()), LoopConfig(**LOOP_KW), device="cpu")
    flushes = []
    o_flush, o_consider = pk._flush_sweep, pk._consider_keyframe

    def flush_sweep():
        flushes.append({"buf": [(e[2].copy(), e[3].copy(), e[4].numpy().copy(),
                                 e[5].numpy().copy()) for e in pk._sweep_buf]})
        o_flush()

    def consider(scan_idx, stamp, pos, quat, body, valid):
        flushes[-1]["candidate"] = (pos.copy(), quat.copy(), body.numpy().copy(),
                                    valid.numpy().copy())
        o_consider(scan_idx, stamp, pos, quat, body, valid)

    pk._flush_sweep, pk._consider_keyframe = flush_sweep, consider
    _drive(pk, seq, PacketSlicer(n_packets=N_PACKETS))
    jpk = _drive(JSLAM(small_cfg(), JLoopConfig(**LOOP_KW)), seq,
                 JPacketSlicer(n_packets=N_PACKETS))
    return seq, full, pk, jpk, [f for f in flushes if f["buf"]]


def test_packet_replay_matches_jax(runs):
    _seq_, _full, pk, jpk, _f = runs
    assert len(pk.trajectory) == len(jpk.trajectory) == N_PACKETS * N_SWEEPS
    np.testing.assert_allclose(pk.stamps(), jpk.stamps(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pk.positions(), jpk.positions(), rtol=0, atol=1e-3)
    # the packets of a sweep share its header stamp: epoch_shift 0 after the first
    epochs = [e for e, _out in pk.loc._raw_outputs]
    assert len(epochs) == N_PACKETS * N_SWEEPS and len(set(epochs)) == N_SWEEPS
    assert len(pk.keyframes) == len(jpk.keyframes) >= 2
    np.testing.assert_allclose([k.pos for k in pk.keyframes], [k.pos for k in jpk.keyframes],
                               rtol=0, atol=1e-3)


def test_packet_replay_tracks_like_full_sweeps(runs):
    seq, full, pk, _jpk, _f = runs
    assert len(full.trajectory) == N_SWEEPS
    ate_full = synthetic.ate_rmse(full.positions(), seq.traj.pos(full.stamps()))
    ate_pk = synthetic.ate_rmse(pk.positions(), seq.traj.pos(pk.stamps()))
    assert ate_pk < max(3.0 * ate_full, 0.15), (ate_pk, ate_full)


def test_sweep_stitching(runs):
    """One keyframe candidate a sweep, its cloud the sweep's packet clouds
    moved into the last packet's body frame."""
    _seq_, _full, _pk, _jpk, flushes = runs
    assert len(flushes) == N_SWEEPS
    for f in flushes:
        buf = f["buf"]
        assert len(buf) == N_PACKETS
        pos_l, quat_l, _c, _v = buf[-1]
        conj = quat_l * np.array([1.0, -1.0, -1.0, -1.0])
        want = np.concatenate([
            _quat_rotate(conj, _quat_rotate(q.astype(np.float64), c.astype(np.float64))
                         + p - pos_l) for p, q, c, _v in buf])
        pos, quat, body, valid = f["candidate"]
        np.testing.assert_array_equal(pos, pos_l)
        np.testing.assert_array_equal(quat, quat_l)
        assert body.shape == want.shape
        np.testing.assert_allclose(body, want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(valid, np.concatenate([v for *_x, v in buf]))
        assert valid.sum() > 0
