"""The port's streaming and replay entry points against the JAX package, at
``__graft_entry__._tiny_cfg`` sizes (512-point scans, 4096-entry map) with
the KITTI-like map/filter geometry of tests/test_torch_pipeline.py and an
IMU batch of 16, so that a scan's ~10 IMU samples fit and only the first
scan folds a backlog (a fold runs at pack time, ahead of the chunk it
precedes, in both packages alike).

- the packed, split and chunk steps unpack to exactly the batch
  ``build_scan_step`` takes (tests/test_pipeline.py:145-204), and their
  dequantized int16 points equal the JAX split/packed steps' bit for bit;
- the port Localizer's int16 packs equal the JAX Localizer's on the same
  scans, also on ring sweeps larger than the slots (stride-downsampled on
  the host) at C = 1 and C = 4;
- chunked replay (C = 4, 11 scans: the last chunk is partial, sent by
  ``flush()``) equals the one-scan path bit for bit (the same steps in the
  same order on the CPU), and ``on_dispatch`` fires once a scan on both
  paths with equal packs (tests/test_pipeline.py:217-304);
- the native packer equals its NumPy twin and clips (tests/test_native.py);
- ``AsyncIngest`` equals the synchronous replay (tests/test_stream.py) and
  drops and counts IMU records on a full ring;
- ``board()`` renders; the int16 Localizer tracks (ATE < 0.08 m,
  tests/test_pipeline.py:206-214); ``presets.kitti_like_cfg`` is the bench's.
"""

import dataclasses
import os
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.models.localizer import Localizer as JLocalizer
from fast_limo_tpu.utils.config import Config as JConfig
from fast_limo_tpu_torch.io import native, synthetic
from fast_limo_tpu_torch.io.stream import AsyncIngest
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.utils import interop, presets
from fast_limo_tpu_torch.utils.config import Config
from tests import test_torch_pipeline as tp

N_SCANS = 11
QUANT = 0.004


def _cfg(cls, quant=QUANT, chunk=1):
    cfg = tp._cfg(cls)
    cfg.tpu.imu_batch = 16
    cfg.tpu.quantize_transfer = quant
    cfg.tpu.scan_chunk = chunk
    return cfg


def _stream(seq):
    stamps, acc, gyro = seq.imu_stream()
    return seq, stamps, acc, gyro, [seq.scan(i) for i in range(seq.n_scans)]


@pytest.fixture(scope="module")
def stream():
    return _stream(presets.bench_sequence(seed=7, n_scans=N_SCANS, points_per_scan=512))


@pytest.fixture(scope="module")
def oversize():
    """Six ring sweeps of 1 500 returns on 16 rings (the HDL-64E's field of
    view, azimuth-coupled firing times) for 512 slots."""
    return _stream(synthetic.SyntheticSequence(
        seed=5, n_scans=6, points_per_scan=1500, noise_pt=0.01, noise_gyro=5e-4,
        noise_acc=5e-3, traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5),
        ring_beams=16, beam_fov=(-0.4346, 0.0349)))


def _replay(loc, stream):
    """Feed the stream in arrival order, flush, and return the packs
    ``on_dispatch`` saw."""
    _, stamps, acc, gyro, scans = stream
    packs = []
    loc.on_dispatch = lambda sp, ip: packs.append((np.array(sp, copy=True),
                                                   np.array(ip, copy=True)))
    si = 0
    for k in range(len(stamps)):
        loc.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            loc.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
    loc.flush()
    return packs


@pytest.fixture(scope="module")
def runs(stream):
    """The int16 stream through the port at C = 1 and C = 4."""
    out = {}
    for chunk in (1, 4):
        loc = Localizer(_cfg(Config, chunk=chunk), device="cpu")
        out[chunk] = (loc, _replay(loc, stream))
    return out


def _jax_replay(stream):
    """The packs the JAX Localizer dispatches for ``stream`` (its scan step
    stubbed out: only the packing is compared)."""
    jl = JLocalizer(_cfg(JConfig))
    stub = jpl.ScanOutput(*([jnp.zeros(3)] * 10))
    jl.scan_step = lambda s, scan_buf, imu_pack: (s, stub)
    return _replay(jl, stream)


@pytest.fixture(scope="module")
def jax_packs(stream):
    return _jax_replay(stream)


@pytest.fixture(scope="module")
def jax_oversize_packs(oversize):
    return _jax_replay(oversize)


def _random_packs(cfg, rng, quant):
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch
    npts, nimu = N - 100, K - 5
    pts = rng.uniform(-20, 20, (npts, 3)).astype(np.float32)
    traw = np.linspace(0, 0.1, npts).astype(np.float32)
    if quant > 0:
        scan_pack, t_scale, _ = native.pack_scan_i16_numpy(pts, traw, N, quant)
    else:
        scan_pack, t_scale = np.zeros((N, 4), np.float32), 1.0
        scan_pack[:npts, :3], scan_pack[:npts, 3] = pts, traw
    imu_pack = np.zeros((K, 8), np.float32)
    imu_pack[:nimu, 0:3] = rng.normal(0, 0.05, (nimu, 3)) + [0, 0, 9.81]
    imu_pack[:nimu, 3:6] = rng.normal(0, 0.01, (nimu, 3))
    imu_pack[:nimu, 6] = np.linspace(0.005, 0.105, nimu)
    imu_pack[0:5, 7] = (npts, nimu, 0.1, t_scale, 1.0)
    return scan_pack, imu_pack


def _equal_trees(a, b):
    la, lb = interop.lio_state_to_numpy(a[0]), interop.lio_state_to_numpy(b[0])
    assert set(la) == set(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert a[1].debug is None and b[1].debug is None     # cfg.debug is off here
    for f in pl.ScanOutput._fields[:-1]:
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f


def test_config_is_the_bench_config():
    assert dataclasses.asdict(presets.kitti_like_cfg()) == dataclasses.asdict(bench.kitti_like_cfg())
    assert presets.kitti_like_cfg().tpu.quantize_transfer == 0.004


@pytest.mark.parametrize("quant", [0.0, QUANT])
def test_packed_split_and_chunk_steps_match_unpacked(quant):
    """Each entry point unpacks to exactly the ScanBatch of
    ``build_scan_step`` (int16 dequantized by one float32 multiply); a
    padding element of the chunk step leaves the state as it was."""
    cfg = _cfg(Config, quant=quant)
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch
    scan_pack, imu_pack = _random_packs(cfg, np.random.default_rng(0), quant)
    if quant > 0:
        points = scan_pack[:, :3].astype(np.float32) * np.float32(quant)
        t_raw = scan_pack[:, 3].astype(np.float32) * imu_pack[3, 7]
    else:
        points, t_raw = scan_pack[:, :3], scan_pack[:, 3]
    b = pl.ScanBatch(
        points=torch.tensor(points), t_raw=torch.tensor(t_raw),
        valid=torch.arange(N) < int(imu_pack[0, 7]), stamp=torch.zeros(()),
        epoch_shift=torch.tensor(imu_pack[2, 7]), imu_acc=torch.tensor(imu_pack[:, 0:3]),
        imu_gyro=torch.tensor(imu_pack[:, 3:6]), imu_stamp=torch.tensor(imu_pack[:, 6]),
        imu_valid=torch.arange(K) < int(imu_pack[1, 7]))
    s0 = pl.init_state(cfg, "cpu")
    want = pl.build_scan_step(cfg, "cpu")(s0, b)
    sp, ip = torch.tensor(scan_pack), torch.tensor(imu_pack)
    _equal_trees(pl.build_scan_step_split(cfg, "cpu")(s0, sp, ip), want)
    fused = torch.tensor(pl.fuse_packs(scan_pack, imu_pack))
    _equal_trees(pl.build_scan_step_packed(cfg, "cpu")(s0, fused), want)

    pad = torch.zeros_like(ip)
    s2, out = pl.build_scan_chunk_step(cfg, "cpu")(
        s0, torch.stack([sp, torch.zeros_like(sp)]), torch.stack([ip, pad]))
    _equal_trees((s2, pl.ScanOutput(*(f[0] for f in out[:-1]))), want)
    assert out.pos.shape == (2, 3) and int(out.n_pc2match[1]) == 0
    assert not bool(out.final_valid[1].any())
    s3, _ = pl.build_scan_chunk_step(cfg, "cpu")(s0, torch.zeros_like(sp)[None], pad[None])
    _equal_trees((s3, want[1]), (s0, want[1]))


@pytest.mark.parametrize("quant", [0.0, QUANT])
def test_unpacked_batches_match_jax(monkeypatch, jax_packs, quant):
    """The split and packed steps of both packages hand their inner step
    the same batch bit for bit, on the JAX Localizer's own packs (the
    float32 case with the float32 payload of the same scans)."""
    monkeypatch.setattr(jpl, "build_scan_step", lambda cfg, **kw: (lambda s, b: (s, b)))
    monkeypatch.setattr(pl, "build_scan_step", lambda cfg, *a: (lambda s, b: (s, b)))
    jcfg, cfg = _cfg(JConfig, quant=quant), _cfg(Config, quant=quant)
    jsplit, jpacked = jpl.build_scan_step_split(jcfg), jpl.build_scan_step_packed(jcfg)
    split, packed = pl.build_scan_step_split(cfg, "cpu"), pl.build_scan_step_packed(cfg, "cpu")
    for scan_pack, imu_pack in jax_packs[:4]:
        if quant == 0:
            pts = scan_pack[:, :3].astype(np.float32) * np.float32(QUANT)
            scan_pack = np.concatenate([pts, scan_pack[:, 3:].astype(np.float32)
                                        * imu_pack[3, 7]], axis=1)
        fused = pl.fuse_packs(scan_pack, imu_pack)
        want = [jsplit(jnp.zeros(()), jnp.asarray(scan_pack), jnp.asarray(imu_pack))[1],
                jpacked(jnp.zeros(()), jnp.asarray(fused))[1]]
        got = [split(None, torch.tensor(scan_pack), torch.tensor(imu_pack))[1],
               packed(None, torch.tensor(fused))[1]]
        for g, w in zip(got, want):
            for f in pl.ScanBatch._fields:
                np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                              err_msg=f)


def test_int16_packs_match_jax_localizer(runs, jax_packs):
    packs = runs[1][1]
    assert len(packs) == len(jax_packs) == N_SCANS
    for (s1, i1), (s2, i2) in zip(packs, jax_packs):
        assert s1.dtype == s2.dtype == np.int16
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("chunk", [1, 4])
def test_oversize_packs_match_jax_localizer(oversize, jax_oversize_packs, chunk):
    """Every sweep overflows the slots, so each pack is the host's stride
    selection of its sweep, packed to int16: bit for bit the JAX
    Localizer's, on the one-scan and the chunked path."""
    scans = oversize[4]
    n_slots = _cfg(Config).tpu.max_points_per_scan
    assert all(len(pts) > n_slots for _, pts, _ in scans)
    loc = Localizer(_cfg(Config, chunk=chunk), device="cpu")
    got = _replay(loc, oversize)
    assert len(got) == len(jax_oversize_packs) == len(scans)
    for (s1, i1), (s2, i2) in zip(got, jax_oversize_packs):
        assert s1.dtype == s2.dtype == np.int16
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(i1, i2)
    assert loc.telemetry.spans.downsample_scans == len(scans)


def test_chunked_replay_matches_single(runs):
    (l1, _), (l4, _) = runs[1], runs[4]
    t1, t4 = l1.trajectory, l4.trajectory
    assert len(t1) == len(t4) == N_SCANS
    for a, b in zip(t1, t4):
        assert a["stamp"] == b["stamp"] and a["n_pc2match"] == b["n_pc2match"]
        np.testing.assert_array_equal(a["pos"], b["pos"])
        np.testing.assert_array_equal(a["quat"], b["quat"])
    s1, s4 = interop.lio_state_to_numpy(l1.state), interop.lio_state_to_numpy(l4.state)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s4[k], err_msg=k)
    assert l4.last_output_scans == N_SCANS % 4 and l4.last_output.pos.shape == (4, 3)
    assert l1.last_output_scans == 1


def test_on_dispatch_fires_once_per_scan_on_both_paths(runs):
    p1, p4 = runs[1][1], runs[4][1]
    assert len(p1) == len(p4) == N_SCANS
    for (s1, i1), (s4, i4) in zip(p1, p4):
        np.testing.assert_array_equal(s1, s4)
        np.testing.assert_array_equal(i1, i4)


def test_quantized_localizer_tracks(runs, stream):
    loc = runs[1][0]
    ate = synthetic.ate_rmse(loc.positions(), stream[0].traj.pos(loc.stamps()))
    assert ate < 0.08, ate


def test_chunked_localizer_keeps_the_state_surface(runs, tmp_path):
    """State queries and checkpoints work on the chunked path: a C = 4
    checkpoint resumes in a C = 1 Localizer with the same state."""
    l4 = runs[4][0]
    ws = l4.get_world_state()
    assert np.isfinite(ws["pos"]).all() and l4.get_pose_covariance().shape == (6, 6)
    path = os.path.join(tmp_path, "c4.npz")
    l4.save_checkpoint(path)
    again = Localizer(_cfg(Config), device="cpu")
    again.load_checkpoint(path)
    assert torch.equal(again.state.map.table, l4.state.map.table)
    assert torch.equal(again.state.P, l4.state.P) and again.epoch == l4.epoch


def test_board_renders(runs):
    text = runs[1][0].board()
    assert "fast_limo_tpu_torch" in text and "Map points" in text and "scans/s" in text


def test_native_pack_matches_numpy_twin():
    rng = np.random.default_rng(3)
    n, cap = 1000, 1200
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    traw = rng.uniform(0, 0.1, n).astype(np.float32)
    out, t_scale, n_packed = native.pack_scan_i16(pts, traw, cap, QUANT)
    assert n_packed == n
    np.testing.assert_allclose(t_scale, max(float(np.abs(traw).max()), 1e-12) / 32767.0,
                               rtol=1e-6)
    want, want_ts, want_n = native.pack_scan_i16_numpy(pts, traw, cap, QUANT)
    assert (want_n, want_ts) == (n, t_scale)
    np.testing.assert_array_equal(out, want)


def test_native_pack_twin_rounds_ties_as_the_c_packer():
    """Points on a millimetre grid land exactly on rounding ties at the
    4 mm LSB; the twin takes the LSB as the float32 the C function gets,
    so it rounds them as both packages' C packers do."""
    from fast_limo_tpu.io import native as jnative

    pts = np.array([[42.854, -13.952181, 1.4046282], [-6.416208, 14.246, 0.44089326]],
                   np.float32)
    traw = np.array([0.09330925, 0.03925524], np.float32)
    twin = native.pack_scan_i16_numpy(pts, traw, 4, QUANT)[0]
    assert twin[0, 0] == 10713 and twin[1, 1] == 3561
    for packer in (native.pack_scan_i16, jnative.pack_scan_i16):
        np.testing.assert_array_equal(packer(pts, traw, 4, QUANT)[0], twin)


def test_native_pack_clips_and_pads():
    pts = np.array([[1e6, -1e6, 0.0]], np.float32)
    traw = np.array([0.05], np.float32)
    for out, _ts, n in (native.pack_scan_i16(pts, traw, 4, QUANT),
                        native.pack_scan_i16_numpy(pts, traw, 4, QUANT)):
        assert n == 1 and out[0, 0] == 32767 and out[0, 1] == -32767
        np.testing.assert_array_equal(out[1:], 0)


def test_ring_is_fifo_and_rejects_when_full():
    ring = native.SPSCRing(4, 16)
    for i in range(4):
        assert ring.push(struct.pack("<2d", float(i), float(10 * i)))
    assert not ring.push(struct.pack("<2d", 9.0, 9.0)) and len(ring) == 4
    assert [struct.unpack("<2d", ring.pop())[0] for _ in range(4)] == [0.0, 1.0, 2.0, 3.0]
    assert ring.pop() is None
    with pytest.raises(ValueError):
        ring.push(b"short")


def test_async_ingest_matches_synchronous(runs, stream):
    """Two producer threads (IMU, scans) through AsyncIngest give the
    synchronous replay's trajectory bit for bit."""
    _, stamps, acc, gyro, scans = stream
    loc = Localizer(_cfg(Config), device="cpu")
    with AsyncIngest(loc) as ingest:
        def imu_producer():
            for k in range(len(stamps)):
                ingest.push_imu(stamps[k], acc[k], gyro[k])
                if k % 50 == 0:
                    time.sleep(0.001)

        def scan_producer():
            for st, pts, traw in scans:
                ingest.push_scan(pts, traw, st)
                time.sleep(0.002)

        threads = [threading.Thread(target=imu_producer), threading.Thread(target=scan_producer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert ingest.imu_dropped == 0 and len(ingest) == 0
    np.testing.assert_array_equal(loc.positions(), runs[1][0].positions())


def test_async_ingest_forwards_gps_only_to_engines_that_take_it():
    class Recorder:
        def __init__(self):
            self.gps = []

        def update_imu(self, *a):
            pass

        def update_pointcloud(self, *a):
            pass

        def update_gps(self, stamp, pos, weight=None):
            self.gps.append((stamp, weight))

    rec = Recorder()
    with AsyncIngest(rec) as ing:
        for k in range(3):
            ing.push_gps(float(k), np.array([k, 0.0, 0.0]), weight=2.0)
    assert rec.gps == [(0.0, 2.0), (1.0, 2.0), (2.0, 2.0)]
    loc = Localizer(_cfg(Config), device="cpu")
    with AsyncIngest(loc) as ing:
        ing.push_gps(0.0, np.zeros(3))               # a Localizer has none: dropped
    assert len(ing) == 0 and loc.state is None


def test_async_ingest_drops_and_counts_imu_overrun():
    """An IMU record that finds the ring full is dropped and counted; the
    records already in the ring still reach the engine in order."""
    entered, gate = threading.Event(), threading.Event()

    class Stalled:
        def __init__(self):
            self.stamps = []

        def update_imu(self, stamp, acc, gyro):
            entered.set()
            gate.wait(timeout=30)
            self.stamps.append(stamp)

        def update_pointcloud(self, *a):
            pass

    eng = Stalled()
    ingest = AsyncIngest(eng, imu_capacity=4)
    ingest.push_imu(0.0, np.zeros(3), np.zeros(3))
    assert entered.wait(timeout=30)          # the consumer holds record 0
    for k in range(1, 8):                    # 4 fit, 3 find the ring full
        ingest.push_imu(float(k), np.zeros(3), np.zeros(3))
    assert ingest.imu_dropped == 3 and len(ingest) == 4
    gate.set()
    ingest.close()
    assert eng.stamps == [0.0, 1.0, 2.0, 3.0, 4.0]
