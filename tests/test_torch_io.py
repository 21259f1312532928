"""The port's data readers against the JAX package: the native KITTI parser
and filter chain (and their NumPy twins), the KITTI raw reader, the generic
sequence layout and its synthetic export, the sensor time conventions and
the packet slicer.  Everything here is host code (numpy and the g++-built
host library), so the two packages must agree exactly:

- ``parse_kitti_bin`` / ``preprocess`` equal the JAX package's on the same
  files and arrays, the C path against the JAX C path and each NumPy twin
  against the JAX fallback (twins of tests/test_native.py:20-75);
- ``KittiDrive`` reads the fixture of tests/test_kitti.py as JAX's does;
- ``export_synthetic`` writes the same files as JAX's for the same seed, in
  all four sensor conventions, end-of-sweep, standstill and GPS;
- ``to_sensor_time`` round-trips through the port's
  ``preprocess.extract_point_times`` (tests/test_generic_io.py:25,45);
- ``PacketSlicer.packets`` equals JAX's (tests/test_packets.py:54).
"""

import os

import numpy as np
import pytest

from fast_limo_tpu.io import generic as jgeneric
from fast_limo_tpu.io import kitti as jkitti
from fast_limo_tpu.io import native as jnative
from fast_limo_tpu.io import synthetic as jsyn
from fast_limo_tpu.io.packets import PacketSlicer as JPacketSlicer
from fast_limo_tpu_torch.io import generic, kitti, native, synthetic
from fast_limo_tpu_torch.io.packets import PacketSlicer
from fast_limo_tpu_torch.models import preprocess

from test_kitti import make_drive

FILTERS = dict(crop_active=True, crop_min=(-1, -1, -1), crop_max=(1, 1, 1),
               dist_active=True, min_dist=2.0)


@pytest.fixture
def jax_fallback(monkeypatch):
    """The JAX package's host functions with their NumPy fallbacks."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    return jnative


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the port's host library did not build (g++)"
    return lib


# ------------------------------------------------------------ KITTI parser

@pytest.mark.parametrize("parse", ["native", "numpy"])
def test_parse_and_azimuth_times(tmp_path, lib, parse):
    pts = np.array([
        [-10, -0.001, 0, 0.5],  # rear (start of sweep) → t≈0
        [0, -10, 0, 0.5],       # right … quarter sweep (CCW convention)
        [10, 0.0, 0, 0.5],      # front → half sweep
        [0, 10, 0, 0.5],        # left → three-quarter
    ], np.float32)
    p = tmp_path / "scan.bin"
    pts.tofile(p)
    fn = native.parse_kitti_bin if parse == "native" else native.parse_kitti_bin_numpy
    xyz, inten, t = fn(str(p))
    assert len(xyz) == 4
    np.testing.assert_allclose(inten, 0.5)
    np.testing.assert_allclose(t, [0.0, 0.025, 0.05, 0.075], atol=1e-3)


def test_parse_matches_jax(tmp_path, lib, jax_fallback):
    pts = np.random.default_rng(0).normal(size=(5000, 4)).astype(np.float32)
    p = str(tmp_path / "s.bin")
    pts.tofile(p)
    got = native.parse_kitti_bin(p, max_points=4000, sweep_period=0.1)
    np.testing.assert_array_equal(got[0], pts[:4000, :3])
    np.testing.assert_array_equal(got[1], pts[:4000, 3])
    twin = native.parse_kitti_bin_numpy(p, max_points=4000)
    _equal(twin, jax_fallback.parse_kitti_bin(p, max_points=4000))
    # the C path's float64 azimuth against the twin's float32 one
    np.testing.assert_allclose(twin[2], got[2], atol=1e-7)
    with pytest.raises(FileNotFoundError):
        native.parse_kitti_bin(str(tmp_path / "missing.bin"))


def test_parse_native_matches_jax_native(tmp_path, lib):
    assert jnative.get_lib() is not None
    pts = np.random.default_rng(1).normal(scale=20, size=(3000, 4)).astype(np.float32)
    p = str(tmp_path / "s.bin")
    pts.tofile(p)
    _equal(native.parse_kitti_bin(p), jnative.parse_kitti_bin(p))


# ------------------------------------------------------------ filter chain

@pytest.mark.parametrize("kw", [
    FILTERS,
    dict(FILTERS, fov_active=True, fov_angle=1.2, rate_active=True, rate_value=3),
    {},
], ids=["crop-dist", "crop-dist-fov-rate", "none"])
def test_preprocess_matches_jax(lib, jax_fallback, kw):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
    xyz[5] = np.nan
    xyz[10] = [0.2, 0.2, 0.2]     # inside the crop box
    t = rng.uniform(0, 0.1, 1000).astype(np.float32)
    got = native.preprocess(xyz, t, 2048, **kw)
    twin = native.preprocess_numpy(xyz, t, 2048, **kw)
    want = jax_fallback.preprocess(xyz, t, 2048, **kw)
    _equal(twin, want)
    _equal(got, want)
    assert np.all(np.diff(got[1][got[2]]) >= 0)


def test_preprocess_native_matches_jax_native(lib):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-30, 30, (4000, 3)).astype(np.float32)
    t = rng.uniform(0, 0.1, 4000).astype(np.float32)
    _equal(native.preprocess(xyz, t, 1024, **FILTERS), jnative.preprocess(xyz, t, 1024, **FILTERS))


def test_preprocess_filters_and_sort(lib, rng):
    n = 1000
    xyz = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    xyz[5] = np.nan
    xyz[10] = [0.2, 0.2, 0.2]
    t = rng.uniform(0, 0.1, n).astype(np.float32)
    _xyz, out_t, valid, kept = native.preprocess(xyz, t, 2048, **FILTERS)
    m = np.all(np.isfinite(xyz), axis=1)
    m &= ~np.all((xyz >= -1) & (xyz <= 1), axis=1)
    m &= np.linalg.norm(xyz, axis=1) > 2.0
    assert kept == int(np.sum(m)) < n
    assert np.all(np.diff(out_t[valid]) >= 0)


@pytest.mark.parametrize("fn", [native.preprocess, native.preprocess_numpy],
                         ids=["native", "numpy"])
def test_preprocess_truncates_to_capacity(lib, rng, fn):
    xyz = rng.uniform(-30, 30, (100, 3)).astype(np.float32)
    t = rng.uniform(0, 0.1, 100).astype(np.float32)
    _xyz, _t, valid, kept = fn(xyz, t, 32)
    assert kept == 100       # reports all that passed the filters
    assert int(valid.sum()) == 32


def test_preprocess_rejects_bad_input(lib):
    with pytest.raises(ValueError):
        native.preprocess(np.zeros((4, 3), np.float32), np.zeros(3, np.float32), 8)
    with pytest.raises(ValueError):
        native.preprocess(np.zeros((4, 3), np.float32), np.zeros(4, np.float32), 8,
                          rate_active=True, rate_value=0)


# ------------------------------------------------------------ KITTI reader

def test_kitti_drive_matches_jax(tmp_path, lib):
    root = make_drive(tmp_path, n_scans=4, n_imu=15)
    d, jd = kitti.KittiDrive(root), jkitti.KittiDrive(root)
    assert len(d) == len(jd) == 4
    np.testing.assert_array_equal(d.scan_stamps, jd.scan_stamps)
    np.testing.assert_array_equal(d.imu_stamps, jd.imu_stamps)
    for i in range(len(d)):
        _equal(d.scan(i)[1:], jd.scan(i)[1:])
        assert d.scan(i)[0] == jd.scan(i)[0]
    for i in range(15):
        _equal(d.imu(i), jd.imu(i))
    assert list(d.stream()) == list(jd.stream())
    stamp, xyz, t_rel = d.scan(0)
    assert xyz.shape[1] == 3 and np.all((t_rel >= 0) & (t_rel <= 0.1))
    _s, acc, gyro = d.imu(5)
    np.testing.assert_allclose(acc, [0.1, 0.0, 9.81])
    np.testing.assert_allclose(gyro, [0.0, 0.0, 0.05])
    # float64 epoch seconds: ~1e-7 resolution at 1.3e9
    assert d.imu_stamps[1] - d.imu_stamps[0] == pytest.approx(0.01, abs=1e-6)


def test_kitti_drive_rejects_unpaired_stamps(tmp_path):
    root = make_drive(tmp_path, n_scans=3, n_imu=4)
    with open(os.path.join(root, "velodyne_points", "timestamps.txt"), "a") as f:
        f.write("2011-09-26 13:02:29.000000000\n")
    with pytest.raises(ValueError):
        kitti.KittiDrive(root)


class _Recorder:
    def __init__(self):
        self.events = []

    def update_imu(self, stamp, acc, gyro):
        self.events.append(("imu", stamp, np.asarray(acc).tolist(), np.asarray(gyro).tolist()))

    def update_pointcloud(self, xyz, t, stamp):
        self.events.append(("scan", stamp, np.asarray(xyz).sum(), np.asarray(t).sum()))

    def update_gps(self, stamp, pos, weight=None):
        self.events.append(("gps", stamp, np.asarray(pos).tolist(), weight))

    def flush(self):
        self.events.append(("flush",))


def test_run_drive_feeds_what_jax_feeds(tmp_path, lib):
    root = make_drive(tmp_path, n_scans=4, n_imu=30)
    got, want = _Recorder(), _Recorder()
    kitti.run_drive(got, kitti.KittiDrive(root), n_scans=3)
    jkitti.run_drive(want, jkitti.KittiDrive(root), n_scans=3)
    assert got.events == want.events
    assert sum(e[0] == "scan" for e in got.events) == 3 and got.events[-1] == ("flush",)


# ------------------------------------------------------- generic sequences

def _synth(mod, n=4, pts=1024):
    return mod.SyntheticSequence(seed=6, n_scans=n, points_per_scan=pts,
                                 noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("sensor,kw", [
    (generic.OUSTER, {}),
    (generic.VELODYNE, {"gps_every": 2, "gps_noise": 0.05}),
    (generic.HESAI, {"standstill": 1.5}),
    (generic.LIVOX, {}),
    (generic.OUSTER, {"end_of_sweep": True}),
], ids=["ouster", "velodyne-gps", "hesai-standstill", "livox", "ouster-end-of-sweep"])
def test_export_synthetic_matches_jax(tmp_path, sensor, kw):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    generic.export_synthetic(a, _synth(synthetic), sensor, n_scans=3, seed=4, **kw)
    jgeneric.export_synthetic(b, _synth(jsyn), sensor, n_scans=3, seed=4, **kw)
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel
    g, jg = generic.GenericSequence(a), jgeneric.GenericSequence(b)
    assert len(g) == len(jg) == 3
    assert list(g.stream()) == list(jg.stream())
    for i in range(3):
        _equal(g.scan(i), jg.scan(i))
    for i in range(len(g.gps_stamps)):
        _equal(g.gps(i)[:2], jg.gps(i)[:2])
    got, want = _Recorder(), _Recorder()
    generic.run_sequence(got, g, start_scan=1, start_time=float(g.scan_stamps[0]))
    jgeneric.run_sequence(want, jg, start_scan=1, start_time=float(jg.scan_stamps[0]))
    assert got.events == want.events


def test_export_read_roundtrip(tmp_path):
    seq = _synth(synthetic, pts=4096)
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, seq, generic.VELODYNE, n_scans=3)
    g = generic.GenericSequence(root)
    assert len(g) == 3
    stamp, xyz, t_raw = g.scan(1)
    s0, p0, t0 = seq.scan(1)
    assert stamp == pytest.approx(s0)
    np.testing.assert_allclose(xyz, p0, atol=1e-6)
    np.testing.assert_allclose(t_raw, t0, atol=1e-6)   # velodyne: native == rel
    times = [{"imu": g.imu_stamps, "scan": g.scan_stamps, "gps": g.gps_stamps}[k][i]
             for k, i in g.stream()]
    assert times == sorted(times)


@pytest.mark.parametrize("end_of_sweep", [False, True])
def test_sensor_time_conventions_roundtrip(end_of_sweep):
    t_rel = np.array([0.0, 0.02, 0.09])
    stamp = 12.3
    for sensor in (generic.OUSTER, generic.VELODYNE, generic.HESAI, generic.LIVOX):
        raw = generic.to_sensor_time(t_rel, stamp, sensor, end_of_sweep)
        want = jgeneric.to_sensor_time(t_rel, stamp, sensor, end_of_sweep)
        assert raw.dtype == want.dtype
        np.testing.assert_array_equal(raw, want)
        t_abs = preprocess.extract_point_times(
            np.asarray(raw, np.float64), stamp, sensor, end_of_sweep)
        np.testing.assert_allclose(np.asarray(t_abs), stamp + t_rel, atol=1e-6)
    with pytest.raises(ValueError):
        generic.to_sensor_time(t_rel, stamp, 7)


def test_generic_sequence_rejects_unpaired_stamps(tmp_path):
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, _synth(synthetic), generic.VELODYNE, n_scans=2)
    os.remove(os.path.join(root, "scans", "000001.npy"))
    with pytest.raises(ValueError):
        generic.GenericSequence(root)


# ------------------------------------------------------------------ packets

@pytest.mark.parametrize("n_packets,end_of_sweep", [(5, False), (3, True), (1, False)])
def test_slicer_matches_jax(n_packets, end_of_sweep):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    traw = rng.uniform(0, 0.1, 1000).astype(np.float32)
    if end_of_sweep:
        traw = -traw
    got = list(PacketSlicer(n_packets, end_of_sweep).packets(pts, traw, 12.5))
    want = list(JPacketSlicer(n_packets, end_of_sweep).packets(pts, traw, 12.5))
    assert len(got) == len(want) == n_packets
    for g, w in zip(got, want):
        _equal(g, w)
    assert sum(len(p[0]) for p in got) == 1000
    # firing order: disjoint time windows, increasing (decreasing for the
    # negative-relative end-of-sweep times)
    sign = -1.0 if end_of_sweep else 1.0
    prev = -np.inf
    for _p, p_traw, st in got:
        assert st == 12.5
        assert (sign * p_traw).min() >= prev - 1e-9
        prev = (sign * p_traw).max()
    with pytest.raises(ValueError):
        PacketSlicer(0)
