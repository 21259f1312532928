"""The span ``localizer.downsample`` and the counters
(``telemetry.spans.downsample_scans`` / ``downsample_points_in``) of the
host's stride-downsample of a sweep larger than the scan slots
(``Localizer._pack_points``), on the CPU at a tiny size: ring sweeps of
5 000 returns on 16 rings into 2 048 slots.  The payloads themselves are
held against the JAX Localizer's in tests/test_torch_transfer.py.

- the span opens once a scan, under ``localizer.arrive`` with one scan a
  dispatch and under ``localizer.pack`` with ``scan_chunk`` 4;
- the counters count the scans cut and their points, recorder on or off,
  and reach ``export()`` and the board;
- a sweep that fits opens no span and moves no counter;
- while a profiler session records, the span enters it as a range with the
  recorder off.
"""

import numpy as np
import pytest
import torch

from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.utils import presets, telemetry

SLOTS = 2048
RETURNS = 5000
N_SCANS = 4


def _cfg(chunk=1):
    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = SLOTS
    cfg.tpu.map_capacity = 4096
    cfg.tpu.imu_batch = 16
    cfg.tpu.max_insert_points = 1024
    cfg.tpu.scan_chunk = chunk
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 512
    cfg.ikfom.mapping.MAX_NUM_MATCHES = 256
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rings():
    """Four sweeps of 5 000 returns on 16 rings (the HDL-64E's field of
    view), azimuth-coupled firing times."""
    seq = synthetic.SyntheticSequence(
        seed=5, n_scans=N_SCANS, points_per_scan=RETURNS, noise_pt=0.01, noise_gyro=5e-4,
        noise_acc=5e-3, traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5),
        ring_beams=16, beam_fov=(-0.4346, 0.0349))
    assert all(len(seq.scan(i)[1]) == RETURNS for i in range(N_SCANS))
    return seq


def _run(seq, chunk, trace=True):
    """Replay ``seq`` through a CPU Localizer; returns it and the scan
    payloads it copied, in dispatch order."""
    loc = Localizer(_cfg(chunk), device="cpu")
    packs = []
    loc.on_dispatch = lambda scan_pack, imu_pack: packs.append(np.array(scan_pack))
    loc.telemetry.trace(trace)
    presets.replay(loc, seq)
    loc.flush()
    return loc, packs


@pytest.fixture(scope="module")
def runs(rings):
    return {chunk: _run(rings, chunk) for chunk in (1, 4)}


@pytest.mark.parametrize("chunk,parent", [(1, "localizer.arrive"), (4, "localizer.pack")])
def test_the_span_opens_once_a_scan_under_the_pack(runs, chunk, parent):
    spans = runs[chunk][0].telemetry.export()["spans"]
    cut = [s for s in spans if s["name"] == "localizer.downsample"]
    assert len(cut) == N_SCANS
    for s in cut:
        p = spans[s["parent"]]
        assert p["name"] == parent and p["ordinal"] == s["ordinal"]
        assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
    assert len({s["stamp"] for s in cut}) == (N_SCANS if chunk == 1 else 1)


@pytest.mark.parametrize("trace", [True, False])
def test_the_counters_count_scans_and_points(rings, runs, trace):
    loc = runs[1][0] if trace else _run(rings, 1, trace=False)[0]
    want = {"scans": N_SCANS, "points_in": N_SCANS * RETURNS}
    assert loc.telemetry.export()["counters"]["downsample"] == want
    assert f"{N_SCANS} sweeps cut, {N_SCANS * RETURNS} points in" in loc.board()
    assert runs[4][0].telemetry.export()["counters"]["downsample"] == want


def test_a_sweep_that_fits_opens_no_span(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    monkeypatch.setattr(telemetry, "_profiling", lambda: True)
    loc, packs = _run(presets.bench_sequence(n_scans=2, points_per_scan=SLOTS), 1)
    assert len(packs) == 2 and opened.count("localizer.arrive") == 2
    assert "localizer.downsample" not in opened
    assert not any(s["name"] == "localizer.downsample"
                   for s in loc.telemetry.export()["spans"])
    assert loc.telemetry.export()["counters"]["downsample"] == {"scans": 0, "points_in": 0}


def test_a_profiler_session_records_the_range_with_the_recorder_off(rings):
    loc = Localizer(_cfg(), device="cpu")
    stamp, pts, t = rings.scan(0)
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        loc.update_pointcloud(pts, t, stamp)       # no IMU yet: the arrival alone
    ev = {e.name: e for e in prof.function_events}
    assert {"localizer.arrive", "localizer.downsample"} <= set(ev)
    outer, inner = ev["localizer.arrive"].time_range, ev["localizer.downsample"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    sp = loc.telemetry.spans
    assert not sp.on and sp.rows == [] and sp.downsample_scans == 1
