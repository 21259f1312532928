"""The span and counter recorder of the port's dispatch path
(``utils/telemetry.Spans``, switched by ``Localizer.telemetry.trace``), on
the CPU at a tiny size.  Where CUDA events would be recorded, a stand-in
device (``fake_cuda``) gives each event the host clock at its record.

- off (the default): no span row, no timing event, no ``record_function``,
  and one non-timing ``pose_ready`` event a dispatch;
- on: the spans nest as the Localizer and the step mark them, each child
  inside its parent, a dispatch's spans sharing its ordinal, a boundary
  event at each end of each stage, a pose event, a device-allocation count
  a dispatch, and an anchor whose drift is exact on the stand-in clock;
- the chunk step gives one set of stage spans an element, stamped with its
  scan's stamp;
- two threads keep separate parent stacks, and sixteen under a 1 µs switch
  interval lose no row;
- ``export()`` is bounded and round-trips through JSON;
- while a profiler session records, the spans enter its trace as
  ``record_function`` ranges, switched on or not, and add no row (the
  Localizer's sites counted under a stand-in session; the ranges' nesting
  in a real one);
- the board's enqueue lines, pose latency (while tracing) and evictions.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.utils import presets, telemetry

STAGES = ["step.predict", "step.preprocess", "step.deskew", "step.voxel", "step.update",
          "step.insert"]
N_SCANS = 3


def _cfg(chunk=1):
    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 256
    cfg.tpu.map_capacity = 1024
    cfg.tpu.imu_batch = 16
    cfg.tpu.max_insert_points = 128
    cfg.tpu.scan_chunk = chunk
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 128
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return presets.bench_sequence(n_scans=N_SCANS, points_per_scan=256)


class _Event:
    """A CUDA event's stand-in: done at once, at the host clock of its
    record."""

    made = []

    def __init__(self, enable_timing=False):
        self.timing, self.t = enable_timing, None
        _Event.made.append(self)

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA's events, streams, sync and allocator counter stood in for;
    returns the list of events made."""
    allocs = [0]

    def stats(device=None):
        allocs[0] += 3
        return {"num_device_alloc": allocs[0]}

    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    return _Event.made


def _replay(loc, seq):
    presets.replay(loc, seq)
    loc.flush()
    return loc


def _traced(seq, chunk=1, cuda=True):
    loc = Localizer(_cfg(chunk), device="cpu")
    if cuda:
        loc.telemetry.spans.device = torch.device("cuda")   # events on the stand-in
    loc.telemetry.trace(True)
    return _replay(loc, seq)


def test_off_makes_no_span_event_or_range(seq, fake_cuda, monkeypatch):
    ranges = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: ranges.append(a) or real(*a, **k))
    loc = Localizer(_cfg(), device="cpu")
    loc.telemetry.spans.device = torch.device("cuda")
    _replay(loc, seq)
    sp = loc.telemetry.spans
    assert not sp.on and not sp.live and sp.rows == [] and sp.dispatches == []
    assert ranges == []
    # the one event a dispatch: pose_ready, without timing
    assert len(fake_cuda) == N_SCANS and not any(e.timing for e in fake_cuda)
    assert loc.pose_ready is fake_cuda[-1] and loc.pose_ready.query()
    assert "Pose latency" not in loc.board()


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


def test_on_spans_nest_and_share_the_ordinal(seq, fake_cuda):
    loc = _traced(seq)
    ex = loc.telemetry.export()
    spans, anchor = ex["spans"], ex["anchor"]
    tol = 2 * anchor["error_ns"]         # an event's host time is known to the anchor's error
    assert ex["dropped"] == 0 and len(ex["dispatches"]) == N_SCANS
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert [spans[i]["name"] for i in roots] == ["localizer.arrive", "localizer.dispatch"] * N_SCANS
    for k in range(N_SCANS):
        arrive, disp = roots[2 * k], roots[2 * k + 1]
        assert spans[arrive]["ordinal"] == spans[disp]["ordinal"] == k
        assert spans[arrive]["t1"] <= spans[disp]["t0"]       # a dispatch is no arrive's child
        kids = _children(spans, disp)
        assert [spans[j]["name"] for j in kids] == ["localizer.pack", "step", "localizer.finish"]
        step = kids[1]
        stages = _children(spans, step)
        assert [spans[j]["name"] for j in stages] == STAGES
        for j in kids + stages:
            s, p = spans[j], spans[spans[j]["parent"]]
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
            assert s["ordinal"] == k and s["stamp"] == spans[disp]["stamp"]
        # one event at each stage boundary: a stage starts at the event its predecessor ended at
        for a, b in zip(stages, stages[1:]):
            assert spans[a]["t1"] == spans[b]["t0"] and spans[a]["dev1"] == spans[b]["dev0"]
        for j in stages:         # a boundary's event is recorded after the host's clock read
            s = spans[j]
            assert s["t0"] - tol <= s["dev0"] <= s["dev1"] <= spans[step]["t1"] + tol
        d = ex["dispatches"][k]
        assert d["ordinal"] == k and d["device_allocs"] == 3
        assert spans[step]["t1"] - tol <= d["pose_ready"] <= spans[disp]["t1"] + tol
        assert d["arrive"] <= spans[arrive]["t0"]
    # seven boundary events a scan, a pose event, and the two anchors
    assert sum(e.timing for e in fake_cuda) == N_SCANS * 8 + 2
    assert abs(anchor["drift_ns"]) <= tol and anchor["over_ns"] > 0
    assert ex["counters"]["evictions"] == 0 and ex["counters"]["loop_fallbacks"] >= 0


def test_chunk_step_marks_each_element(seq):
    loc = _traced(seq, chunk=2, cuda=False)
    spans = loc.telemetry.export()["spans"]
    stamps = [seq.scan(i)[0] for i in range(N_SCANS)]
    steps = [i for i, s in enumerate(spans) if s["name"] == "step"]
    assert len(steps) == 2          # a full chunk of two, then flush()'s partial one
    # each element's stages carry its scan's stamp; flush()'s padding keeps the last one's
    for first, step in ((0, steps[0]), (2, steps[1])):
        stages = _children(spans, step)
        assert [spans[j]["name"] for j in stages] == STAGES * 2
        want = [stamps[min(first + e, N_SCANS - 1)] for e in range(2) for _ in STAGES]
        assert [spans[j]["stamp"] for j in stages] == want
    arrives = [s["ordinal"] for s in spans if s["name"] == "localizer.arrive"]
    assert arrives == [0, 0, 1]


def test_threads_keep_their_own_parent_stacks():
    sp = telemetry.Spans()
    sp.start()
    go = threading.Barrier(2)

    def work(k):
        sp.root("localizer.dispatch", k, float(k))
        go.wait()
        sp.open("step")
        go.wait()
        for name in STAGES[:2]:
            sp.stage(name)
            go.wait()
        sp.close()
        sp.close()

    ts = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rows = sp.export()["spans"]
    assert len(rows) == 8
    for r in rows:
        if r["name"] == "localizer.dispatch":
            assert r["parent"] == -1
            continue
        p = rows[r["parent"]]
        assert p["ordinal"] == r["ordinal"]
        assert p["name"] == ("localizer.dispatch" if r["name"] == "step" else "step")
        assert p["t0"] <= r["t0"] <= r["t1"] <= p["t1"]


def test_many_threads_under_a_short_switch_interval():
    """More threads than cores, switching every microsecond: every row keeps
    its parent (a lost update of the shared buffer would misplace one)."""
    import sys

    sp = telemetry.Spans()
    sp.start()
    n_threads, n_disp = 16, 20

    def work(k):
        for j in range(n_disp):
            sp.root("localizer.dispatch", k * n_disp + j, float(k))
            sp.open("step")
            for name in STAGES:
                sp.stage(name)
            sp.close()
            sp.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    rows = sp.export()["spans"]
    assert len(rows) == n_threads * n_disp * (2 + len(STAGES))
    for r in rows:
        if r["parent"] >= 0:
            p = rows[r["parent"]]
            assert p["ordinal"] == r["ordinal"] and p["t0"] <= r["t0"] <= r["t1"] <= p["t1"]
            assert p["name"] == ("localizer.dispatch" if r["name"] == "step" else "step")


def test_export_is_bounded_and_round_trips(seq):
    loc = Localizer(_cfg(), device="cpu")
    loc.telemetry.spans.capacity = 10
    loc.telemetry.trace(True)
    _replay(loc, seq)
    ex = loc.telemetry.export()
    assert len(ex["spans"]) == 10 and ex["dropped"] == N_SCANS * 11 - 10
    assert all(s["t1"] is not None for s in ex["spans"])
    assert json.loads(json.dumps(ex)) == ex
    loc.telemetry.trace(False)
    assert not loc.telemetry.spans.on
    loc.telemetry.trace(True)           # a new recording starts empty
    assert loc.telemetry.export()["spans"] == []


def test_while_profiled_the_spans_are_ranges(seq, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    monkeypatch.setattr(telemetry, "_profiling", lambda: True)
    loc = _replay(Localizer(_cfg(), device="cpu"), seq)
    assert loc.telemetry.spans.rows == []          # off: ranges only, no rows
    for name in ["localizer.arrive", "localizer.dispatch", "localizer.pack", "step",
                 "localizer.finish"] + STAGES:
        assert opened.count(name) == N_SCANS, name
    assert len(opened) == 11 * N_SCANS


def test_a_profiler_session_records_the_ranges():
    sp = telemetry.Spans()
    x = torch.ones(4)
    assert not sp.root("localizer.dispatch", 0, 0.0)       # no session: off
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        assert sp.root("localizer.dispatch", 0, 0.0)
        sp.open("step")
        sp.stage("step.predict")
        x = x + 1
        sp.close()
        sp.close()
    ev = {e.name: e for e in prof.function_events}
    assert {"localizer.dispatch", "step", "step.predict", "aten::add"} <= set(ev)
    outer, inner = ev["step"].time_range, ev["step.predict"].time_range
    assert outer.start <= inner.start <= ev["aten::add"].time_range.start <= inner.end <= outer.end
    assert sp.rows == [] and not sp.root("localizer.dispatch", 1, 0.1)


def test_board_names_the_enqueue_and_shows_pose_latency(seq):
    loc = _traced(seq, cuda=False)
    loc.telemetry.spans.evictions = 2
    text = loc.board()
    assert "Enqueue" in text and "scans/s" in text and "Computation" not in text
    assert "Pose latency" in text and "Evictions   :: 2" in text
    s = loc.telemetry.stats()
    assert len(loc.telemetry.pose_ms.buf) == N_SCANS and s["pose_ms"] > 0
    assert s["enqueue_ms_mean"] > 0 and np.isfinite(s["enqueue_scans_per_s"])
