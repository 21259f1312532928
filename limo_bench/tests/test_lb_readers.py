"""Each per-layer metric reader's arithmetic, on a made-up run and trace."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from lbcore.drive import Dispatch, Window
from lbcore.tracing import TraceView, length, overlap, union
from roofline import counts

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cfg(n_match=10_000, k=5, slots=32768, insert=10000):
    return SimpleNamespace(
        ikfom=SimpleNamespace(mapping=SimpleNamespace(MAX_NUM_PC2MATCH=n_match,
                                                      NUM_MATCH_POINTS=k)),
        tpu=SimpleNamespace(max_points_per_scan=slots, max_insert_points=insert))


def run_10hz():
    """Four scans due every 100 ms from t = 0, each dispatched 2 ms after it
    is due in a 20 ms call, its pose on the host 30 ms after it was due; the
    profiled slice is [0.1, 0.3] s and holds scans 1 and 2, each with 5 ms of
    device work: a 1 ms K6 launch, two 0.5 ms K9 launches and a 3 ms kernel;
    46 cudaLaunch* calls."""
    w = Window(t0=0.0, t1=0.4, scans=[0, 1, 2, 3], due={i: 0.1 * i for i in range(4)})
    ds = [Dispatch(i, [i], 0.1 * i + 0.002, 0.1 * i + 0.022, 0.1 * i + 0.030)
          for i in range(4)]
    dev = []
    for i in (1, 2):
        t = 0.1 * i + 0.005
        dev += [(t, t + 1e-3, "fl_update_loop_kernel"), (t + 2e-3, t + 2.5e-3, "fl_sort3_grid_kernel"),
                (t + 3e-3, t + 3.5e-3, "fl_sort3_grid_kernel"), (t + 4e-3, t + 7e-3, "other")]
    cpu = [(0.1 * i + 0.002, 0.1 * i + 0.022, "limo_bench.update_pointcloud") for i in (1, 2)]
    cpu += [(0.11, 0.11 + 1e-6, "cudaLaunchKernel")] * 46
    tv = TraceView(0.1, 0.3, sorted(dev), sorted(cpu), 46)
    return SimpleNamespace(window=w, dispatches=ds, trace=tv, cfg=_cfg(), fallbacks=1,
                           latencies_ms=[30.0] * 4)


def test_end_to_end_readers():
    r = run_10hz()
    r.latencies_ms = [float(v) for v in range(1, 101)]
    assert reader("scan_latency_p95_ms")(r) == pytest.approx(95.05)
    assert reader("scan_latency_p50_ms")(r) == pytest.approx(50.5)
    r.latencies_ms[-1] = float("inf")           # a failed scan is late without end
    assert reader("scan_latency_p95_ms")(r) == pytest.approx(95.05)
    assert reader("scan_latency_p50_ms")(r) == pytest.approx(50.5)
    r.window = Window(t0=1.0, t1=3.0, scans=list(range(50)))
    assert reader("replay_scans_per_s")(r) == pytest.approx(25.0)


def test_enqueue_leaves_the_traced_scans_out():
    r = run_10hz()
    assert reader("host_enqueue_ms.live")(r) == pytest.approx(20.0)
    r.dispatches = [Dispatch(0, [0, 1, 2, 3], 0.0, 0.008)]
    r.trace = None
    assert reader("host_enqueue_ms.replay")(r) == pytest.approx(2.0)


def test_launches_and_fallbacks():
    r = run_10hz()
    assert reader("launches_per_scan.live")(r) == pytest.approx(23.0)
    assert reader("loop_fallback_share.live")(r) == pytest.approx(0.25)


def test_rooflines():
    r = run_10hz()
    k6 = counts.bound_ms(*counts.k6(10_000, 5))[0]
    assert reader("k6_roofline")(r) == pytest.approx(100 * k6 / 1.0)
    k9 = counts.bound_ms(*counts.k9(32768))[0] + counts.bound_ms(*counts.k9(10000))[0]
    assert reader("k9_roofline")(r) == pytest.approx(100 * 2 * k9 / 2.0)
    # a sort the profiler missed: the others still give a share
    first = next(i for i, d in enumerate(r.trace.device) if d[2].startswith("fl_sort3"))
    r.trace.device = r.trace.device[:first] + r.trace.device[first + 1:]
    assert reader("k9_roofline")(r) == pytest.approx(100 * k9)
    r.trace.device = [d for d in r.trace.device if d[2] == "other"]
    assert reader("k6_roofline")(r) is None and reader("k9_roofline")(r) is None


def test_idle_shares():
    r = run_10hz()
    # in flight inside the slice: [0.1, 0.13] and [0.2, 0.23]: 60 ms, 10 ms busy
    assert reader("device_idle_share.live")(r) == pytest.approx(1 - 10 / 60)
    assert reader("device_idle_share.replay")(r) == pytest.approx(1 - 10 / 200)


def test_cover_arithmetic_and_breakdown():
    cov = union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 0.5, 10)
    assert cov == [(0.5, 3), (5, 6)] and length(cov) == 3.5
    assert overlap(cov, 2, 5.5) == pytest.approx(1.5)
    r = run_10hz()
    b = r.trace.breakdown([(0.1, 0.13), (0.2, 0.23)])
    assert b["device_ops"][0] == ["other", pytest.approx(6e-3)]
    names = dict(b["idle_gaps"])
    assert sum(names.values()) == pytest.approx(50e-3)
    # a gap goes to what the host ran at its midpoint
    assert list(names) == ["limo_bench.update_pointcloud"]
    r.trace.cpu = [ev for ev in r.trace.cpu if ev[2] == "cudaLaunchKernel"]
    r.trace.spans = []
    assert dict(r.trace.breakdown([(0.1, 0.13)])["idle_gaps"]) == {
        "idle host": pytest.approx(25e-3)}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
