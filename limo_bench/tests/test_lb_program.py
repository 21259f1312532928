"""The readers of the program's own spans and counters (``lbcore/program.py``
and their ``metrics/*.py``) on a made-up export and trace, and the
by-stage run (``stages.py``) on the CPU at a tiny size."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from lbcore import program
from lbcore.drive import Dispatch, Window
from lbcore.tracing import TraceView

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
NEW = ["predict_host_ms.live", "update_host_ms.live", "insert_host_ms.live",
       "host_driver_ms.live", "predict_launches_per_scan.live",
       "update_launches_per_scan.live", "insert_launches_per_scan.live",
       "cuda_mallocs_per_scan.live"]

# ms from a dispatch's start: (name, start, end, parent's position in this list)
LAYOUT = [("localizer.arrive", 2.0, 3.0, -1), ("localizer.dispatch", 3.0, 22.0, -1),
          ("localizer.pack", 3.0, 4.0, 1), ("step", 4.0, 21.0, 1),
          ("step.predict", 4.5, 7.5, 3), ("step.preprocess", 7.5, 8.0, 3),
          ("step.deskew", 8.0, 8.5, 3), ("step.voxel", 8.5, 9.0, 3),
          ("step.update", 9.0, 15.0, 3), ("step.insert", 19.0, 20.5, 3),
          ("localizer.finish", 21.0, 22.0, 1)]
UPDATE_END = {1: 17.0, 2: 17.0, 4: 10.0, 5: 10.0}    # 8 ms in 1 and 2, 1 ms in the slice


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _spans(k):
    """Dispatch k's spans (times in ms from its start at k × 100 ms)."""
    out = []
    for name, a, b, p in LAYOUT:
        if name == "step.update":
            b = UPDATE_END.get(k, b)
        out.append((name, a, b, p))
    return out


def made_up():
    """Six scans due every 100 ms, one a dispatch, each call [2, 22] ms
    after it is due; the profiled slice [0.4, 0.6] s holds dispatches 4 and
    5.  The export holds every dispatch's spans (``LAYOUT``), pose_ready
    0.5 ms after its step ends, 4 device allocations in dispatch 0; the
    update takes 6 ms, 8 in dispatches 1 and 2, 1 in the slice's.  In the
    slice each dispatch has the spans as ``record_function`` ranges, 3
    launches in ``step.predict``, 5 in ``step.update``, 2 in
    ``step.insert``, 1 in ``localizer.pack`` and 1 outside the spans, 2
    ``cudaMalloc`` calls in ``step.update`` and 9 ms of device work inside
    the call, from the middle of the predict to the insert."""
    w = Window(t0=0.0, t1=0.6, scans=list(range(6)), due={i: 0.1 * i for i in range(6)})
    ds = [Dispatch(k, [k], 0.1 * k + 0.002, 0.1 * k + 0.022, 0.1 * k + 0.030) for k in range(6)]
    spans, disp = [], []
    for k in range(6):
        base = len(spans)
        for name, a, b, p in _spans(k):
            ns = lambda ms: int(round((100.0 * k + ms) * 1e6))  # noqa: E731
            spans.append({"name": name, "t0": ns(a), "t1": ns(b),
                          "parent": -1 if p < 0 else base + p, "ordinal": k,
                          "stamp": 0.1 * k, "dev0": None, "dev1": None})
        step = spans[base + 3]
        disp.append({"ordinal": k, "stamp": 0.1 * k, "arrive": spans[base]["t0"],
                     "pose_ready": step["t1"] + 500_000, "device_allocs": 4 if k == 0 else 0})
    ex = {"spans": spans, "dispatches": disp, "dropped": 0, "capacity": 1 << 16,
          "anchor": {"ns": 0, "error_ns": 1000, "over_ns": 51_000_000_000, "drift_ns": 20_000},
          "counters": {"evictions": 0}}
    cpu, dev = [], []
    for k in (4, 5):
        t = lambda ms: 0.1 * k + 1e-3 * ms  # noqa: E731
        lay = {name: (t(a), t(b)) for name, a, b, _ in _spans(k)}
        cpu += [(s, e, n) for n, (s, e) in lay.items()]
        for name, n in (("step.predict", 3), ("step.update", 5), ("step.insert", 2),
                        ("localizer.pack", 1)):
            s, e = lay[name]
            cpu += [(s + (i + 1) * (e - s) / (n + 2), s + (i + 1) * (e - s) / (n + 2) + 1e-6,
                     "cudaLaunchKernel") for i in range(n)]
        cpu.append((t(1.0), t(1.0) + 1e-6, "cudaLaunchKernel"))
        s = lay["step.update"][0]
        cpu += [(s + 1e-4, s + 2e-4, "cudaMalloc"), (s + 3e-4, s + 4e-4, "cudaMalloc")]
        dev.append((t(9.5), t(18.5), "kernel"))
    cpu.sort()
    tv = TraceView(0.4, 0.6, sorted(dev), cpu, sum(n == "cudaLaunchKernel" for *_, n in cpu))
    return SimpleNamespace(window=w, dispatches=ds, trace=tv, program=ex, open_loop=True)


def test_host_ms_take_the_self_time_before_the_slice():
    r = made_up()
    assert reader("predict_host_ms.live")(r) == pytest.approx(3.0)
    assert reader("update_host_ms.live")(r) == pytest.approx(7.0)     # 6, 8, 8, 6
    assert reader("insert_host_ms.live")(r) == pytest.approx(1.5)
    # arrive 1 + pack 1 + finish 1 + the dispatch's own 0
    assert reader("host_driver_ms.live")(r) == pytest.approx(3.0)
    own = program.self_ns(r.program["spans"][:11])
    assert own[3] == 5_000_000 and own[1] == 0         # the step's own: 17 less 12


def test_launches_and_mallocs():
    r = made_up()
    assert reader("predict_launches_per_scan.live")(r) == pytest.approx(3.0)
    assert reader("update_launches_per_scan.live")(r) == pytest.approx(5.0)
    assert reader("insert_launches_per_scan.live")(r) == pytest.approx(2.0)
    by = program.calls_by_span(r.trace, "cudaLaunch")
    assert by == {"step.predict": 6, "step.update": 10, "step.insert": 4,
                  "localizer.pack": 2, None: 2}
    assert sum(by.values()) == r.trace.launches
    assert program.calls_by_span(r.trace, "cudaMalloc") == {"step.update": 4}
    assert reader("cuda_mallocs_per_scan.live")(r) == pytest.approx(4 / 6)


def test_nothing_to_read_gives_none():
    r = made_up()
    r.program = None
    for name in NEW[:4] + NEW[7:]:
        assert reader(name)(r) is None
    del r.program                       # a context from run.py holds no export
    assert reader("host_driver_ms.live")(r) is None
    r.trace.cpu = [ev for ev in r.trace.cpu if not program.is_program(ev[2])]
    for name in NEW[4:7]:
        assert reader(name)(r) is None
    r.trace = None
    assert reader("predict_launches_per_scan.live")(r) is None


def test_idle_tail_and_lines():
    r = made_up()
    idle = program.idle_by_span(r.trace, [(0.1 * k + 0.002, 0.1 * k + 0.022) for k in (4, 5)])
    # before the kernel the host is in the predict span at the gap's midpoint, after it in insert
    assert idle == {"step.predict": pytest.approx(15e-3), "step.insert": pytest.approx(7e-3)}
    assert program.device_tail_ms(r) == pytest.approx([0.5] * 4)
    assert program.pose_latency_ms(r) == pytest.approx([19.5] * 4)
    # arrive 1 ms + dispatch 19 ms of the 20 ms call
    assert program.coverage(r) == pytest.approx([1.0] * 4)
    text = "\n".join(program.lines(r))
    assert "anchor drift 0.0200 ms over 51.0 s" in text and "step.update" in text
    assert program.innermost([(0, 10, "a"), (1, 2, "b"), (3, 4, "c")],
                             [0.5, 1.5, 2.5, 3.5, 11]) == ["a", "b", "a", "c", None]


def test_the_by_stage_run_reads_every_program_metric(tiny_root):
    import stages

    result, lines = stages.run(["--workload", "tiny.live", "--seed", "3000000019",
                                "--seconds", "1", "--trace", "0"], tiny_root, device="cpu")
    assert result["correct"] and result["spans"]
    m = result["metrics"]
    for name in NEW[:4]:
        assert m[name]["value"] > 0, name
    assert "cuda_mallocs_per_scan.live" not in m        # no allocator on the CPU
    assert not any(name in m for name in NEW[4:7])      # no profiled slice
    cover = next(line for line in lines if line.startswith("host driver"))
    assert "the spans cover" in cover
    json.dumps(result)
    off, _ = stages.run(["--workload", "tiny.live", "--seed", "3000000019", "--seconds", "1",
                         "--trace", "0", "--spans", "0"], tiny_root, device="cpu")
    assert not any(name in off["metrics"] for name in NEW)


class _Ev:
    """A profiler event's stand-in (the accessors ``stages.py`` reads)."""

    def __init__(self, name, start, end, cuda=False, corr=0, linked=0, ann=False):
        import torch

        self._n, self._s, self._e, self._c, self._l, self._a = name, start, end, corr, linked, ann
        self._d = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return self._a


def test_device_ops_go_to_the_span_that_launched_them():
    import stages

    ev = [_Ev("step.update", 100, 200, ann=True), _Ev("step.insert", 200, 300, ann=True),
          _Ev("aten::mul", 110, 120, corr=7), _Ev("cudaLaunchKernel", 112, 114, corr=900),
          _Ev("cudaLaunchKernel", 210, 212, corr=901),          # K6 through ctypes: no aten op
          _Ev("mul_kernel", 400, 430, cuda=True, corr=900, linked=7),
          _Ev("fl_update_loop", 500, 600, cuda=True, corr=901),
          _Ev("add_kernel", 700, 705, cuda=True, corr=999, linked=7),     # via its op only
          _Ev("step.update", 400, 430, cuda=True, ann=True)]             # a range's shadow
    tracer = SimpleNamespace(offset_ns=0, prof=SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: ev))))
    got = stages.device_ops_by_span(tracer)
    assert got["step.update"][0] == pytest.approx(35e-9)
    assert got["step.update"][1] == [("mul_kernel", pytest.approx(30e-9)),
                                     ("add_kernel", pytest.approx(5e-9))]
    assert got["step.insert"] == (pytest.approx(100e-9), [("fl_update_loop", pytest.approx(1e-7))])
    assert stages.annotations(tracer) == (1, 1)
