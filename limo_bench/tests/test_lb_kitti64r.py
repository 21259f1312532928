"""The configuration ``kitti64r`` (KITTI's HDL-64E at its published sweep,
120 000 returns on 64 rings into 32 768 slots), its cell ``kitti64r.live``
and the reader ``downsample_host_ms.live``; and, at a tiny oversize ring
configuration on the CPU, that the output check sees the host's
stride-downsample."""

import copy
import json
import os
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, ROOT
from lbcore import main as lb
from lbcore import spec
from lbcore.drive import Dispatch
from lbcore.tracing import TraceView

ARGS = ["--seed", "2147483659", "--seconds", "2"]
READER = "downsample_host_ms.live"
LIVE = ["host_enqueue_ms.live", "launches_per_scan.live", "loop_fallback_share.live",
        "k6_roofline", "k9_roofline", "device_idle_share.live",
        "predict_launches_per_scan.live", "update_launches_per_scan.live",
        "insert_launches_per_scan.live", READER]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_config_block_is_the_programs_kitti_preset():
    from fast_limo_tpu_torch.utils import presets

    cell = spec.load(ROOT, "kitti64r.live")
    assert spec.program_config(cell).to_dict() == presets.kitti_like_cfg().to_dict()
    s = cell.config["sensor"]
    assert (s["points_per_scan"], s["ring_beams"]) == (120000, 64)
    assert s["points_per_scan"] > cell.config["config"]["tpu"]["max_points_per_scan"]
    assert cell.config["reduced"] == []


def test_the_cell_lists_its_metrics():
    cell = spec.load(ROOT, "kitti64r.live")
    assert [m.name for m in cell.end_to_end] == ["scan_latency_p95_ms", "scan_latency_p50_ms",
                                                 "setup_s"]
    assert sorted(m.name for m in cell.per_layer) == sorted(LIVE)
    with open(os.path.join(BENCH, "traffic", "live.json")) as f:
        assert cell.traffic == json.load(f)


def _run(cpu, dispatches):
    tv = TraceView(10.0, 11.0, [], cpu, 0)
    return SimpleNamespace(trace=tv, dispatches=dispatches)


def test_the_reader_without_a_trace_or_a_span_reads_none():
    read = spec._reader(ROOT, READER)
    assert read(SimpleNamespace(trace=None, dispatches=[])) is None
    ds = [Dispatch(k, [k], 10.1 + 0.1 * k, 10.15 + 0.1 * k) for k in range(3)]
    cpu = [(10.11, 10.12, "localizer.arrive"), (10.111, 10.112, "cudaLaunchKernel")]
    assert read(_run(cpu, ds)) is None


def test_the_reader_sums_the_spans_of_the_slices_scans():
    read = spec._reader(ROOT, READER)
    ds = [Dispatch(k, [k], 10.1 + 0.1 * k, 10.15 + 0.1 * k) for k in range(4)]
    ds.append(Dispatch(4, [4], 10.95, 11.05))          # leaves the slice: not counted
    cpu = []
    for d in ds:
        cpu += [(d.t_call0 + 0.001, d.t_call0 + 0.02, "localizer.arrive"),
                (d.t_call0 + 0.002, d.t_call0 + 0.004, "localizer.downsample")]
    cpu.append((10.05, 10.09, "localizer.downsample"))   # outside every dispatching call
    assert read(_run(sorted(cpu), ds)) == pytest.approx(2.0)


def _oversize_root(path):
    """A test root with the cell 'tinyr.live': the tiny configuration of
    ``conftest.make_root`` (2 048 slots) fed ring sweeps of 5 000 returns on
    16 rings over the HDL-64E's field of view, limits of ``kitti64r.live``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "kitti64r.json")) as f:
        conf = json.load(f)
    tiny = copy.deepcopy(conf)
    tiny["config"]["tpu"].update(max_points_per_scan=2048, map_capacity=4096,
                                 max_insert_points=1024)
    tiny["config"]["ikfom"]["mapping"].update(MAX_NUM_PC2MATCH=512, MAX_NUM_MATCHES=256)
    tiny["sensor"].update(points_per_scan=5000, ring_beams=16, world_density=1.0)
    for d in ("configs", "limits"):
        os.makedirs(os.path.join(path, "limo_bench", d), exist_ok=True)
    with open(os.path.join(path, "limo_bench", "configs", "tinyr.json"), "w") as f:
        json.dump(tiny, f)
    with open(os.path.join(BENCH, "limits", "kitti64r.live.json")) as f:
        lim = json.load(f)
    with open(os.path.join(path, "limo_bench", "limits", "tinyr.live.json"), "w") as f:
        json.dump(lim, f)
    bench["configs"].append({"name": "tinyr", "source": "test", "reduced": [], "why": "test",
                             "file": "limo_bench/configs/tinyr.json"})
    bench["workloads"].append({"name": "tinyr.live", "config": "tinyr", "traffic": "live",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kitti64r.live" in m.get("workloads", ()):
            m["workloads"].append("tinyr.live")
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture(scope="module")
def oversize_root(tmp_path_factory):
    return _oversize_root(tmp_path_factory.mktemp("bench_r"))


def _first_n(monkeypatch):
    """A fault in the program's host path: the first N returns of an
    oversize sweep go into the slots in place of the stride's."""
    from fast_limo_tpu_torch.models.localizer import Localizer

    pack = Localizer._pack_points

    def first_n(self, scan):
        N = self.cfg.tpu.max_points_per_scan
        if len(scan.points) > N:
            scan.points, scan.t_raw = scan.points[:N], scan.t_raw[:N]
        return pack(self, scan)

    monkeypatch.setattr(Localizer, "_pack_points", first_n)


@pytest.mark.parametrize("fault", [None, "first-n"], ids=["sound", "first-n-returns"])
def test_the_check_sees_the_downsample(oversize_root, monkeypatch, fault):
    cell = spec.load(oversize_root, "tinyr.live")
    _, _, sweeps, _ = lb.generate(cell, int(ARGS[1]), float(ARGS[3]), "cpu")
    assert all(len(t) == 5000 for _, _, t in sweeps)
    if fault:
        _first_n(monkeypatch)
    result, lines = lb.run(["--workload", "tinyr.live"] + ARGS, oversize_root, device="cpu")
    assert result["correct"] == (fault is None), lines
