"""BENCHMARK.json keeps to the benchmark's contract, every piece it names
is a file of its own, and a new traffic mix and cell need new files only."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, make_root
from lbcore import main as lb
from lbcore import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["limo_bench"] and b["command"] == ["python3", "limo_bench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("limo_bench/")
    cells = {w["name"] for w in b["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load(ROOT, w["name"])
        e2e = [m.name for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert os.path.isfile(os.path.join(BENCH, "limits", f"{w['name']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))


def test_configs_hold_the_programs_values():
    from fast_limo_tpu_torch.utils import presets

    for name, fn in (("kitti64", presets.kitti_like_cfg), ("os128", presets.ouster128_cfg)):
        cell = next(w["name"] for w in _bench()["workloads"] if w["config"] == name)
        cfg = spec.program_config(spec.load(ROOT, cell))
        assert cfg.to_dict() == fn().to_dict()


def test_a_new_traffic_file_and_cell_run_without_editing(tmp_path):
    before = {p: os.path.getmtime(os.path.join(d, p)) for d, _, fs in os.walk(BENCH)
              for p in fs if not p.endswith(".pyc")}
    with open(os.path.join(BENCH, "traffic", "live.json")) as f:
        mix = json.load(f)
    mix.update(warmup_scans=4, samples=2)
    root = make_root(tmp_path, traffic={"dummy": mix})
    result, lines = lb.run(["--workload", "tiny.dummy", "--seed", "123", "--seconds", "1"],
                           root, device="cpu")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"scan_latency_p95_ms", "scan_latency_p50_ms", "setup_s"}
    after = {p: os.path.getmtime(os.path.join(d, p)) for d, _, fs in os.walk(BENCH)
             for p in fs if not p.endswith(".pyc")}
    assert before == after


def test_a_cell_of_a_missing_file_is_refused(tmp_path):
    root = make_root(tmp_path)
    with pytest.raises(KeyError):
        spec.load(root, "tiny.nowhere")
