"""On the card: a short traced run of each live cell reads the metrics of the
program's own spans and counters, through the by-stage run (all eight) and
through the command itself (the three read from the profiled slice)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

CELLS = ["kitti64.live", "os128.live"]
NEW = ["predict_host_ms.live", "update_host_ms.live", "insert_host_ms.live",
       "host_driver_ms.live", "predict_launches_per_scan.live",
       "update_launches_per_scan.live", "insert_launches_per_scan.live",
       "cuda_mallocs_per_scan.live"]


def _last_line(script, cell, *extra):
    out = subprocess.run([sys.executable, os.path.join(BENCH, script), "--workload", cell,
                          "--seed", "3000000023", "--seconds", "6", "--trace", "1", *extra],
                         capture_output=True, text=True, timeout=420, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_by_stage_run_reads_all_eight(card, cell):
    r, err = _last_line("stages.py", cell)
    assert r["correct"] and r["spans"] and r["device"]["platform"] == "gpu"
    for name in NEW:
        assert r["metrics"].get(name, {}).get("value") is not None, name
    # the program's ranges reach the device trace only as user annotations
    line = next(x for x in err.splitlines() if x.startswith("device events named as"))
    n, ann = (int(v) for v in line.replace(",", "").split()[-4::3])
    assert n == ann


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_reads_the_launches_by_stage(card, cell):
    r, _ = _last_line("run.py", cell)
    assert r["correct"]
    for name in NEW[4:7]:
        assert r["metrics"][name]["value"] > 0, name
