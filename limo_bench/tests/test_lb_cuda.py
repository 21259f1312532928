"""On the card: one short run of each cell through the command itself,
and the control of the output check at the cell's own size."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

CELLS = ["kitti64.live", "os128.live", "kitti64.replay4"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
                          "--seed", "3000000019", "--seconds", "6", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert r["metrics"] and list(r)[-1] == "checks"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "calibrate.py"), "--workload",
                          cell, "--seconds", "3", "--seeds", "3000000021"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(BENCH, "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    assert all(summary["sound_max"][k] <= v for k, v in limits.items())
    assert any(summary["control_min"][k] > v for k, v in limits.items())
