"""The harness's own tests: ``python -m pytest limo_bench/tests -q`` from
the repository root.  Tests marked ``cuda`` need the card and skip here."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_root(path, traffic=None):
    """A test root: BENCHMARK.json with a 'tiny' configuration (kitti64's
    at 2048 slots and a 4096-entry map) and its cells 'tiny.<mix>' for
    every traffic mix, limits copied from kitti64's cells; ``traffic``
    ({name: dict}) adds traffic files of the test's own.  The root's files
    are found before the harness's."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "kitti64.json")) as f:
        conf = json.load(f)
    tiny = copy.deepcopy(conf)
    tiny["config"]["tpu"].update(max_points_per_scan=2048, map_capacity=4096,
                                 max_insert_points=1024)
    tiny["config"]["ikfom"]["mapping"].update(MAX_NUM_PC2MATCH=512, MAX_NUM_MATCHES=256)
    tiny["sensor"]["points_per_scan"] = 2048
    for d in ("configs", "limits", "traffic"):
        os.makedirs(os.path.join(path, "limo_bench", d), exist_ok=True)
    with open(os.path.join(path, "limo_bench", "configs", "tiny.json"), "w") as f:
        json.dump(tiny, f)
    mixes = {"live": "kitti64.live", "replay4": "kitti64.replay4"}
    for name, t in (traffic or {}).items():
        with open(os.path.join(path, "limo_bench", "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
        mixes[name] = "kitti64.live" if t["loop"] == "open" else "kitti64.replay4"
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                             "file": "limo_bench/configs/tiny.json"})
    for mix, like in mixes.items():
        cell = f"tiny.{mix}"
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": mix,
                                   "chips": 1, "why": "test"})
        with open(os.path.join(BENCH, "limits", f"{like}.json")) as f:
            lim = json.load(f)
        with open(os.path.join(path, "limo_bench", "limits", f"{cell}.json"), "w") as f:
            json.dump(lim, f)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))
