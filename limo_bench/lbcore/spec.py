"""A cell by name: its entry in ``BENCHMARK.json``, its configuration file,
its traffic file, its limits and the readers of its per-layer metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``<config file>`` (the configuration's ``file``): ``config`` (the port's
  ``Config`` fields, nested as ``Config.to_dict`` gives them), ``sensor``
  (``gen.corridor.Sensor``), ``source``, ``reduced``, ``assumed``;
* ``limo_bench/traffic/<traffic>.json``: the arrival loop and the drive;
* ``limo_bench/limits/<cell>.json``: the limit of each number compared;
* ``limo_bench/metrics/<metric>.py``: ``read(run)``, one metric (every
  metric but ``setup_s``, which the harness takes itself).

A file under the root given (the checkout, or a test's directory) is taken
before the harness's own, so a new cell needs new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # limo_bench/
DIR = os.path.basename(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    read: Optional[Callable]      # read(run) → float | None; None for setup_s


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _find(root: str, *rel) -> str:
    for base in (os.path.join(root, DIR), HERE):
        path = os.path.join(base, *rel)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"{os.path.join(DIR, *rel)} not found under {root} or {HERE}")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(root: str, name: str) -> Callable:
    path = _find(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"limo_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(root: str, cell_name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [Metric(m["name"], m["unit"],
                  None if m["name"] == "setup_s" else _reader(root, m["name"]))
           for m in bench["end_to_end"] if _applies(m, cell_name)]
    moved = {m.name for m in e2e}
    layer = [Metric(m["name"], m["unit"], _reader(root, m["name"]))
             for m in bench["per_layer"] if _applies(m, cell_name) and m["moves"] in moved]
    return Cell(name=cell_name, chips=int(w["chips"]),
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(_find(root, "traffic", f"{w['traffic']}.json")),
                limits=_json(_find(root, "limits", f"{cell_name}.json")),
                end_to_end=e2e, per_layer=layer)


def program_config(cell: Cell):
    """The port's ``Config`` with the configuration file's fields set."""
    from fast_limo_tpu_torch.utils.config import Config

    cfg = Config()
    _assign(cfg, cell.config["config"], "config")
    return cfg


def _assign(obj, values: Dict, where: str) -> None:
    for key, val in values.items():
        if not hasattr(obj, key):
            raise ValueError(f"{where}.{key} is not a field of {type(obj).__name__}")
        if isinstance(val, dict):
            _assign(getattr(obj, key), val, f"{where}.{key}")
        else:
            setattr(obj, key, val)
