"""Nothing the benchmark runs loads JAX or the JAX package, and a run
without a card fails without a result."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

SNIPPET = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(1)
from lbcore import main as lb
lb.run(["--workload", {cell!r}, "--seed", "77", "--seconds", "1"], {tiny!r}, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("mix", ["live", "replay4"])
def test_a_run_loads_no_jax(tiny_root, mix):
    code = SNIPPET.format(bench=BENCH, root=ROOT, cell=f"tiny.{mix}", tiny=tiny_root)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fast_limo_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "fast_limo_tpu"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from lbcore import main as lb

    monkeypatch.setitem(sys.modules, "fast_limo_tpu_torch.models", sys.modules[__name__])
    assert "fast_limo_tpu" not in lb.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fast_limo_tpu.models", sys.modules[__name__])
    assert "fast_limo_tpu" in lb.forbidden_modules()


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "kitti64.live", "--seed", "1", "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
