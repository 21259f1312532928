"""The benchmark of fast_limo_tpu_torch on one card: one run of one cell.

    python3 limo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the run makes the drive from the
seed, builds the program's ``Localizer``, warms it up, measures for
``--seconds``, checks the outputs against the plain reference and prints
one JSON line last: the end-to-end metrics (``--trace 0``) or the per-layer
metrics with the device trace's figures (``--trace 1``).  Without a CUDA
device it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build")

# one thread of host compute (the program's host path is one Python
# thread), and every cache inside the checkout at a fixed path
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
sys.path[:0] = [HERE, ROOT]


def main() -> int:
    import torch

    from lbcore import main as lb

    torch.set_num_threads(1)
    try:
        result, lines = lb.run(sys.argv[1:], ROOT, t_start=T_START)
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 2
        raise
    bad = lb.forbidden_modules()
    if bad:
        print(f"limo_bench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
