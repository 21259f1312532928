"""Readings that the output check's limits are set from (not run by the
benchmark's own runs).

    python3 limo_bench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--samples <k>] [--control-seeds <n>] [--control-samples <k>]

For each seed, in one process: the cell's set-up and a window of
``--seconds``, then, on the dispatches the run drew (``--samples`` of them
besides the first, in place of the traffic's number), the compared numbers
of the program against the reference (the lower readings) and of the
control (``reference/control.py``: the reference in bfloat16 in the
program's place) against the reference (the upper readings), on the first
``--control-seeds`` seeds and their first ``--control-samples`` dispatches.
One JSON line a seed, and a summary line last.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [HERE, ROOT]


def main(argv) -> int:
    import argparse

    import torch

    from lbcore import check
    from lbcore import main as lb
    from reference import control, host

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="run the control on the first this many seeds")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--control-samples", type=int, default=None)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    rows = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = lb.measure(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds)], ROOT, a.device, samples=a.samples)
        sound = check.compare(ctx.stream, ctx.samples, a.device)
        row = {"seed": seed, "sound": sound, "dispatches": len(ctx.samples), "missed": ctx.missed,
               "fallbacks": ctx.fallbacks, "lines": ctx.lines}
        if len(rows) < a.control_seeds:
            worst = {k: 0.0 for k in check.NAMES}
            for s in ctx.samples[:a.control_samples]:
                ref_post, ref_outs = host.step(ctx.stream, s.scans, s.pre, a.device)
                with control.Bfloat16():
                    c_post, c_outs = host.step(ctx.stream, s.scans, s.pre, a.device)
                outs = tuple(torch.stack([getattr(o, f) for o in c_outs]) for f in
                             ("pos", "quat", "vel"))
                g = check.gaps(s.pre, c_post, outs, ref_post, ref_outs)
                worst = {k: max(worst[k], g[k]) if g[k] == g[k] else float("nan")
                         for k in check.NAMES}
            row["control"] = worst
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": a.workload, "seeds": a.seeds,
               "sound_max": {k: max(r["sound"][k] for r in rows) for k in check.NAMES}}
    ctl = [r["control"] for r in rows if "control" in r]
    if ctl:
        summary["control_min"] = {k: min(c[k] for c in ctl) for k in check.NAMES}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
