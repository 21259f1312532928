"""One run of one cell with the program's own span and counter recorder on:
the by-stage view of the dispatch path.

    python3 limo_bench/stages.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--spans 0|1]

from the root of a checkout.  The same run as ``run.py``'s (``lbcore.main
.measure``: the drive from the seed, the ``Localizer``, the warm-up, the
window, in a traced run the profiled slice) with two additions: after the
warm-up it switches the program's recorder on (``Localizer.telemetry
.trace(True)``; ``--spans 0`` leaves it off, the control for the
recorder's cost), and before the program's state goes it keeps the
recorder's ``export()`` in the run's context as ``program``.  On standard
error: ``run.py``'s lines, the by-stage view (``lbcore.program.lines``)
and, in a traced run, whether the program's spans reached the device trace
only as user annotations.  Last, one JSON line: ``correct`` (the output
check) and every metric of the cell that the run can read, end-to-end and
per-layer, with the metrics that read the program's export (``EXTRA``).
Without a CUDA device it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402  (the environment and sys.path of run.py)

EXTRA = {          # name: (unit, source)
    "predict_host_ms.live": ("ms", "program_span"),
    "update_host_ms.live": ("ms", "program_span"),
    "insert_host_ms.live": ("ms", "program_span"),
    "host_driver_ms.live": ("ms", "program_span"),
    "predict_launches_per_scan.live": ("launches/scan", "device_trace"),
    "update_launches_per_scan.live": ("launches/scan", "device_trace"),
    "insert_launches_per_scan.live": ("launches/scan", "device_trace"),
    "cuda_mallocs_per_scan.live": ("mallocs/scan", "program_counter"),
}


def split(argv):
    """(run.py's arguments, whether the recorder goes on)."""
    argv, spans = list(argv), 1
    if "--spans" in argv:
        i = argv.index("--spans")
        spans = int(argv[i + 1])
        del argv[i:i + 2]
    return argv, bool(spans)


def measure(argv, root: str, device: str = "cuda", t_start: float = None, spans: bool = True):
    """``lbcore.main.measure`` with the recorder switched on after the
    warm-up and its export kept; returns (context, the profiler session's
    tracer or None)."""
    from lbcore import drive, main, tracing

    kept = {}

    class Driver(drive.Driver):
        def warm_up(self, n_scans, read_pose):
            super().warm_up(n_scans, read_pose)
            kept["loc"] = self.loc
            if spans:
                self.loc.telemetry.trace(True)

    class Tracer(tracing.Tracer):
        def __init__(self, *a):
            super().__init__(*a)
            kept["tracer"] = self

    saved = drive.Driver, main.Tracer
    drive.Driver, main.Tracer = Driver, Tracer
    try:
        ctx = main.measure(argv, root, device, t_start)
    finally:
        drive.Driver, main.Tracer = saved
    loc = kept.pop("loc")
    ctx.program = loc.telemetry.export() if spans else None
    del loc
    return ctx, kept.get("tracer")


def annotations(tracer):
    """(device events named as a program span, how many of them the
    profiler marks as user annotations)."""
    import torch

    from lbcore import program

    n = ann = 0
    for e in tracer.prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and program.is_program(e.name()):
            n += 1
            ann += bool(e.is_user_annotation())
    return n, ann


def device_ops_by_span(tracer, top: int = 3):
    """The slice's device ops put down to the innermost program span around
    the host call that launched each (the runtime call of the same
    correlation, else the host op linked to it): {span: (device s, [(op,
    s), ...] its ``top`` largest)}."""
    import torch

    from lbcore import program

    runtime, ops, dev, spans = {}, {}, [], []
    to_s = lambda ns: 1e-9 * (ns - tracer.offset_ns)  # noqa: E731
    for e in tracer.prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.correlation_id(), e.linked_correlation_id(), e.duration_ns(),
                            e.name()))
        elif e.name().startswith("cuda"):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
            if program.is_program(e.name()):
                spans.append((to_s(e.start_ns()), to_s(e.end_ns()), e.name()))
    launched = sorted((to_s(runtime.get(c, ops.get(lc))), d, n) for c, lc, d, n in dev
                      if c in runtime or lc in ops)
    out = {}
    for (_t, d, n), span in zip(launched, program.innermost(spans, [t for t, _, _ in launched])):
        total, by_op = out.get(span, (0.0, {}))
        by_op[n] = by_op.get(n, 0.0) + 1e-9 * d
        out[span] = (total + 1e-9 * d, by_op)
    return {k: (v, sorted(by_op.items(), key=lambda kv: -kv[1])[:top])
            for k, (v, by_op) in out.items()}


def run(argv, root: str, device: str = "cuda", t_start: float = None):
    """One run; returns (result dict, lines for standard error)."""
    import torch

    from lbcore import check, program, spec

    argv, spans = split(argv)
    ctx, tracer = measure(argv, root, device, t_start, spans)
    cell, lines = ctx.cell, ctx.lines
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    source = {m["name"]: m["source"] for m in bench["end_to_end"] + bench["per_layer"]}
    source.update({k: v[1] for k, v in EXTRA.items()})
    metrics = {}
    readers = [(m.name, m.unit, m.read) for m in cell.end_to_end + cell.per_layer]
    readers += [(n, unit, spec._reader(root, n)) for n, (unit, _) in EXTRA.items()
                if n not in {m.name for m in cell.per_layer}]
    for name, unit, read in readers:
        if name == "setup_s":
            v = ctx.setup_s
        elif ctx.trace is None and source[name] == "device_trace":
            v = None        # read from the profiled slice
        else:
            v = read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    lines += program.lines(ctx)
    if tracer is not None:
        n, ann = annotations(tracer)
        lines.append(f"device events named as program spans: {n}, user annotations: {ann}")
        lines.append("device ms in the slice by the span that launched it, and its top ops:")
        for span, (t, ops) in sorted(device_ops_by_span(tracer).items(), key=lambda kv: -kv[1][0]):
            lines.append(f"  {span or 'outside the spans':18s} {1e3 * t:9.3f}  " + "; ".join(
                f"{1e3 * v:.3f} {name[:60]}" for name, v in ops))
    numbers = check.compare(ctx.stream, ctx.samples, device)
    correct, check_lines = check.judge(numbers, cell.limits)
    correct &= ctx.missed == 0 and ctx.failed == 0
    lines += check_lines
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(ctx.peak)}
    return {"correct": bool(correct), "spans": spans, "attempted": len(ctx.window.scans),
            "failed": ctx.failed, "metrics": metrics, "device": dev}, lines


def main() -> int:
    import torch

    torch.set_num_threads(1)
    try:
        result, lines = run(sys.argv[1:], _run.ROOT, t_start=T_START)
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 2
        raise
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
