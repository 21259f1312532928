"""One run of one cell: set-up, the measured window, the output check, the
result line.  See ``run.py`` for the command and ``PERF.md`` for the
metrics."""

from __future__ import annotations

import argparse
import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from gen import corridor
from lbcore import check, drive, spec
from lbcore.tracing import Tracer, union
from reference import host

FORBIDDEN = ("jax", "jaxlib", "flax", "fast_limo_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="limo_bench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def draws(seed: int, n: int, lo: int, hi: int):
    """``n`` distinct dispatch ordinals in [lo, hi), drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))
    return sorted(int(v) for v in rng.choice(np.arange(lo, hi), size=min(n, hi - lo),
                                             replace=False))


def draw_times(seed: int, n: int, seconds: float):
    """``n`` times in the window, drawn from the seed: one in each of ``n``
    equal parts of its span from 2 % to 95 % of ``seconds``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 6]))
    edges = np.linspace(0.02, 0.95, n + 1) * seconds
    return sorted(float(v) for v in rng.uniform(edges[:-1], edges[1:]))


def generate(cell, seed: int, seconds: float, device):
    """The sweeps and IMU stream of the run, enough for warm-up and window."""
    t = cell.traffic
    drv = corridor.from_dict(corridor.Drive, t["drive"])
    sensor = corridor.from_dict(corridor.Sensor, cell.config["sensor"])
    rate = sensor.scan_rate if t["loop"] == "open" else t["max_rate_hz"]
    n = t["warmup_scans"] + int(math.ceil(seconds * rate)) + 2 * t["chunk"]
    sweeps = corridor.sweeps(seed, drv, sensor, n, device)
    imu = corridor.imu_stream(seed, drv, sensor, n + 10)
    return drv, sensor, sweeps, imu


def measure(argv, root: str, device: str = "cuda", t_start: float = None, fault=None,
            samples: int = None):
    """Set-up and the measured window.  ``device``, ``fault`` (a function
    that wraps the program's step) and ``samples`` (in place of the
    traffic's number of dispatches drawn) are for the harness's own tests
    and its calibration.  Returns the run's context: its metrics, the
    drawn dispatches' samples and the inputs the reference needs."""
    t_start = time.perf_counter() if t_start is None else t_start
    a = parse(argv)
    cell = spec.load(root, a.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"limo_bench: {cell.name} needs {cell.chips} CUDA device(s), "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from fast_limo_tpu_torch.models import iekf
    from fast_limo_tpu_torch.models.localizer import Localizer

    traffic = cell.traffic
    chunk = int(traffic["chunk"])
    cfg = spec.program_config(cell)
    cfg.tpu.scan_chunk = chunk          # the entry the traffic drives
    marks = {"interpreter, torch and the program imported": time.perf_counter()}
    drv, sensor, sweeps, imu = generate(cell, a.seed, a.seconds, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks["the drive drawn"] = time.perf_counter()

    warm = int(traffic["warmup_scans"])
    first = warm // chunk
    open_loop = traffic["loop"] == "open"
    n_drawn = int(traffic["samples"]) if samples is None else samples
    if open_loop:       # ordinals over the schedule's first four fifths
        reach = first + max(1, int(a.seconds * sensor.scan_rate * 0.8) // chunk)
        drawn, times = [0] + draws(a.seed, n_drawn, first, reach), []
    else:
        drawn, times = [0], draw_times(a.seed, n_drawn, a.seconds)

    loc = Localizer(cfg, device=device)
    ev = traffic.get("evict")
    if ev:
        loc.evict_radius, loc.evict_occupancy = float(ev["radius"]), float(ev["occupancy"])
    if fault is not None:
        loc.scan_step = fault(loc.scan_step)
    marks["the Localizer built"] = time.perf_counter()
    rec = drive.Recorder(loc, chunk, drawn, times)
    tracer = None
    if a.trace:
        tracer = Tracer(traffic["trace_start_share"] * a.seconds,
                        min(traffic["trace_seconds"], 0.25 * a.seconds))
    driver = drive.Driver(loc, rec, sweeps, imu, 1.0 / sensor.scan_rate)
    driver.warm_up(warm, read_pose=open_loop)
    marks[f"{warm} warm-up scans"] = time.perf_counter()
    fb0 = iekf.counters.loop_fallbacks
    driver.tracer = tracer
    gc_pauses = []
    gc_watch = _gc_watch(gc_pauses)
    gc.callbacks.append(gc_watch)
    setup_s = time.perf_counter() - t_start

    w = driver.open_loop(a.seconds) if open_loop else driver.closed_loop(a.seconds)

    gc.callbacks.remove(gc_watch)

    drive.sync()
    ctx = SimpleNamespace(args=a, cell=cell, cfg=cfg, window=w, setup_s=setup_s,
                          fallbacks=iekf.counters.loop_fallbacks - fb0, trace=None,
                          peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
                          dispatches=[d for d in rec.dispatches if d.ordinal >= first],
                          drawn=len(drawn) + len(times), missed=len(rec.times)
                          + sum(k not in rec.samples for k in drawn),
                          samples=[rec.samples[k] for k in sorted(rec.samples)],
                          stream=host.Stream(host.config(cell.config["config"]), sweeps, imu),
                          open_loop=open_loop)
    occupancy = int(loc.state.map.num_points) / (cfg.tpu.map_capacity * cfg.map_points_per_voxel)
    traj, stamps = loc.positions(), loc.stamps()
    done = {s: d for d in rec.dispatches for s in d.scans}
    ctx.failed, ctx.latencies_ms, ctx.lines = 0, [], []
    t, parts = t_start, []
    for name, at in marks.items():
        parts.append(f"{name} {at - t:.2f} s")
        t = at
    ctx.lines.append("set-up: " + ", ".join(parts))
    for s in w.scans:
        d = done.get(s)
        ok = d is not None and s < len(traj) and bool(np.all(np.isfinite(traj[s])))
        ctx.failed += not ok
        if open_loop:
            ctx.latencies_ms.append(1e3 * (d.t_pose - w.due[s]) if ok else math.inf)
    ctx.lines += _latency_lines(ctx, done)
    ate = float(np.sqrt(np.mean(np.sum((traj - drv.pos(stamps)) ** 2, 1))))
    ctx.lines += [f"{len(gc_pauses)} garbage collections in the window, the longest "
                  f"{1e3 * max(gc_pauses, default=0.0):.3f} ms",
                  f"map occupancy at the window's end {occupancy:.4f}",
                  f"host lag behind the schedule at most {1e3 * w.lag_s:.3f} ms",
                  f"trajectory error against the drive's truth, RMS {ate:.4f} m over "
                  f"{len(traj)} scans"]
    if a.trace:
        ctx.trace = tv = tracer.view()
        for name, ds in (("before", [d for d in ctx.dispatches if d.t_call1 <= tv.t_on]),
                         ("in", [d for d in ctx.dispatches if tv.t_on <= d.t_call0 <= tv.t_off]),
                         ("after", [d for d in ctx.dispatches if d.t_call0 >= tv.t_off])):
            v = [1e3 * (d.t_call1 - d.t_call0) / len(d.scans) for d in ds if d.scans]
            ctx.lines.append(f"host ms a scan of the dispatching calls {name} the profiled "
                             f"slice: median {np.median(v) if v else float('nan'):.3f} over {len(v)}")
        ctx.lines.append(f"the profiler's start and stop took {w.shift_s:.2f} s, "
                         f"left out of the schedule")
    # the program's state goes before the reference runs
    del loc, driver, rec
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return ctx


def _latency_lines(ctx, done):
    """Standard-error lines on the open loop's latencies: their deciles,
    the dispatching calls' host time, and where the three latest scans
    spent theirs."""
    if not ctx.latencies_ms:
        return []
    w, lat = ctx.window, np.asarray(ctx.latencies_ms)
    worst = np.argsort(lat)[::-1][:3]
    lines = [f"{len(lat)} scan latencies (ms): first {np.round(lat[:3], 2).tolist()}, "
             f"largest {np.round(lat[worst], 2).tolist()} at window scans {worst.tolist()}",
             "  deciles (ms): " + " ".join(
                 f"{v:.1f}" for v in np.percentile(lat[np.isfinite(lat)], np.arange(10, 100, 10)))]
    calls = [1e3 * (d.t_call1 - d.t_call0) for d in ctx.dispatches]
    if calls:
        lines.append("  dispatching call deciles (ms): " + " ".join(
            f"{v:.1f}" for v in np.percentile(calls, np.arange(10, 100, 10))))
    for j in worst:
        s = w.scans[j]
        d = done.get(s)
        if d is not None:
            lines.append(f"  scan {s}: due to call {1e3 * (d.t_call0 - w.due[s]):.2f} ms, call "
                         f"{1e3 * (d.t_call1 - d.t_call0):.2f} ms, call to pose "
                         f"{1e3 * (d.t_pose - d.t_call1):.2f} ms")
    return lines


def _gc_watch(pauses):
    """A ``gc.callbacks`` entry that records each collection's duration."""
    t = [0.0]

    def watch(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - t[0])

    return watch


def run(argv, root: str, device: str = "cuda", t_start: float = None, fault=None):
    """One run: ``measure``, the metrics, the output check; returns (result
    dict, lines for standard error, the compared numbers last)."""
    ctx = measure(argv, root, device, t_start, fault)
    cell, lines = ctx.cell, ctx.lines
    metrics = {}
    for m in (cell.per_layer if ctx.args.trace else cell.end_to_end):
        v = ctx.setup_s if m.name == "setup_s" else m.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}

    t_check = time.perf_counter()
    samples = ctx.samples
    if ctx.missed:
        lines.append(f"{ctx.missed} of the {ctx.drawn} drawn dispatches did not run")
    numbers = check.compare(ctx.stream, samples, device)
    correct, check_lines = check.judge(numbers, cell.limits)
    correct &= ctx.missed == 0 and ctx.failed == 0
    lines.append(f"output check: {len(samples)} dispatches ({sum(len(s.scans) for s in samples)} "
                 f"scans) against the reference in {time.perf_counter() - t_check:.1f} s")
    lines += check_lines

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(ctx.peak)}
    result = {"correct": bool(correct), "attempted": len(ctx.window.scans),
              "failed": ctx.failed, "metrics": metrics, "device": dev}
    if ctx.args.trace:
        tv = ctx.trace
        dev["busy_s"] = sum(e - s for s, e in tv.busy())
        dev["window_s"] = tv.window_s
        result["breakdown"] = tv.breakdown(inflight(ctx) if ctx.open_loop
                                           else [(tv.t_on, tv.t_off)])
    result["checks"] = {k: {"value": numbers[k], "limit": float(cell.limits[k])}
                        for k in check.NAMES}
    return result, lines


def inflight(ctx):
    """The traced slice's in-flight time: the union over scans of [due,
    pose on the host], clipped to the slice."""
    tv = ctx.trace
    spans = sorted((ctx.window.due[s], d.t_pose) for d in ctx.dispatches for s in d.scans
                   if s in ctx.window.due)
    return union(spans, tv.t_on, tv.t_off)
