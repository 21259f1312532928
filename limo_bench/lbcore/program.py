"""Arithmetic on the program's own spans and counters, shared by the readers
of the metrics that read them (``metrics/*.py``) and by ``stages.py``.

Two sources:

* the program's export (``Localizer.telemetry.export()``, kept in the run's
  context as ``program`` by a run that switched the recorder on; absent
  otherwise, and then every reader of it returns None): spans on the host's
  ``perf_counter_ns`` clock, each with its dispatch ordinal, and each
  dispatch's ``pose_ready`` time and device allocations;
* the profiled slice (``TraceView``): while a profiler session records, the
  program's spans enter its host trace as ``record_function`` ranges under
  the same names, beside the ``cudaLaunch*`` and ``cudaMalloc`` calls, so
  launches are put down to spans there without the recorder.

The program's spans: ``localizer.arrive`` and ``localizer.dispatch``
(roots), ``localizer.pack``, ``step`` and ``localizer.finish`` (the
dispatch's children), and ``step.predict``, ``step.preprocess``,
``step.deskew``, ``step.voxel``, ``step.update``, ``step.insert`` (the
step's children).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from lbcore import readers

STAGES = ("step.predict", "step.preprocess", "step.deskew", "step.voxel", "step.update",
          "step.insert")
DRIVER = ("localizer.arrive", "localizer.dispatch", "localizer.pack", "localizer.finish")
SPANS = DRIVER[:2] + ("localizer.pack", "step") + STAGES + ("localizer.finish",)


def is_program(name: str) -> bool:
    return name.startswith("localizer.") or name == "step" or name.startswith("step.")


def export(run) -> Optional[dict]:
    """The program's export kept in the run's context, or None."""
    return getattr(run, "program", None)


def self_ns(spans: List[dict]) -> List[Optional[int]]:
    """Each span's duration less its children's (None where a span, or one
    of its children, never ended)."""
    out = [None if s["t1"] is None else s["t1"] - s["t0"] for s in spans]
    for s in spans:
        p = s["parent"]
        if p >= 0 and out[p] is not None:
            out[p] = None if s["t1"] is None else out[p] - (s["t1"] - s["t0"])
    return out


def per_scan_ms(run, names: Iterable[str]) -> Optional[float]:
    """The median, over the window's dispatches before the profiled slice,
    of the self time of the spans named ``names`` a dispatch, a scan (ms);
    None without an export or a dispatch that recorded one."""
    ex = export(run)
    if not ex:
        return None
    names = set(names)
    scans = {d.ordinal: len(d.scans) for d in readers.untraced(run) if d.scans}
    tot: Dict[int, int] = {}
    for s, own in zip(ex["spans"], self_ns(ex["spans"])):
        if s["name"] in names and s["ordinal"] in scans and own is not None:
            tot[s["ordinal"]] = tot.get(s["ordinal"], 0) + own
    v = [1e-6 * t / scans[k] for k, t in tot.items()]
    return float(np.median(v)) if v else None


def mallocs_per_scan(run) -> Optional[float]:
    """The caching allocator's device allocations (``num_device_alloc``)
    over the window's dispatches, a scan; None without a count."""
    ex = export(run)
    if not ex:
        return None
    scans = {d.ordinal: len(d.scans) for d in run.dispatches if d.scans}
    n = [d["device_allocs"] for d in ex["dispatches"]
         if d["ordinal"] in scans and d["device_allocs"] is not None]
    m = sum(scans[d["ordinal"]] for d in ex["dispatches"]
            if d["ordinal"] in scans and d["device_allocs"] is not None)
    return sum(n) / m if m else None


def innermost(spans, times) -> List[Optional[str]]:
    """For each of ``times`` (sorted), the name of the innermost of
    ``spans`` ((start, end, name), nested as one thread's are) holding it."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
            while len(stack) > 1 and stack[-2][1] <= stack[-1][0]:
                stack.pop(-2)
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def slice_spans(tv):
    """The program's spans in the slice's host trace."""
    return [ev for ev in tv.cpu if is_program(ev[2])]


def calls_by_span(tv, prefix: str) -> Dict[Optional[str], int]:
    """The slice's host calls named ``prefix``* by the innermost program
    span around each (None: outside them all)."""
    times = [s for s, _e, n in tv.cpu if n.startswith(prefix)]
    out: Dict[Optional[str], int] = {}
    for n in innermost(slice_spans(tv), times):
        out[n] = out.get(n, 0) + 1
    return out


def launches_per_scan(run, name: str) -> Optional[float]:
    """``cudaLaunch*`` calls inside span ``name`` over the scans dispatched
    in the profiled slice; None where the slice holds no such span."""
    tv = run.trace
    if tv is None or not any(n == name for _s, _e, n in tv.cpu):
        return None
    n = len(readers.traced(run))
    return calls_by_span(tv, "cudaLaunch").get(name, 0) / n if n else None


def idle_by_span(tv, spans) -> Dict[Optional[str], float]:
    """The device's idle time inside ``spans`` (s) by the innermost program
    span at each gap's midpoint."""
    gaps = tv.gaps(spans)
    mids = [0.5 * (s + e) for s, e in gaps]
    order = np.argsort(mids)
    names = innermost(slice_spans(tv), [mids[i] for i in order])
    out: Dict[Optional[str], float] = {}
    for i, n in zip(order, names):
        out[n] = out.get(n, 0.0) + gaps[i][1] - gaps[i][0]
    return out


def device_tail_ms(run) -> List[float]:
    """For each dispatch before the profiled slice: from the host's end of
    its ``step`` span to its ``pose_ready`` on the device (ms)."""
    ex = export(run)
    if not ex:
        return []
    keep = {d.ordinal for d in readers.untraced(run)}
    ends = {s["ordinal"]: s["t1"] for s in ex["spans"]
            if s["name"] == "step" and s["t1"] is not None}
    return [1e-6 * (d["pose_ready"] - ends[d["ordinal"]]) for d in ex["dispatches"]
            if d["ordinal"] in keep and d["ordinal"] in ends and d["pose_ready"] is not None]


def pose_latency_ms(run) -> List[float]:
    """For each dispatch before the profiled slice: from its first scan's
    arrival in the program to its ``pose_ready`` (ms)."""
    ex = export(run)
    if not ex:
        return []
    keep = {d.ordinal for d in readers.untraced(run)}
    return [1e-6 * (d["pose_ready"] - d["arrive"]) for d in ex["dispatches"]
            if d["ordinal"] in keep and d["arrive"] is not None and d["pose_ready"] is not None]


def stage_device_ms(run, name: str) -> Optional[float]:
    """Median, over the dispatches before the slice, of the device time
    between the CUDA events at span ``name``'s two ends, a scan (ms)."""
    ex = export(run)
    if not ex:
        return None
    scans = {d.ordinal: len(d.scans) for d in readers.untraced(run) if d.scans}
    tot: Dict[int, int] = {}
    for s in ex["spans"]:
        if (s["name"] == name and s["ordinal"] in scans and s["dev0"] is not None
                and s["dev1"] is not None):
            tot[s["ordinal"]] = tot.get(s["ordinal"], 0) + s["dev1"] - s["dev0"]
    v = [1e-6 * t / scans[k] for k, t in tot.items()]
    return float(np.median(v)) if v else None


def coverage(run) -> List[float]:
    """For each dispatch before the profiled slice: its root spans' time
    (its scans' arrivals and the dispatch) over the host wall of the call
    that dispatched it (above 1 where a scan arrived in an earlier call)."""
    ex = export(run)
    if not ex:
        return []
    calls = {d.ordinal: (d.t_call0, d.t_call1) for d in readers.untraced(run)}
    roots: Dict[int, int] = {}
    for s in ex["spans"]:
        if s["parent"] < 0 and s["ordinal"] in calls and s["t1"] is not None:
            roots[s["ordinal"]] = roots.get(s["ordinal"], 0) + s["t1"] - s["t0"]
    return [1e-9 * t / (calls[k][1] - calls[k][0]) for k, t in roots.items()
            if calls[k][1] > calls[k][0]]


def quantile(v, q: float) -> float:
    return float(np.percentile(v, q)) if len(v) else float("nan")


def lines(run) -> List[str]:
    """Standard-error lines of the by-stage view: per span its host ms a
    scan (before the slice), its launches a scan, the slice's ``cudaMalloc``
    calls and device idle ms in it; the device tail, the pose latency and
    the anchor's drift."""
    ex, tv = export(run), run.trace
    out = []
    launches = calls_by_span(tv, "cudaLaunch") if tv else {}
    mallocs = calls_by_span(tv, "cudaMalloc") if tv else {}
    idle = {}
    if tv:
        from lbcore import main

        spans = main.inflight(run) if run.open_loop else [(tv.t_on, tv.t_off)]
        idle = idle_by_span(tv, spans)
    n = len(readers.traced(run)) if tv else 0
    out.append("by span (host ms a scan before the slice, self time; device ms between its "
               "events; launches a scan, cudaMalloc calls and device idle ms in the slice):")
    for name in SPANS + (None,):
        host = per_scan_ms(run, [name]) if name else None
        dev = stage_device_ms(run, name) if name in STAGES else None
        out.append(f"  {name or 'outside the spans':18s} host {_f(host)}  device {_f(dev)}  "
                   f"launches {_f(launches.get(name, 0) / n if n else None)}  "
                   f"cudaMalloc {mallocs.get(name, 0) if tv else 'n/a'}  "
                   f"idle {_f(1e3 * idle[name] if name in idle else (0.0 if tv else None))}")
    if n:
        out.append(f"launches a scan in the slice: {sum(launches.values()) / n:.1f} in all, "
                   f"{sum(v for k, v in launches.items() if k) / n:.1f} inside the spans")
    driver = per_scan_ms(run, DRIVER)
    stages = per_scan_ms(run, STAGES + ("step",))
    enq, cover = readers.enqueue_ms(run), coverage(run)
    if driver is not None and stages is not None and enq and cover:
        out.append(f"host driver {driver:.3f} + step {stages:.3f} ms a scan (medians) against "
                   f"host_enqueue_ms {enq:.3f}; the spans cover {100 * quantile(cover, 50):.1f} % "
                   f"of the dispatching call (median; {100 * min(cover):.1f}-"
                   f"{100 * max(cover):.1f} %)")
    tail, pose = device_tail_ms(run), pose_latency_ms(run)
    if tail:
        out.append(f"device tail, step's end to pose_ready (ms): p50 {quantile(tail, 50):.3f} "
                   f"p95 {quantile(tail, 95):.3f} max {max(tail):.3f} over {len(tail)}")
    if pose:
        out.append(f"pose latency, arrival to pose_ready (ms): p50 {quantile(pose, 50):.3f} "
                   f"p95 {quantile(pose, 95):.3f} over {len(pose)}")
    if ex and ex.get("anchor"):
        a = ex["anchor"]
        out.append(f"anchor drift {1e-6 * a['drift_ns']:.4f} ms over {1e-9 * a['over_ns']:.1f} s "
                   f"(each anchor within +-{1e-3 * a['error_ns']:.1f} us); device events mapped "
                   f"at {a.get('scale', 1.0):.9f} host ns a device ns")
    if ex:
        allocs = [(d["ordinal"], d["device_allocs"]) for d in ex["dispatches"]
                  if d["device_allocs"]]
        first = min((d.ordinal for d in run.dispatches), default=0)
        out.append(f"device allocations in {len(allocs)} dispatches, (window dispatch, count): "
                   f"{[(k - first, n) for k, n in allocs[:12]]}")
    if ex:
        out.append(f"recorded {len(ex['spans'])} spans and {len(ex['dispatches'])} dispatches, "
                   f"{ex['dropped']} dropped; counters {ex.get('counters')}")
    return out


def _f(v) -> str:
    return "n/a" if v is None else f"{v:8.3f}"
