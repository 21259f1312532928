"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``).

Each reader takes the run (``lbcore.main``'s context: the cell, the
program's config, the window, its dispatches with host times, the device
counter's change and, in a traced run, the trace) and returns a number or
None when it finds nothing to read."""

from __future__ import annotations

import numpy as np

from roofline import counts


def untraced(ctx):
    """The window's dispatches before the profiled slice: the profiler
    slows the host while it runs and may leave CUPTI's callbacks behind."""
    tv = ctx.trace
    return [d for d in ctx.dispatches if tv is None or d.t_call1 <= tv.t_on]


def traced(ctx):
    """The window's dispatches whose calls ran inside the profiled slice."""
    tv = ctx.trace
    return [d for d in ctx.dispatches if d.t_call0 >= tv.t_on and d.t_call1 <= tv.t_off]


def enqueue_ms(ctx):
    """Median host wall of the call that dispatched, a scan (ms)."""
    v = [1e3 * (d.t_call1 - d.t_call0) / len(d.scans) for d in untraced(ctx) if d.scans]
    return float(np.median(v)) if v else None


def roofline_pct(ctx, prefix: str, works):
    """100 × the least time of the traced kernels named ``prefix``* over
    their device time, or None if the slice holds none.  The launches take
    the ``works`` in turn (a scan's sorts: the voxel sort, then the
    insert's), so each launch counts their mean."""
    ks = ctx.trace.kernels(prefix)
    if not ks:
        return None
    least = sum(counts.bound_ms(*w)[0] for w in works) * len(ks) / len(works)
    spent = 1e3 * sum(e - s for s, e in ks)
    return 100.0 * least / spent
