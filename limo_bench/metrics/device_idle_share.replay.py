"""The share of the profiled slice in which no kernel, copy or fill runs
on the device."""

from lbcore.tracing import length


def read(run):
    tv = run.trace
    return 1.0 - length(tv.busy()) / tv.window_s if tv.window_s > 0 else None
