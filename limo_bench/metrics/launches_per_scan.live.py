"""Kernel launches (host calls named ``cudaLaunch*`` in the profiler's host
trace) over the scans dispatched in the profiled slice."""

from lbcore import readers


def read(run):
    n = len(readers.traced(run))
    return run.trace.launches / n if n and run.trace.launches else None
