"""Kernel launches (host calls named ``cudaLaunch*`` in the profiler's host
trace) inside the program's ``step.update`` span, which enters the trace as
a ``record_function`` range while the profiler records, over the scans
dispatched in the profiled slice; None where the slice holds no such span."""

from lbcore import program


def read(run):
    return program.launches_per_scan(run, "step.update")
