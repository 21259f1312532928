"""The share of in-flight time in the profiled slice in which no kernel,
copy or fill runs on the device.  In-flight time is the union over scans
of [due, pose on the host]: the wait for the sensor is left out."""

from lbcore import main
from lbcore.tracing import length, overlap


def read(run):
    spans = main.inflight(run)
    total = length(spans)
    if total <= 0:
        return None
    busy = run.trace.busy()
    return 1.0 - sum(overlap(busy, s, e) for s, e in spans) / total
