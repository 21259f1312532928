"""Host time of the program's ``localizer.downsample`` spans (the stride that
picks a sweep's returns for the scan slots when the sweep holds more), which
enter the profiler's host trace as ``record_function`` ranges: summed over
the calls that dispatched the scans of the profiled slice, over those scans
(ms a scan); None where the slice holds no such range (a sweep that fits its
slots opens none)."""

from lbcore import readers

NAME = "localizer.downsample"


def read(run):
    tv = run.trace
    if tv is None:
        return None
    ranges = [(s, e) for s, e, n in tv.cpu if n == NAME]
    ds = [d for d in readers.traced(run) if d.scans]
    if not ranges or not ds:
        return None
    spent = sum(e - s for s, e in ranges
                if any(d.t_call0 <= s and e <= d.t_call1 for d in ds))
    return 1e3 * spent / sum(len(d.scans) for d in ds)
