"""Host wall of each chunk dispatch's call over its scans, median over the
window's dispatches outside the profiled slice (ms a scan)."""

from lbcore import readers


def read(run):
    return readers.enqueue_ms(run)
