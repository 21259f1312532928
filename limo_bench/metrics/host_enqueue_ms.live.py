"""Host wall of the ``Localizer`` call that dispatched each scan, median
over the window's scans outside the profiled slice (ms).  The step reads
nothing back, so the call returns once the packing, the copies and the
step's launches are queued."""

from lbcore import readers


def read(run):
    return readers.enqueue_ms(run)
