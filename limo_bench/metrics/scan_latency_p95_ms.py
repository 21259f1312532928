"""The 95th percentile over the window's scans of the time from a scan's
due time (its sweep's end on the sensor's schedule) to its pose on the
host (ms); a scan never dispatched, or with a pose that is not finite,
counts as infinitely late."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_ms), 95)) if run.latencies_ms else None
