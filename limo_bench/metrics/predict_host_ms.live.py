"""Host time of the step's ``step.predict`` span (the program's own span,
host clock), median a scan over the window's dispatches before the
profiled slice (ms).  Read from the program's export, which a run keeps
only where it switched the program's recorder on; else None."""

from lbcore import program


def read(run):
    return program.per_scan_ms(run, ["step.predict"])
