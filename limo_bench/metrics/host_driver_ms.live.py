"""Host time of the program's dispatch path outside the step: the
``localizer.arrive`` span plus ``localizer.dispatch`` less its ``step``
child (the IMU pack and copy, the step's call outside the step, the
finish), median a scan over the window's dispatches before the profiled
slice (ms).  Read from the program's export, which a run keeps only where
it switched the program's recorder on; else None."""

from lbcore import program


def read(run):
    return program.per_scan_ms(run, program.DRIVER)
