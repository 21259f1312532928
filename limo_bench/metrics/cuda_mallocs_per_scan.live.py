"""Device allocations of the caching allocator (``num_device_alloc``, the
program's counter read at each dispatch's end) over the window's scans.
Read from the program's export, which a run keeps only where it switched
the program's recorder on; else None."""

from lbcore import program


def read(run):
    return program.mallocs_per_scan(run)
