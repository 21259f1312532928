"""K9 (``fl_sort3*``), the two sorts of every scan (the voxel sort of the
scan's slots, then the insert's): their least time (``roofline/counts.py``)
over their device time in the profiled slice, in percent."""

from lbcore import readers
from roofline import counts


def read(run):
    t = run.cfg.tpu
    n_insert = t.max_insert_points or t.max_points_per_scan
    return readers.roofline_pct(run, "fl_sort3",
                                [counts.k9(t.max_points_per_scan), counts.k9(n_insert)])
