"""K6 (``fl_update_loop``): its least time at the window's shapes (the
frozen count of ``roofline/counts.py``) over its device time in the
profiled slice, in percent."""

from lbcore import readers
from roofline import counts


def read(run):
    m = run.cfg.ikfom.mapping
    return readers.roofline_pct(run, "fl_update_loop",
                                [counts.k6(m.MAX_NUM_PC2MATCH, m.NUM_MATCH_POINTS)])
