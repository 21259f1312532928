"""Scans whose whole-loop update (K6) failed a certificate, so the exact
per-iteration loop's result was taken: the change of the program's device
counter ``iekf.counters.loop_fallbacks`` over the window, over the window's
scans."""


def read(run):
    n = len(run.window.scans)
    return run.fallbacks / n if n else None
