"""The least time a kernel could take on one H100, from its shapes.

A frozen copy of ``chip_smoke.py``'s arithmetic (``_bound``, and its K6
and K9 rows): each input byte read once and each output byte written once
at the HBM rate, or the float32 operations at the rate outside the tensor
cores, whichever takes longer.  Peaks: NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

HBM_BPS = 3.35e12    # bytes/s
FP32_OPS = 67e12     # float32 operations/s outside the tensor cores

NS = 23              # error-state dimensions
XF = 26              # values of a navigation state


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" | "operations")."""
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * ops / FP32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def k6(n_match: int, k: int, iters: int = 1):
    """K6 (``fl_update_loop``, the whole iterated update in window mode):
    bytes and operations of one launch on ``n_match`` points with k
    neighbours.  It reads the window pack ((5 + 3W) channels of Np = n_match
    padded to 128, W = k + 7), P and the predicted state, and writes the
    state, P and an 8-value row; ~(540 + 8W) operations a point and an
    iteration and ~3e5 for the 23 × 23 update."""
    W = k + 7
    Np = n_match + (-n_match) % 128
    nbytes = 4 * ((5 + 3 * W) * Np + 2 * NS * NS + 2 * XF + 8)
    return nbytes, iters * ((540 + 8 * W) * Np + 3e5)


def k9(n: int):
    """K9 (``fl_sort3``): one sort of n int32 triples, read once and
    written once."""
    return 24 * n, 0.0
