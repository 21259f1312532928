"""The frozen roofline counts against PERF.md's kernel table."""

from roofline import counts


def test_k6_at_the_main_path_shapes():
    # Np = 10 112 (10 000 points padded to 128), W = 12: 0.000496 ms (bytes)
    ms, by = counts.bound_ms(*counts.k6(10_000, 5, iters=4))
    assert by == "bytes" and round(ms, 6) == 0.000496


def test_k9_at_2_18():
    ms, by = counts.bound_ms(*counts.k9(2 ** 18))
    assert by == "bytes" and round(ms, 4) == 0.0019
    # the main path's two sorts (PERF.md: 0.000235 and 7.16e-05 ms)
    assert round(counts.bound_ms(*counts.k9(32768))[0], 6) == 0.000235
    assert round(counts.bound_ms(*counts.k9(10000))[0], 7) == 7.16e-05
