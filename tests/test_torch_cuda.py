"""The Hopper kernels against their plain versions on the card, at small
shapes.  Needs a CUDA device (and nvcc to build the kernels); skips
otherwise.  Imports only torch and the port, so it runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is called through its public wrapper and held elementwise to
its plain version, |kernel − plain| ≤ atol + rtol·|plain|, with the
tolerances of chip_smoke.py: K1 rtol 1e-4/atol 2e-4; K2 sq and valid
bit-equal; K3 gate agreement ≥ 99.5 %, n_abcd rtol 5e-3/atol 5e-4; K4
rtol 1e-5 of each entry's sum of term magnitudes (Σ|HᵢHⱼ|: the two sides
sum the same float32 products in different orders); K5 x atol 1e-4 +
rtol 1e-3, P atol 1e-3 + rtol 1e-3; K6 x and P atol 2e-4 + rtol 1e-3 with
n_iters, ok and the stale count exact; K7 (the dense entry, C up to
211 000, and the map-table entry at 3 m and at the 13³-block radius) and
K2 (every schedule at k = 1 … 128, V = 8 and 27; an overflowing warp list;
NaN and overflowing distances; the select entry at each branch) sq, valid
and nbrs bit-equal, invalid tail included; K1
on stacked frames and on the scan step's two row sources; K9 bit-equal through
both routes (the cluster kernel to the switch, the grid kernel above it to 2^22, and
each route named at 1 … 2^17); K8 against float64 truth within
12× the float32 library solve's error + 2e-5 of the largest entry (the rule
of tests/test_gain.py; likewise against 12× its plain version's error) and
to its plain version within rtol 1e-3 + 1e-3 of the largest entry on the
cases of up to three decades (the plain version's products are library
matmuls: the same float32 terms summed in another order, through an
ill-conditioned 12×12 solve; at 4.5 decades two float32 algorithms part by
more than that while both stay near truth).  K4 at Np 128 … 65536 and K6 at
N 1 … 40000 (with and without the dynamic gate) on random inputs, each also
bit-equal on two launches.  K5 is held bit for bit, and K6 at its
tolerances, to outputs recorded before the gain moved into
``csrc/gain.cuh`` (``tests/data/torch_k5k6_golden.npz``;
``python tests/test_torch_cuda.py --write-golden <path>`` records such a
file from whatever package is importable); the one-cluster K6 (eight
settings), K8 (four cases) and K5 (six more inputs) bit for bit to the
outputs the one-cluster K6 tree recorded before the body's schedule
changed (``tests/data/torch_k6_cluster_golden.npz``; ``--write-cluster-golden
<path>``).  K3's select entry is bit for bit the merge of three one-set
launches at every branch code.  Also: the Localizer lands on
the card by default, a checkpoint round trip on the card, and the split
transfer (payload copied on a side stream at arrival) gives the
trajectory of synchronous copies bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fast_limo_tpu_torch.models import iekf, mapper, measurement
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import (deskew_kernel, gain, hstats, knn, knn_rows, plane_kernel,
                                     sort, update_body, update_loop)
from fast_limo_tpu_torch.utils import presets

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, rtol, atol, scale=None):
    """Elementwise |got − want| ≤ atol + rtol·scale (scale = |want| unless
    given), as numpy's assert_allclose."""
    assert got.shape == want.shape
    d = (got.double() - want.double()).abs()
    bound = atol + rtol * (want.double().abs() if scale is None else scale.double())
    assert bool((d <= bound).all()), float((d - bound).max())


def _once(wrapper, call):
    """``call()`` through a public wrapper; it must launch exactly once."""
    n0 = wrapper.launches
    out = call()
    assert wrapper.launches == n0 + 1
    return out


@pytest.fixture(scope="module")
def scan(dev):
    """One scan of a small bench replay on the card: the kernels' inputs."""
    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 4096
    cfg.tpu.map_capacity = 16384
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 1500
    cfg.tpu.max_insert_points = 1500
    from fast_limo_tpu_torch.models.localizer import Localizer

    loc = Localizer(cfg, device=dev)
    cap = {}
    orig = measurement.make_h_model

    def grab(*a, **kw):
        cap["h"] = orig(*a, **kw)
        return cap["h"]

    measurement.make_h_model = grab
    try:
        presets.replay(loc, presets.bench_sequence(n_scans=6, points_per_scan=4096))
    finally:
        measurement.make_h_model = orig
    return cfg, cap["h"], loc


@pytest.mark.parametrize("K,n_valid", [(9, 7), (33, 27)])
def test_k1_deskew(dev, K, n_valid):
    """K1 on stacked frames and on the scan step's two sources (a carry-in
    row, then a window whose bg/ba/grav are broadcast with row stride 0),
    with a regressed stamp and invalid frames: within rtol 1e-4 / atol 2e-4
    of deskew_plain on the table and scalars built in plain torch, the two
    forms bit-equal.  (Its one CUDA kernel a call is counted by
    chip_smoke.py's phase 5: a torch.profiler session this early in the
    file made the profiles of test_k9_sort3, late in it, miss their
    kernel.)"""
    rng = np.random.default_rng(K)
    N = 3000
    f = {k: torch.tensor(np.float32(rng.normal(size=(K, 3))), device=dev)
         for k in ("pos", "vel", "bg", "ba", "w", "a")}
    q = rng.normal(size=(K, 4))
    from fast_limo_tpu_torch.models.deskew import Frames

    times = np.float32(np.sort(rng.uniform(0, 0.1, K)))
    times[5] = times[2] - 0.005                 # a regressed IMU stamp
    fr = Frames(time=torch.tensor(times, device=dev),
                rot=torch.tensor(np.float32(q / np.linalg.norm(q, axis=1, keepdims=True)),
                                 device=dev),
                grav=torch.tensor([[0.0, 0.0, -9.81]] * K, device=dev),
                valid=torch.arange(K, device=dev) < n_valid, **f)
    for name in ("bg", "ba", "grav"):           # constant over the window
        row = getattr(fr, name)[1]
        fr = fr._replace(**{name: torch.cat([getattr(fr, name)[:1], row.expand(K - 1, 3)])})
    srcs = (Frames(*[a[:1] for a in fr]),
            Frames(*[a[1:] for a in fr])._replace(
                bg=fr.bg[1].expand(K - 1, 3), ba=fr.ba[1].expand(K - 1, 3),
                grav=fr.grav[1].expand(K - 1, 3)))
    pts = torch.tensor(np.float32(rng.uniform(-30, 30, (N, 3))), device=dev)
    t = torch.tensor(np.float32(rng.uniform(-0.01, 0.12, N)), device=dev)
    valid = torch.tensor(rng.random(N) < 0.9, device=dev)
    F = deskew_kernel.frame_table(fr)
    sc = deskew_kernel._scalars(fr.rot[0], fr.pos[0], fr.rot[1], fr.pos[1])
    want = deskew_kernel.deskew_plain(pts, t, valid, F, sc)
    outs = []
    for frames in (fr, srcs):
        def call():
            return deskew_kernel.deskew(pts, t, valid, frames, fr.rot[1], fr.pos[1], fr.rot[0],
                                        fr.pos[0])

        outs.append(_once(deskew_kernel.deskew, call))
        for a, b in zip(outs[-1], want):
            _close(a, b, 1e-4, 2e-4)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_k2_k3_k4_on_a_scan(scan):
    cfg, h, _ = scan
    row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    rows, _, _ = mapper.gather_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    for k in (5, 12):
        a = _once(knn_rows.topk_from_table, lambda: knn_rows.topk_from_table(
            h.m.ptable, row_idx, ncb, h.glob0, E=mapper.E, B=h.m.bucket, k=k))
        b = knn_rows.topk_from_rows_reference(rows, ncb, h.glob0, E=mapper.E,
                                              B=h.m.bucket, k=k)
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        assert torch.equal(a[0][b[2]], b[0][b[2]])
    nb, sq = h._window_rank(h.glob0)
    vl = torch.isfinite(sq)
    kw = dict(num_match_points=5, max_dist_plane=2.0, plane_threshold=0.1)
    a = _once(plane_kernel.fit_planes, lambda: plane_kernel.fit_planes(nb, sq, vl, **kw))
    b = plane_kernel.fit_planes_plain(nb, sq, vl, **kw)
    assert float((a[1] == b[1]).float().mean()) >= 0.995
    both = a[1] & b[1]
    _close(a[0][both], b[0][both], 5e-3, 5e-4)
    X = hstats.pack_inputs(h.pc, a[0], a[1])
    sc = hstats.pack_scalars(scan[2].state.x)
    Np = X.shape[0] // 8
    for ee in (True, False):
        ga = _once(hstats.hstats, lambda: hstats.hstats(X, sc, estimate_extrinsics=ee))
        gb = hstats.hstats_plain(X, sc, estimate_extrinsics=ee)
        cols, hneg = hstats.h_rows(tuple(X[i * Np:(i + 1) * Np] for i in range(8)), sc,
                                   estimate_extrinsics=ee)
        Ha = torch.stack(cols, dim=-1).double().abs()
        _close(ga[0], gb[0], 1e-5, 0.0, scale=Ha.T @ Ha)
        _close(ga[1], gb[1], 1e-5, 0.0, scale=Ha.T @ hneg.double().abs())


def test_k2_table_entry_and_active_flags_on_a_scan(scan):
    """K2 (map table + row indices) bit-equal to its plain version on the
    gathered rows; K2, K3, K4 and K5 with a set flag give the bits of no
    flag, and with a clear one launch, return and leave the card usable."""
    cfg, h, loc = scan
    on = torch.ones((), dtype=torch.bool, device=h.pc.device)
    off = torch.zeros((), dtype=torch.bool, device=h.pc.device)
    row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    rows, _, _ = mapper.gather_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    kw = dict(E=mapper.E, B=h.m.bucket, k=5)
    plain = knn_rows.topk_from_rows_reference(rows, ncb, h.glob0, **kw)
    want = None
    for flag in (None, on):
        got = _once(knn_rows.topk_from_table, lambda: knn_rows.topk_from_table(
            h.m.ptable, row_idx, ncb, h.glob0, **kw, active=flag))
        assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
        assert torch.equal(got[0][plain[2]], plain[0][plain[2]])
        want = want or got
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    nb, sq = h._window_rank(h.glob0)
    fkw = dict(num_match_points=5, max_dist_plane=2.0, plane_threshold=0.1)
    fit = plane_kernel.fit_planes(nb, sq, torch.isfinite(sq), **fkw)
    X = hstats.pack_inputs(h.pc, *fit)
    sc = hstats.pack_scalars(loc.state.x)
    HTH, HTh = hstats.hstats(X, sc, estimate_extrinsics=True)
    x, P = loc.state.x, loc.state.P
    xi = st.boxplus(x, torch.full((23,), 1e-3, device=P.device))
    body = update_body.update_body(HTH, HTh, P, xi, x, 1e-3, 5.0)
    calls = [
        (knn_rows.topk_from_table, lambda f: knn_rows.topk_from_table(
            h.m.ptable, row_idx, ncb, h.glob0, **kw, active=f), want),
        (plane_kernel.fit_planes, lambda f: plane_kernel.fit_planes(
            nb, sq, torch.isfinite(sq), **fkw, active=f), fit),
        (hstats.hstats, lambda f: hstats.hstats(X, sc, estimate_extrinsics=True, active=f),
         (HTH, HTh)),
        (update_body.update_body, lambda f: update_body.update_body(
            HTH, HTh, P, xi, x, 1e-3, 5.0, active=f), body)]
    for wrapper, call, ref in calls:
        _once(wrapper, lambda: call(off))
        torch.cuda.synchronize()
        got = _once(wrapper, lambda: call(on))
        flat = lambda o: [t for v in o for t in (st.as_vector(v) if isinstance(v, st.NavState)
                                                 else v,)]
        assert all(torch.equal(g, w) for g, w in zip(flat(got), flat(ref))), wrapper.__name__


def _k4_case(dev, Np, seed=0):
    """A random statistics pack of Np points (planes of unit normals, 90 %
    kept) and a random pose."""
    rng = np.random.default_rng(seed + Np)
    pc = torch.tensor(np.float32(rng.uniform(-30, 30, (Np, 3))), device=dev)
    nrm = rng.normal(size=(Np, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nd = torch.tensor(np.float32(np.c_[nrm, rng.uniform(-20, 20, Np)]), device=dev)
    keep = torch.tensor(rng.random(Np) < 0.9, device=dev)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sc = np.float32(np.r_[q[0], rng.normal(size=3), q[1], rng.normal(size=3) * 0.1])
    return hstats.pack_inputs(pc, nd, keep), torch.tensor(sc, device=dev)


@pytest.mark.parametrize("Np", [128, 4096, 10112, 65536])
@pytest.mark.parametrize("ee", [True, False])
def test_k4_hstats(dev, Np, ee):
    """K4 (one cluster, one kernel) against its plain version by the
    Σ|terms| rule, and bit-equal on two launches."""
    X, sc = _k4_case(dev, Np)
    a = _once(hstats.hstats, lambda: hstats.hstats(X, sc, estimate_extrinsics=ee))
    again = hstats.hstats(X, sc, estimate_extrinsics=ee)
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])
    b = hstats.hstats_plain(X, sc, estimate_extrinsics=ee)
    cols, hneg = hstats.h_rows(tuple(X[i * Np:(i + 1) * Np] for i in range(8)), sc,
                               estimate_extrinsics=ee)
    Ha = torch.stack(cols, dim=-1).double().abs()
    _close(a[0], b[0], 1e-5, 0.0, scale=Ha.T @ Ha)
    _close(a[1], b[1], 1e-5, 0.0, scale=Ha.T @ hneg.double().abs())
    assert torch.equal(a[0], a[0].T)


def _k6(pack, P, x, win, max_iters):
    return update_loop.update_loop(pack, P, x, 1e-3, 5.0, 1e-3, max_iters=max_iters,
                                   estimate_extrinsics=True, window=win, with_aux=True)


def _ulps(margin, kth_d):
    """|margin| in float32 spacings at kth_d (the certificate's scale)."""
    kth_d = kth_d.float()
    step = torch.nextafter(kth_d, torch.full_like(kth_d, float("inf"))) - kth_d
    return (margin.abs() / step).double()


@pytest.mark.parametrize("N", [1, 1000, 10000, 40000])
@pytest.mark.parametrize("gate", [0.0, 4.0])
def test_k6_update_loop(dev, N, gate):
    """K6 (one cluster) against its plain version at rtol 1e-3 / atol 2e-4
    with n_iters and ok equal, and bit-equal on two launches; the
    MAX_NUM_MATCHES cap (5000) binds from N = 10000 on, so its prefix
    count crosses blocks.  The stale count is exact against the plain
    certificates at K6's OWN iterates: K6's count at iteration j is the
    difference of its totals with max_iters = j and j − 1 (the iterations
    before the last are the same in every launch), and its iterate there
    is where the launch with max_iters = j − 1 ends.  Against the plain
    version's own run the totals may differ at large N, because the two
    float32 iterates part by summation order after the first update; the
    queries that then differ are printed with their certificate margins
    in float32 spacings (run with -s)."""
    pack, P, x, win, _, _ = _golden_inputs(dev, N=N, gate=gate)
    kw = dict(max_iters=3, estimate_extrinsics=True, window=win)

    def k6():
        out = _k6(pack, P, x, win, 3)
        return st.as_vector(out[0]), out[1], out[6]

    a = _once(update_loop.update_loop, k6)
    again = k6()
    assert all(torch.equal(u, v) for u, v in zip(a, again))
    b = update_loop.update_loop_plain(pack, P, x, 1e-3, 5.0, 1e-3, **kw)
    _close(a[0], st.as_vector(b[0]), 1e-3, 2e-4)
    _close(a[1], b[1], 1e-3, 2e-4)
    assert a[2][[0, 1]].tolist() == b[2][[0, 1]].tolist()
    total = 0
    for j in range(1, int(a[2][0])):
        prev, cur = _k6(pack, P, x, win, j - 1), _k6(pack, P, x, win, j)
        assert int(prev[6][0]) == j
        count = int(cur[6][4] - prev[6][4])
        stale, ma, mb, kd = update_loop.window_stale(pack, x, prev[0], window=win)
        assert count == int(stale.sum()), (N, gate, j, count, int(stale.sum()))
        total += count
        # the plain version's own iterate j and the queries whose verdict moves
        xp = update_loop.update_loop_plain(pack, P, x, 1e-3, 5.0, 1e-3, max_iters=j - 1,
                                           estimate_extrinsics=True, window=win)[0]
        sp, mpa, mpb, _ = update_loop.window_stale(pack, x, xp, window=win)
        moved = (sp != stale).nonzero().flatten()
        if len(moved):
            scale = kd[moved].clamp(min=1e-3)
            ua = _ulps(torch.minimum(ma.abs(), mpa.abs())[moved], scale)
            ub = _ulps(torch.minimum(mb.abs(), mpb.abs())[moved], scale)
            print(f"K6 stale N={N} gate={gate} iteration {j}: K6 {count}, plain run "
                  f"{int(sp.sum())}; {len(moved)} queries differ, min(|margin_a|, |margin_b|) "
                  f"{torch.minimum(ua, ub).max().item():.1f} spacings at most "
                  f"(margin_a {ua.min().item():.1f}-{ua.max().item():.1f}, margin_b "
                  f"{ub.min().item():.1f}-{ub.max().item():.1f}; |dx| between the iterates "
                  f"{(st.as_vector(xp) - st.as_vector(prev[0])).abs().max().item():.3e})")
    assert total == int(a[2][4])


def test_k5_k6_on_a_scan(scan):
    cfg, h, loc = scan
    x, P = loc.state.x, loc.state.P
    win_kw = dict(max_iters=3, estimate_extrinsics=True, window=h.loop_window)
    a = _once(update_loop.update_loop, lambda: update_loop.update_loop(
        h.loop_pack, P, x, 1e-3, 5.0, 1e-3, **win_kw, with_aux=True))
    a = (a[0], a[1], a[6])
    b = update_loop.update_loop_plain(h.loop_pack, P, x, 1e-3, 5.0, 1e-3, **win_kw)
    assert a[2][[0, 1, 4]].tolist() == b[2][[0, 1, 4]].tolist()
    _close(st.as_vector(a[0]), st.as_vector(b[0]), 1e-3, 2e-4)
    _close(a[1], b[1], 1e-3, 2e-4)
    n0 = iekf.counters.host_syncs
    HTH, HTh = h.stats(x)
    assert iekf.counters.host_syncs == n0          # the re-match branch is chosen on the card
    xi = st.boxplus(x, torch.full((23,), 1e-3, device=P.device))
    ka = _once(update_body.update_body,
               lambda: update_body.update_body(HTH, HTh, P, xi, x, 1e-3, 5.0))
    kb = update_body.update_body_plain(HTH, HTh, P, xi, x, 1e-3, 5.0)
    _close(st.as_vector(ka[0]), st.as_vector(kb[0]), 1e-3, 1e-4)
    _close(ka[1], kb[1], 1e-3, 1e-3)


def test_voxel_and_insert_match_cpu_bitwise(dev):
    """The plain tensor stages between the kernels: voxel sets and map
    tables on the card equal the CPU ones bit for bit (true division for
    keys, sequential segment sums, no float atomics)."""
    from fast_limo_tpu_torch.ops import voxel

    rng = np.random.default_rng(3)
    pts = np.float32(rng.uniform(-20, 20, (20000, 3)))
    pts[::5] = pts[::5].round(1)
    valid = rng.random(20000) < 0.9
    for leaf in (1.0, 0.3):
        a = voxel.voxel_downsample(torch.tensor(pts, device=dev),
                                   torch.tensor(valid, device=dev), leaf)
        b = voxel.voxel_downsample(torch.tensor(pts), torch.tensor(valid), leaf)
        assert torch.equal(a[1].cpu(), b[1]) and torch.equal(a[0].cpu(), b[0])
    m_d, m_c = mapper.create(16384, 6, dev), mapper.create(16384, 6)
    for i in range(3):
        p = np.float32(pts[i * 5000:(i + 1) * 5000] * 0.3)
        m_d = mapper.insert(m_d, torch.tensor(p, device=dev),
                            torch.ones(5000, dtype=torch.bool, device=dev), voxel_size=1.2)
        m_c = mapper.insert(m_c, torch.tensor(p), torch.ones(5000, dtype=torch.bool),
                            voxel_size=1.2)
    assert torch.equal(m_d.table.cpu(), m_c.table) and torch.equal(m_d.ptable.cpu(), m_c.ptable)


def test_replay_is_deterministic(dev, scan):
    """A second replay of the same scans on the card gives the same
    trajectory bit for bit."""
    from fast_limo_tpu_torch.models.localizer import Localizer

    cfg, _, loc = scan
    again = Localizer(cfg, device=dev)
    presets.replay(again, presets.bench_sequence(n_scans=6, points_per_scan=4096))
    np.testing.assert_array_equal(again.positions(), loc.positions())


@pytest.mark.parametrize("N,C,k,frac,ties", [
    (100, 81, 5, 0.7, False), (8, 81, 5, 0.0, False), (64, 1500, 64, 0.02, False),
    (64, 1500, 64, 0.7, True), (381, 12000, 16, 0.7, False), (21, 25000, 128, 0.3, False),
    (381, 12000, 16, 0.09, False), (4, 211000, 16, 0.9, False), (3, 211000, 128, 0.9, True)])
def test_k7_masked_topk(dev, N, C, k, frac, ties):
    """sq, valid and nbrs bit-equal to the plain stable sort, invalid tail
    included; C = 211 000 mostly valid overflows the shared capacity (the
    kernel's global path)."""
    rng = np.random.default_rng(N + C + k)
    pts = np.float32(rng.normal(size=(N, C, 3)) * 3)
    q = np.float32(rng.normal(size=(N, 3)))
    if ties:                                   # many equal distances
        pts, q = np.round(pts), np.round(q)
    args = [torch.tensor(a, device=dev) for a in (pts, rng.random((N, C)) < frac, q)]
    a = _once(knn.masked_topk, lambda: knn.masked_topk(*args, k=k))
    b = knn.masked_topk_reference(*args, k=k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the same mask in a contiguous view 3 bytes off a 16-byte boundary
    buf = torch.zeros(N * C + 3, dtype=torch.bool, device=dev)
    mask3 = buf[3:].view(N, C)
    mask3.copy_(args[1])
    a = knn.masked_topk(args[0], mask3, args[2], k=k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _replay_queries(m, n, seed):
    """n queries near stored points of map m (on its device)."""
    from fast_limo_tpu_torch.utils import checkpoint

    stored = checkpoint.map_points(m)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(stored), n, replace=len(stored) < n)
    return torch.tensor(np.float32(stored[pick] + rng.uniform(-0.5, 0.5, (n, 3))),
                        device=m.ptable.device)


@pytest.mark.parametrize("radius,n,k,cap", [(3.0, 500, 16, knn.CAP), (3.0, 64, 128, knn.CAP),
                                           (3.0, 200, 16, 200), (14.0, 24, 16, knn.CAP)])
def test_k7_table_entry_on_a_replayed_map(scan, monkeypatch, radius, n, k, cap):
    """The table entry bit-equal to its plain version (gather →
    cands_from_rows → plain top-k) at 3 m (5³ blocks) and at the 13³-block
    radius, and with a shared capacity of 200 entries (most queries take
    the kernel's global path); radius_search's wide branch launches it
    once and nothing else of K7."""
    monkeypatch.setattr(knn, "CAP", cap)
    cfg, _, loc = scan
    m, vox = loc.state.map, cfg.map_voxel_size
    q = _replay_queries(m, n, int(radius))
    mb = int(np.ceil(radius / (2 * vox) - 1e-9))
    ncb = (mapper.block_coords(mapper.voxel_coords(q, vox))[:, None, :]
           + mapper._block_offsets(mb, q.device)[None])
    row_idx, ncb = mapper._hash(ncb, m.groups).to(torch.int32), ncb.to(torch.int32)
    kw = dict(E=mapper.E, B=m.bucket, k=k)
    a = _once(knn.masked_topk_from_table, lambda: knn.masked_topk_from_table(
        m.ptable, row_idx, ncb, q, **kw))
    b = knn.masked_topk_from_table_reference(m.ptable, row_idx, ncb, q, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    n7, nt = knn.masked_topk.launches, knn.masked_topk_from_table.launches
    res = mapper.radius_search(m, q, radius, voxel_size=vox, max_results=k)
    assert knn.masked_topk.launches == n7 and knn.masked_topk_from_table.launches == nt + 1
    inside = a[2] & (a[1] <= radius * radius)
    assert torch.equal(res[2], inside) and torch.equal(res[1][inside], a[1][inside])


def _k2_modes(k):
    """Every schedule of K2 that takes k."""
    return ["block"] + (["warp_min", "warp_radix"] if k <= knn_rows.WARP_KMAX else [])


def _k2_diff(got, want):
    """None if K2's outputs are bit-equal (a NaN distance equal to a NaN),
    else the first query that differs, with both rows."""
    same = torch.ones(want[1].shape[0], dtype=torch.bool, device=want[1].device)
    for g, w in zip(got, want):
        both_nan = torch.isnan(g) & torch.isnan(w) if g.is_floating_point() else torch.zeros_like(g)
        eq = (g == w) | both_nan
        same &= eq.reshape(eq.shape[0], -1).all(1)
    if bool(same.all()):
        return None
    i = int(torch.nonzero(~same)[0])
    return i, [t[i].tolist() for t in got], [t[i].tolist() for t in want]


@pytest.mark.parametrize("V", [8, 27])
@pytest.mark.parametrize("k", [1, 5, 12, 16, 32, 64, 128])
def test_k2_bit_equal_at_k(scan, V, k):
    """K2's table entry bit-equal to its plain version in sq, valid and
    nbrs, invalid tail included: the schedule the wrapper picks and every
    other schedule that takes k."""
    _, h, _ = scan
    row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size,
                                        neighborhood=8 if V == 8 else -27)
    kw = dict(E=mapper.E, B=h.m.bucket, k=k)
    a = _once(knn_rows.topk_from_table, lambda: knn_rows.topk_from_table(
        h.m.ptable, row_idx, ncb, h.glob0, **kw))
    b = knn_rows.topk_from_table_reference(h.m.ptable, row_idx, ncb, h.glob0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for mode in _k2_modes(k):
        a = knn_rows._launch(h.m.ptable, row_idx, ncb, h.glob0, None, **kw, mode=mode)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), mode


@pytest.mark.parametrize("V", [8, 27])
def test_k2_overflowing_warp_list_takes_the_exact_path(scan, monkeypatch, V):
    """A warp list of 8 entries: every query with more valid columns takes
    the warp's exact path over all columns, with the same bits."""
    monkeypatch.setattr(knn_rows, "warp_cap", lambda V, B: 8)
    _, h, _ = scan
    row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size,
                                        neighborhood=8 if V == 8 else -27)
    for k in (5, 32):
        kw = dict(E=mapper.E, B=h.m.bucket, k=k)
        b = knn_rows.topk_from_table_reference(h.m.ptable, row_idx, ncb, h.glob0, **kw)
        assert int(torch.isfinite(b[1]).sum(1).max()) == k
        for mode in ("warp_min", "warp_radix"):
            a = knn_rows._launch(h.m.ptable, row_idx, ncb, h.glob0, None, **kw, mode=mode)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (mode, k)


@pytest.mark.parametrize("value", [float("nan"), 1e30])
def test_k2_nonfinite_valid_column(scan, value):
    """A filled slot of a kept entry at NaN or an overflowing distance, in
    the first filled row of every tenth query: every schedule gives the
    plain stable sort (NaN after +inf, +inf among the invalid columns by
    column)."""
    _, h, _ = scan
    row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    ptab = h.m.ptable.clone()
    rows = ptab[row_idx.long()]
    cand, cval = mapper.cands_from_rows(rows, ncb, None, h.m.bucket)
    N = row_idx.shape[0]
    cval = cval.reshape(N, -1)
    hit = 0
    for i in range(0, N, 10):
        cols = torch.nonzero(cval[i])
        if len(cols):
            c = int(cols[0])
            v, r = divmod(c, mapper.E * h.m.bucket)
            ptab[int(row_idx[i, v]), 4 * mapper.E + r] = value
            hit += 1
    assert hit > 10
    for k in (5, 12, 64):
        kw = dict(E=mapper.E, B=h.m.bucket, k=k)
        b = knn_rows.topk_from_table_reference(ptab, row_idx, ncb, h.glob0, **kw)
        for mode in _k2_modes(k):
            a = knn_rows._launch(ptab, row_idx, ncb, h.glob0, None, **kw, mode=mode)
            assert _k2_diff(a, b) is None, (mode, k, _k2_diff(a, b))


def test_k2_select_entry_branches(scan):
    """The select entry (one launch) at branch codes 0/1/2 and under a clear
    flag: the taken branch bit-equal to the two-call composition (K2 on the
    idx rows, K2 on every query); one launch a call."""
    _, h, _ = scan
    glob = h.glob0
    row_idx, ncb = h._rows(glob)[:2]
    kw = dict(E=mapper.E, B=h.m.bucket, k=h.k)
    stale = h.pc_valid & (torch.cumsum(h.pc_valid.to(torch.int32), 0) <= h.budget // 2)
    idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:h.budget]
    want = (knn_rows.topk_from_table(h.m.ptable, row_idx[idx], ncb[idx], glob[idx], **kw),
            knn_rows.topk_from_table(h.m.ptable, row_idx, ncb, glob, **kw))
    on = torch.ones((), dtype=torch.bool, device=glob.device)
    off = torch.zeros((), dtype=torch.bool, device=glob.device)
    for v, taken, flag in ((0, None, None), (int(stale.sum()), 0, None), (h.budget, 0, on),
                           (h.budget + 1, 1, None), (h.budget + 1, 1, on), (1, None, off)):
        viol = torch.tensor(v, dtype=torch.int32, device=glob.device)
        got = _once(knn_rows.topk_from_table, lambda: knn_rows.topk_from_table_select(
            h.m.ptable, row_idx, ncb, glob, idx, viol, **kw, active=flag))
        torch.cuda.synchronize()
        assert got[0][0].shape == want[0][0].shape and got[1][0].shape == want[1][0].shape
        if taken is not None:
            assert all(torch.equal(x, y) for x, y in zip(got[taken], want[taken])), v


def test_k2_at_k64_on_a_scan(scan):
    _, h, _ = scan
    for nbh in (8, -27):
        row_idx, ncb, _ = mapper.block_rows(h.m, h.glob0, voxel_size=h.voxel_size,
                                            neighborhood=nbh)
        rows, _, _ = mapper.gather_rows(h.m, h.glob0, voxel_size=h.voxel_size, neighborhood=nbh)
        for k in (17, 64, 128):
            a = _once(knn_rows.topk_from_table, lambda: knn_rows.topk_from_table(
                h.m.ptable, row_idx, ncb, h.glob0, E=mapper.E, B=h.m.bucket, k=k))
            b = knn_rows.topk_from_rows_reference(rows, ncb, h.glob0, E=mapper.E,
                                                  B=h.m.bucket, k=k)
            assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            assert torch.equal(a[0][b[2]], b[0][b[2]])
    with pytest.raises(ValueError):
        knn_rows.topk_from_table(h.m.ptable, row_idx, ncb, h.glob0, E=mapper.E,
                                 B=h.m.bucket, k=129)


def test_localizer_defaults_to_the_card(dev):
    from fast_limo_tpu_torch.models.localizer import Localizer

    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 2048
    cfg.tpu.map_capacity = 8192
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 1000
    cfg.tpu.max_insert_points = 1000
    loc = Localizer(cfg)
    presets.replay(loc, presets.bench_sequence(n_scans=2, points_per_scan=2048))
    assert loc.state.P.device == torch.device("cuda", 0)
    assert loc.state.map.table.device == torch.device("cuda", 0)
    assert np.isfinite(loc.positions()).all()


def test_checkpoint_round_trip_on_the_card(scan, tmp_path):
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.utils import checkpoint

    cfg, _, loc = scan
    p = str(tmp_path / "ck.npz")
    loc.save_checkpoint(p)
    again = Localizer(cfg)
    again.load_checkpoint(p)
    flat = checkpoint._flatten_with_paths(loc.state)
    for key, v in checkpoint._flatten_with_paths(again.state).items():
        assert v.device == flat[key].device and torch.equal(v, flat[key]), key
    assert again.epoch == loc.epoch


def _cuda_kernels(fn, prefix, tries=6):
    """CUDA kernels named ``prefix*`` that one fn() call launches, as
    torch.profiler records them: the first of ``tries`` profiled calls that
    records one, else 0.  The profiler on the card now and then misses a
    kernel launched as a cluster or a cooperative grid whose launch the
    wrapper counted (chip_smoke.py's _cuda_launches has the same rule); a
    call that launches two kernels still reads 2."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.key.startswith(prefix))
        if n:
            return n
    return 0


def _k9_cases(N):
    """(name, k1, k2, v): the callers' forms (voxel: k2 = v = arange; insert:
    v = arange) and keys with INT32_MIN / INT32_MAX, all-equal keys, digits
    constant in every element, (k2, v) in order but v not, a repeated v,
    full-range keys, keys drawn from four values and keys that differ only
    in k1's top digit."""
    rng = np.random.default_rng(N)
    i32 = np.iinfo(np.int32)
    ar = np.arange(N, dtype=np.int32)
    k1 = rng.integers(-300, 300, N).astype(np.int32)
    k1[rng.random(N) < 0.2] = i32.max
    k1[rng.random(N) < 0.05] = i32.min
    k2 = rng.integers(i32.min, i32.max, N, endpoint=True).astype(np.int32)
    k2[rng.random(N) < 0.5] = 7
    full = rng.integers(i32.min, i32.max, N, endpoint=True).astype(np.int32)
    same = np.full(N, -5, np.int32)
    vr = rng.integers(-9, 9, N).astype(np.int32)
    kv = np.lexsort((vr, k2))
    four = np.array([-7, 0, 3, 1 << 30], np.int32)
    return [("voxel", np.where(rng.random(N) < 0.1, i32.max, full).astype(np.int32), ar, ar),
            ("insert", k1, k2, ar),
            ("repeated v", k1, k2, rng.integers(-2, 2, N).astype(np.int32)),
            ("all equal", same, same, same),
            ("constant digits", (full & 0x00FF00FF) | 0x12003400, same,
             ((full >> 3) & 0x0000FF00).astype(np.int32)),
            ("k2 v in order", rng.integers(0, 4, N).astype(np.int32), k2[kv], vr[kv]),
            ("full range", full, rng.permutation(full), rng.integers(i32.min, i32.max, N,
                                                                     dtype=np.int32)),
            ("four values", four[rng.integers(0, 4, N)], four[rng.integers(0, 4, N)],
             rng.permutation(N).astype(np.int32)),
            ("k1's top digit", ((rng.integers(0, 256, N) << 24) | 0x00123456).astype(np.int32),
             same, ar)]


@pytest.mark.parametrize("N", sorted({1, 127, 4096, 10000, 32768, 65536, 1 << 17,
                                      (1 << 17) + 1, 1 << 18, 1 << 20, 1 << 22,
                                      max(sort.CLUSTER_MAXN - 1, 1), sort.CLUSTER_MAXN,
                                      sort.CLUSTER_MAXN + 1}))
def test_k9_sort3(dev, N):
    """K9 against its plain version, all three outputs bit-equal, with one
    CUDA kernel a call: the cluster kernel up to the switch
    (``sort.CLUSTER_MAXN``), the grid kernel above it
    (``sort3.grid_launches`` counts the route)."""
    grid = N > sort.CLUSTER_MAXN
    for name, *ops in _k9_cases(N):
        args = [torch.tensor(a, device=dev) for a in ops]
        g0 = sort.sort3.grid_launches
        got = _once(sort.sort3, lambda: sort.sort3(*args))
        assert sort.sort3.grid_launches == g0 + int(grid), name
        for g, w in zip(got, sort.sort3_plain(*args)):
            assert g.shape == (N,) and torch.equal(g, w), name
    assert _cuda_kernels(lambda: sort.sort3(*args), "fl_sort3") == 1
    assert _cuda_kernels(lambda: sort.sort3(*args), "fl_sort3_grid") == int(grid)
    key, idx = args[0], torch.arange(N, dtype=torch.int32, device=dev)
    got = _once(sort.sort3, lambda: sort.sort_key_val(key, idx))
    want = sort.sort3_plain(key, idx, idx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[2])


@pytest.mark.parametrize("N", [1, 127, 2048, 2049, 10000, 32768, 65536, 98304, 1 << 17])
def test_k9_both_routes_at_the_crossover_sizes(dev, N):
    """Each route named explicitly (the crossover measurement's calls) at
    sizes both take: bit-equal to the plain version, one CUDA kernel a
    call, the grid route counted in ``sort3.grid_launches``."""
    for name, *ops in _k9_cases(N):
        args = [torch.tensor(a, device=dev) for a in ops]
        want = sort.sort3_plain(*args)
        for grid in (False, True):
            g0 = sort.sort3.grid_launches
            got = _once(sort.sort3, lambda: sort._launch(*args, grid=grid))
            assert sort.sort3.grid_launches == g0 + int(grid), name
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, grid)
    for grid, prefix in ((False, "fl_sort3_kernel"), (True, "fl_sort3_grid")):
        assert _cuda_kernels(lambda: sort._launch(*args, grid=grid), "fl_sort3") == 1
        assert _cuda_kernels(lambda: sort._launch(*args, grid=grid), prefix) == 1


def test_k9_refuses_what_it_does_not_take(dev):
    """Wrong type, a strided view, no element."""
    a = torch.arange(8, dtype=torch.int32, device=dev)
    for bad in ((a.long(), a, a), (a[::2], a[:4], a[:4]), (a[:0], a[:0], a[:0])):
        with pytest.raises(ValueError):
            sort.sort3(*bad)
    big = torch.arange(2 * (sort.CLUSTER_MAXN + 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):   # the grid route checks its operands alike
        sort.sort3(big[::2], big[1::2], big[::2])
    over = torch.arange(sort.CLUSTER_CAP + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most"):   # past the cluster's reach
        sort._launch(over, over, over, grid=False)


def test_split_transfer_matches_synchronous_copies(dev, scan):
    """The scan fixture's replay (int16 payloads copied on a side stream at
    arrival, IMU packs from pinned memory) against the same replay with
    blocking copies on the compute stream."""
    from fast_limo_tpu_torch.models.localizer import Localizer

    cfg, _, loc = scan
    assert cfg.tpu.quantize_transfer > 0 and loc._copy_stream is not None
    again = Localizer(cfg, device=dev)
    again._copy_stream = None
    presets.replay(again, presets.bench_sequence(n_scans=6, points_per_scan=4096))
    np.testing.assert_array_equal(again.positions(), loc.positions())


# ------------------------------------------------------------------- K8

def _gain_case(rng, n_rows=400, zero_dims=(), scale_decades=3.0, zero=False):
    """The statistics and covariance of tests/test_gain.py's cases."""
    col_scale = np.geomspace(1.0, 10.0 ** scale_decades, gain.M)
    H = rng.standard_normal((n_rows, gain.M)) * col_scale[None, :]
    for z in zero_dims:
        H[:, z] = 0.0
    r = rng.standard_normal(n_rows) * 0.1
    Q = rng.standard_normal((gain.NS, gain.NS))
    P = Q @ Q.T * 1e-4 + np.diag(np.geomspace(1e-6, 1.0, gain.NS))
    P = P + rng.standard_normal((gain.NS, gain.NS)) * 1e-9
    if zero:
        H, r, P = H * 0, r * 0, np.diag(np.geomspace(1e-6, 1.0, gain.NS))
    return H.T @ H, H.T @ r, P


GAIN_CASES = {"full_rank": {}, "zero_extrinsic_dims": {"zero_dims": range(6, 12)},
              "all_zero_measurements": {"zero": True}, "wide_dynamic_range": {"scale_decades": 4.5}}


@pytest.mark.parametrize("name", list(GAIN_CASES))
def test_k8_gain(dev, name):
    HTH, HTh, P = _gain_case(np.random.default_rng(42), **GAIN_CASES[name])
    R = 1e-3
    a32 = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (HTH, HTh, P)]
    got = _once(gain.gain, lambda: gain.gain(*a32, R))
    plain = gain.gain_math(a32[0], a32[1], a32[2][:, :gain.M].contiguous(),
                           torch.tensor(1.0 / R, device=dev))
    lib = gain.gain_reference(*a32, R)
    truth = gain.gain_reference(*[torch.tensor(a, dtype=torch.float64, device=dev)
                                  for a in (HTH, HTh, P)], R)
    for g, p, l, t in zip(got, plain, lib, truth):
        assert g.shape == p.shape and g.dtype == torch.float32
        if name == "all_zero_measurements":
            assert not bool(g.any())
            continue
        s = float(t.abs().max()) + 1e-12
        e_lib = float((l.double() - t).abs().max()) / s
        assert float((g.double() - t).abs().max()) / s <= 12.0 * e_lib + 2e-5
        e_plain = float((p.double() - t).abs().max()) / s
        assert float((g.double() - t).abs().max()) / s <= 12.0 * e_plain + 2e-5
        if name != "wide_dynamic_range":
            _close(g, p, 1e-3, 1e-3 * float(p.abs().max()))


def test_k8_refuses_what_it_does_not_take(dev):
    HTH, HTh, P = [torch.tensor(a, dtype=torch.float32, device=dev)
                   for a in _gain_case(np.random.default_rng(0))]
    n0 = gain.gain.launches
    bad = [(HTH[:11, :11], HTh, P), (HTH, HTh[:11], P), (HTH, HTh, torch.zeros(23, 12, device=dev)),
           (HTH.double(), HTh, P), (HTH, HTh, P.double()), (HTH.T, HTh, P),
           (HTH, HTh, P.T), (HTH.cpu(), HTh, P)]
    for args in bad:
        with pytest.raises(ValueError):
            gain.gain(*args, 1e-3)
    assert gain.gain.launches == n0


# ------------------------------------------------- K5 / K6 golden outputs

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_k5k6_golden.npz")


def _golden_inputs(dev, N=1024, gate=0.0):
    """Deterministic K5/K6 inputs made on the host: a window pack of N
    queries on three noisy walls around the origin, a filter-like P (the
    golden file's at the defaults)."""
    rng = np.random.default_rng(5)
    W = 12
    pc = np.float32(rng.uniform(-15, 15, (N, 3)))
    axis = rng.integers(0, 3, N)
    pc[np.arange(N), axis] = np.float32(np.where(rng.random(N) < 0.5, -12.0, 12.0))
    nb = pc[:, None, :] + np.float32(rng.normal(0, 0.25, (N, W, 3)))
    nb[np.arange(N), :, axis] = pc[np.arange(N), None, axis] + np.float32(
        rng.normal(0, 0.01, (N, W)))
    order = np.argsort(((nb - pc[:, None]) ** 2).sum(-1), axis=1)
    nb = np.take_along_axis(nb, order[..., None], 1)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    pack = update_loop.pack_window(t(pc), t(rng.random(N) < 0.95, torch.bool), t(nb),
                                   torch.ones((N, W), dtype=torch.bool, device=dev),
                                   torch.full((N,), W, dtype=torch.int32, device=dev))
    Q = rng.standard_normal((23, 23))
    P = t(Q @ Q.T * 1e-5 + np.diag(np.geomspace(1e-6, 1e-2, 23)))
    x = st.identity(torch.float32, gravity=9.81, device=dev)
    x = x._replace(pos=t([0.05, -0.03, 0.02]), vel=t([1.0, 0.2, 0.0]))
    win = update_loop.Window(k=5, W=W, voxel_size=1.2, max_dist_plane=2.0,
                             plane_threshold=0.1, max_num_matches=5000, dynamic_gate=gate)
    H = rng.standard_normal((400, 12)) * np.geomspace(1.0, 100.0, 12)[None, :]
    return pack, P, x, win, t(H.T @ H), t(H.T @ (rng.standard_normal(400) * 0.1))


def _golden_outputs(dev):
    pack, P, x, win, HTH, HTh = _golden_inputs(dev)
    out = {}
    for ee in (True, False):
        xk, Pk, nit, ok, g, me = update_loop.update_loop(
            pack, P, x, 1e-3, 5.0, 1e-3, max_iters=3, estimate_extrinsics=ee, window=win)
        out.update({f"k6_{int(ee)}_x": st.as_vector(xk), f"k6_{int(ee)}_P": Pk,
                    f"k6_{int(ee)}_s": torch.stack([nit.float(), ok.float(), g, me])})
    xi = st.boxplus(x, torch.full((23,), 1e-3, device=dev))
    xn, Pf, dxo, gm, me = update_body.update_body(HTH, HTh, P, xi, x, 1e-3, 5.0)
    out.update(k5_x=st.as_vector(xn), k5_P=Pf, k5_dx=dxo, k5_s=torch.stack([gm, me]))
    return {k: v.cpu().numpy() for k, v in out.items()}


def test_k5_bit_equal_to_golden(dev):
    """K5's body is the recorded one: bit for bit."""
    want = np.load(GOLDEN)
    got = _golden_outputs(dev)
    assert set(got) == set(want.files)
    for k, v in got.items():
        if k.startswith("k5_"):
            assert v.tobytes() == want[k].tobytes(), k


def test_k6_close_to_golden(dev):
    """K6 now sums its statistics and gate means over a thread-block
    cluster, in a fixed order that is not the one-block kernel's that
    recorded the file, so float32 rounding parts them: x, P, gersh_min and
    min_eig are held at rtol 1e-3 / atol 2e-4 (the bounds of the exact loop
    against K6), n_iters and ok exactly."""
    want = np.load(GOLDEN)
    got = _golden_outputs(dev)
    for k, v in got.items():
        if not k.startswith("k6_"):
            continue
        w = torch.tensor(want[k])
        if k.endswith("_s"):
            assert v[:2].tolist() == want[k][:2].tolist(), k
            _close(torch.tensor(v[2:]), w[2:], 1e-3, 2e-4)
        else:
            _close(torch.tensor(v), w, 1e-3, 2e-4)


def test_split_body_replay_against_fused(dev, scan):
    """The same scans through ``Localizer(split_body=True)``: K8 once per
    evaluation of every updated scan, K5 and K6 never, and the trajectory
    within the chunked-replay bounds (3e-4 m, 3e-5 in the quaternion) of
    the fused one's wherever K6's certificates held."""
    from fast_limo_tpu_torch.models.localizer import Localizer

    cfg, _, loc = scan
    n0 = (gain.gain.launches, update_body.update_body.launches, update_loop.update_loop.launches)
    split = Localizer(cfg, device=dev, split_body=True)
    presets.replay(split, presets.bench_sequence(n_scans=6, points_per_scan=4096))
    evals = cfg.ikfom.MAX_NUM_ITERS + 1
    assert gain.gain.launches - n0[0] == evals * len(split.trajectory)
    assert (update_body.update_body.launches, update_loop.update_loop.launches) == n0[1:]
    a, b = split.trajectory, loc.trajectory
    assert len(a) == len(b) == 6
    for ta, tb in zip(a, b):
        assert np.abs(ta["pos"] - tb["pos"]).max() < 3e-4
        assert np.abs(ta["quat"] - tb["quat"]).max() < 3e-5


def test_slam_defaults_to_the_card(dev):
    from fast_limo_tpu_torch.models.slam import SLAM

    cfg = presets.kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 2048
    cfg.tpu.map_capacity = 8192
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 1000
    cfg.tpu.max_insert_points = 1000
    slam = SLAM(cfg)
    presets.replay(slam, presets.bench_sequence(n_scans=3, points_per_scan=2048))
    slam.flush()
    assert slam.loc.state.P.device == torch.device("cuda", 0)
    assert len(slam.keyframes) >= 1 and np.isfinite(slam.positions()).all()


# ------------------------------------ K5 / K6 / K8 golden outputs, cluster K6

CLUSTER_GOLDEN = os.path.join(os.path.dirname(GOLDEN), "torch_k6_cluster_golden.npz")
K6_CASES = [(N, gate, ee) for N in (1024, 10000) for gate in (0.0, 4.0) for ee in (True, False)]
# K5 beyond the golden file's one input: HᵀH of tests/test_gain.py's cases
# and two whose pose head is degenerate, so the guard's projector acts
# (a zero column: the eigenvalue product under 1e-20; a weak column: one
# eigenvalue under D with a non-zero product)
K5_CASES = {**GAIN_CASES, "zero_head_dims": {"zero_dims": (0, 4)}, "weak_head_dim": {}}


def _k5_case(dev, name, i):
    rng = np.random.default_rng(100 + i)
    HTH, HTh, P = _gain_case(rng, **K5_CASES[name])
    if name == "weak_head_dim":
        s = np.ones(gain.M)
        s[3] = 1e-2
        HTH, HTh = HTH * np.outer(s, s), HTh * s
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    x = st.identity(torch.float32, gravity=9.81, device=dev)
    x = x._replace(pos=t([0.05, -0.03, 0.02]), vel=t([1.0, 0.2, 0.0]))
    xi = st.boxplus(x, t(rng.normal(0.0, 1e-2, 23)))
    return t(HTH), t(HTh), t(P), xi, x


def _cluster_golden_outputs(dev):
    """K6 (the one-cluster kernel) on ``_golden_inputs`` at K6_CASES, K8 on
    GAIN_CASES and K5 on K5_CASES: the outputs held bit for bit."""
    out = {}
    for N, gate, ee in K6_CASES:
        pack, P, x, win, _, _ = _golden_inputs(dev, N=N, gate=gate)
        o = update_loop.update_loop(pack, P, x, 1e-3, 5.0, 1e-3, max_iters=3,
                                    estimate_extrinsics=ee, window=win, with_aux=True)
        tag = f"k6_{N}_{gate:g}_{int(ee)}"
        out.update({f"{tag}_x": st.as_vector(o[0]), f"{tag}_P": o[1], f"{tag}_aux": o[6]})
    for name in GAIN_CASES:
        HTH, HTh, P = [torch.tensor(a, dtype=torch.float32, device=dev)
                       for a in _gain_case(np.random.default_rng(42), **GAIN_CASES[name])]
        for nm, v in zip(("Kx", "Kh", "K"), gain.gain(HTH, HTh, P, 1e-3)):
            out[f"k8_{name}_{nm}"] = v
    for i, name in enumerate(K5_CASES):
        xn, Pf, dxo, gm, me = update_body.update_body(*_k5_case(dev, name, i), 1e-3, 5.0)
        out.update({f"k5_{name}_x": st.as_vector(xn), f"k5_{name}_P": Pf,
                    f"k5_{name}_dx": dxo, f"k5_{name}_s": torch.stack([gm, me])})
    return {k: v.cpu().numpy() for k, v in out.items()}


def test_k5_k6_k8_bit_equal_to_cluster_golden(dev):
    """K6 (one cluster) at K6_CASES, K8 on GAIN_CASES and K5 on K5_CASES are
    the outputs the one-cluster K6 tree recorded, bit for bit (the body's
    schedule and the elimination's spread over the block keep every float
    operation of the serial loops in its order)."""
    want = np.load(CLUSTER_GOLDEN)
    got = _cluster_golden_outputs(dev)
    assert set(got) == set(want.files)
    bad = [k for k, v in got.items() if v.tobytes() != want[k].tobytes()]
    assert not bad, bad


# ------------------------------------------------- K3, the select entry

def _select_case(h, n_stale):
    """The re-match's three sets at the predicted pose of a captured scan:
    window rank, K2 on the idx rows and on every query (no flag, so both
    do work), ``n_stale`` valid queries marked stale."""
    glob = h.glob0
    win = h._window_rank(glob)
    rows = h._rows(glob)
    stale = h.pc_valid & (torch.cumsum(h.pc_valid.to(torch.int32), 0) <= n_stale)
    idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:h.budget]
    patch = h._topk(glob[idx], h.k, (rows[0][idx], rows[1][idx]))
    full = h._topk(glob, h.k, rows)
    return win, patch, idx, stale, full


def test_k3_select_is_the_merge_of_three_launches(scan):
    """fit_planes_select (one launch) is bit for bit ``merge_fits`` of the
    three one-set launches at every branch code; under a clear flag it
    returns at once and counts one launch."""
    _, h, _ = scan
    kw = dict(num_match_points=h.k, max_dist_plane=h.max_dist_plane,
              plane_threshold=h.plane_threshold)
    for n_stale, viol in ((0, 0), (1, 1), (h.budget, h.budget), (h.budget, h.budget + 1)):
        win, patch, idx, stale, full = _select_case(h, n_stale)
        viol = torch.tensor(viol, dtype=torch.int32, device=h.pc.device)
        got = _once(plane_kernel.fit_planes_select, lambda: plane_kernel.fit_planes_select(
            win, patch, idx, stale, full, viol, **kw))
        fits = [plane_kernel.fit_planes(win[0], win[1], torch.isfinite(win[1]), **kw),
                plane_kernel.fit_planes(*patch, **kw), plane_kernel.fit_planes(*full, **kw)]
        want = plane_kernel.merge_fits(*fits, idx, stale, viol)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), int(viol)
        plain = plane_kernel.fit_planes_select_plain(win, patch, idx, stale, full, viol, **kw)
        assert float((got[1] == plain[1]).float().mean()) >= 0.995
        both = got[1] & plain[1]
        _close(got[0][both], plain[0][both], 5e-3, 5e-4)
    for flag in (False, True):
        f = torch.tensor(flag, device=h.pc.device)
        out = _once(plane_kernel.fit_planes_select, lambda: plane_kernel.fit_planes_select(
            win, patch, idx, stale, full, viol, **kw, active=f))
        torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(out, got))   # a set flag: the bits of none


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--write-golden":
        np.savez(sys.argv[2], **_golden_outputs(torch.device("cuda")))
        print("golden →", sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--write-cluster-golden":
        np.savez(sys.argv[2], **_cluster_golden_outputs(torch.device("cuda")))
        print("cluster golden →", sys.argv[2])
