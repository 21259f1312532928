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
n_iters, ok and the stale count exact; K7 and K2 at k = 64 sq and valid
bit-equal, neighbours equal; K9 bit-equal; K8 against float64 truth within
12× the float32 library solve's error + 2e-5 of the largest entry (the rule
of tests/test_gain.py; likewise against 12× its plain version's error) and
to its plain version within rtol 1e-3 + 1e-3 of the largest entry on the
cases of up to three decades (the plain version's products are library
matmuls: the same float32 terms summed in another order, through an
ill-conditioned 12×12 solve; at 4.5 decades two float32 algorithms part by
more than that while both stay near truth).  K5 and K6 are also held bit for bit to outputs recorded before
the gain moved into ``csrc/gain.cuh`` (``tests/data/torch_k5k6_golden.npz``;
``python tests/test_torch_cuda.py --write-golden <path>`` records such a
file from whatever package is importable).  Also: the Localizer lands on
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


def test_k1_deskew(dev):
    rng = np.random.default_rng(1)
    K, N = 9, 3000
    f = {k: torch.tensor(np.float32(rng.normal(size=(K, 3))), device=dev)
         for k in ("pos", "vel", "bg", "ba", "w", "a")}
    q = rng.normal(size=(K, 4))
    from fast_limo_tpu_torch.models.deskew import Frames

    fr = Frames(time=torch.tensor(np.float32(np.sort(rng.uniform(0, 0.1, K))), device=dev),
                rot=torch.tensor(np.float32(q / np.linalg.norm(q, axis=1, keepdims=True)),
                                 device=dev),
                grav=torch.tensor([[0.0, 0.0, -9.81]] * K, device=dev),
                valid=torch.arange(K, device=dev) < 7, **f)
    pts = torch.tensor(np.float32(rng.uniform(-30, 30, (N, 3))), device=dev)
    t = torch.tensor(np.float32(rng.uniform(-0.01, 0.12, N)), device=dev)
    valid = torch.tensor(rng.random(N) < 0.9, device=dev)
    F = deskew_kernel.frame_table(fr)
    sc = deskew_kernel._scalars(fr.rot[0], fr.pos[0], fr.rot[1], fr.pos[1])
    got = _once(deskew_kernel.deskew, lambda: deskew_kernel.deskew(
        pts, t, valid, fr, fr.rot[1], fr.pos[1], fr.rot[0], fr.pos[0]))
    for a, b in zip(got, deskew_kernel.deskew_plain(pts, t, valid, F, sc)):
        _close(a, b, 1e-4, 2e-4)


def test_k2_k3_k4_on_a_scan(scan):
    cfg, h, _ = scan
    rows, ncb = mapper.gather_rows(h.m, h.glob0, voxel_size=h.voxel_size)
    for k in (5, 12):
        a = _once(knn_rows.topk_from_rows, lambda: knn_rows.topk_from_rows(
            rows, ncb, h.glob0, E=mapper.E, B=h.m.bucket, k=k))
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
    HTH, HTh = h.stats(x)
    xi = st.boxplus(x, torch.full((23,), 1e-3, device=P.device))
    ka = _once(update_body.update_body,
               lambda: update_body.update_body(HTH, HTh, P, xi, x, 1e-3, 5.0))
    kb = update_body.update_body_plain(HTH, HTh, P, xi, x, 1e-3, 5.0)
    _close(st.as_vector(ka[0]), st.as_vector(kb[0]), 1e-3, 1e-4)
    _close(ka[1], kb[1], 1e-3, 1e-3)
    assert iekf.counters.host_syncs > 0


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
    (64, 1500, 64, 0.7, True), (381, 12000, 16, 0.7, False), (21, 25000, 128, 0.3, False)])
def test_k7_masked_topk(dev, N, C, k, frac, ties):
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


def test_k2_at_k64_on_a_scan(scan):
    _, h, _ = scan
    for nbh in (8, -27):
        rows, ncb = mapper.gather_rows(h.m, h.glob0, voxel_size=h.voxel_size, neighborhood=nbh)
        for k in (17, 64, 128):
            a = _once(knn_rows.topk_from_rows, lambda: knn_rows.topk_from_rows(
                rows, ncb, h.glob0, E=mapper.E, B=h.m.bucket, k=k))
            b = knn_rows.topk_from_rows_reference(rows, ncb, h.glob0, E=mapper.E,
                                                  B=h.m.bucket, k=k)
            assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            assert torch.equal(a[0][b[2]], b[0][b[2]])
    with pytest.raises(ValueError):
        knn_rows.topk_from_rows(rows, ncb, h.glob0, E=mapper.E, B=h.m.bucket, k=129)


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


@pytest.mark.parametrize("N", [1, 127, 10000, 32768])
def test_k9_sort3(dev, N):
    """K9 against its plain version: keys with duplicates, negatives and
    the INT32_MAX sentinel, a unique index operand (the callers' form) and
    a repeated one."""
    rng = np.random.default_rng(N)
    k1 = rng.integers(-300, 300, N).astype(np.int32)
    k1[rng.random(N) < 0.2] = np.int32(0x7FFFFFFF)
    k2 = rng.integers(-(1 << 30), 1 << 30, N).astype(np.int32)
    k2[rng.random(N) < 0.5] = 7
    for v in (np.arange(N, dtype=np.int32), rng.integers(-2, 2, N).astype(np.int32)):
        args = [torch.tensor(a, device=dev) for a in (k1, k2, v)]
        got = _once(sort.sort3, lambda: sort.sort3(*args))
        for g, w in zip(got, sort.sort3_plain(*args)):
            assert g.shape == (N,) and torch.equal(g, w)
    key, idx = args[0], torch.arange(N, dtype=torch.int32, device=dev)
    got = _once(sort.sort3, lambda: sort.sort_key_val(key, idx))
    want = sort.sort3_plain(key, idx, idx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[2])


def test_k9_refuses_what_it_does_not_take(dev):
    a = torch.arange(8, dtype=torch.int32, device=dev)
    for bad in ((a.long(), a, a), (a[::2], a[:4], a[:4]), (a[:0], a[:0], a[:0])):
        with pytest.raises(ValueError):
            sort.sort3(*bad)


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


def _golden_inputs(dev):
    """Deterministic K5/K6 inputs made on the host: a window pack of 1024
    queries on three noisy walls around the origin, a filter-like P."""
    rng = np.random.default_rng(5)
    N, W = 1024, 12
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
                             plane_threshold=0.1, max_num_matches=5000, dynamic_gate=0.0)
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


def test_k5_k6_bit_equal_to_golden(dev):
    want = np.load(GOLDEN)
    got = _golden_outputs(dev)
    assert set(got) == set(want.files)
    for k, v in got.items():
        assert v.tobytes() == want[k].tobytes(), k


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


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--write-golden":
        np.savez(sys.argv[2], **_golden_outputs(torch.device("cuda")))
        print("golden →", sys.argv[2])
