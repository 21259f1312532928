"""The slice as a whole: fast_limo_tpu_torch's per-scan step and Localizer
against the JAX package, at the sizes of ``__graft_entry__._tiny_cfg``
(512-point scans, 4096-entry map, IMU batch 8) with the map/filter
geometry of the KITTI-like configuration (1.2 m voxels, 6-point buckets,
1 m leaf, crop and range filters), on the bench corridor of
``io/synthetic``.  (With _tiny_cfg's own 0.4 m voxels the first scans are
near-degenerate: the degeneracy guard's eigenvalue test against D then
decides directions by rounding, and the two packages part by millimetres.)

One replay through the JAX Localizer captures, per scan, the state it
starts from (as numpy, through the leaves utils/interop carries) and the
exact packs it dispatched; the port's step then runs from those states.

Tolerances: one step from the same state agrees to 2e-4 on the mean (the
JAX package runs its exact per-iteration loop on the CPU, the port its
whole-loop kernel's plain version: the same exact re-match semantics, a
different float32 gain algebra — LU against pivoted Gauss-Jordan) and
5e-4 on P; the first update, from a one-scan map under the initial unit
pose covariance, is ill-conditioned in float32 and its P is held to 2 % of
max|P|.  With ``cfg.debug`` the port's ``DebugOutput`` is held field by field
to the JAX step's from the same state (clouds 1e-5, planes and distances
2e-3 where both keep the match, ``match_keep`` on ≥ 99 % of the queries,
``n_stale``, ``guard_fired`` and ``loop_fallback`` exact), and with it off
neither a launch, a host read nor a field is added.  The split-body replay
(``Localizer(split_body=True)``, the JAX package's CPU program) agrees with
the JAX replay per scan within 1e-3 m.  The 5-scan replays agree per scan within 1e-3 m, and both stay
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as ge
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.models import state as jst
from fast_limo_tpu.models.localizer import Localizer as JLocalizer
from fast_limo_tpu.utils.config import Config as JConfig
from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.models import iekf
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.utils import interop, presets
from fast_limo_tpu_torch.utils.config import Config

N_SCANS = 5


def _cfg(cls):
    """The test configuration in the requested package's Config."""
    src = ge._tiny_cfg()
    src.tpu.map_voxel_size = 1.2
    src.tpu.map_points_per_voxel = 6
    src.filters.leafSize = [1.0, 1.0, 1.0]
    src.filters.crop_active = True
    src.filters.dist_active = True
    src.filters.min_dist = 2.0
    src.ikfom.mapping.MAX_NUM_MATCHES = 5000
    if cls is JConfig:
        return src
    out = cls()
    for f in dataclasses.fields(src):
        setattr(out, f.name, dataclasses.replace(getattr(src, f.name))
                if dataclasses.is_dataclass(getattr(src, f.name)) else getattr(src, f.name))
    return out


def _jax_state_numpy(s) -> dict:
    d = {"x": np.asarray(jst.as_vector(s.x)), "P": np.asarray(s.P)}
    d.update({f"map.{k}": np.asarray(getattr(s.map, k)) for k in interop.MAP_FIELDS})
    d.update({k: np.asarray(getattr(s, k)) for k in interop.CARRIES})
    return {k: np.array(v, copy=True) for k, v in d.items()}


@pytest.fixture(scope="module")
def replays():
    seq = presets.bench_sequence(seed=7, n_scans=N_SCANS, points_per_scan=512)
    jl = JLocalizer(_cfg(JConfig))
    captured = []
    step = jl.scan_step

    def capture(s, scan_buf, imu_pack):
        captured.append((_jax_state_numpy(s), np.asarray(scan_buf), np.asarray(imu_pack)))
        s2, out = step(s, scan_buf, imu_pack)
        captured[-1] += (_jax_state_numpy(s2), np.asarray(out.n_iters))
        return s2, out

    jl.scan_step = capture
    overflows = {"jax": [], "torch": []}
    _count_overflows(jl, overflows["jax"])
    presets.replay(jl, seq)
    tl = Localizer(_cfg(Config), device="cpu")
    _count_overflows(tl, overflows["torch"])
    presets.replay(tl, seq)
    return seq, jl, tl, captured, overflows


def _count_overflows(loc, lengths):
    fold = loc._consume_imu_overflow

    def counted(samples):
        lengths.append(len(samples))
        return fold(samples)

    loc._consume_imu_overflow = counted


def test_config_copies_are_identical():
    assert dataclasses.asdict(_cfg(Config)) == dataclasses.asdict(_cfg(JConfig))


def test_interop_round_trip(replays):
    d = replays[3][-1][3]
    s = interop.lio_state_from_numpy(d, device="cpu")
    back = interop.lio_state_to_numpy(s)
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])


@pytest.mark.parametrize("i", range(1, N_SCANS))
def test_one_scan_step_matches_jax(replays, i):
    """The port's build_scan_step from the JAX state before scan i, on the
    batch the JAX Localizer dispatched, against the JAX step's result."""
    cfg = _cfg(Config)
    s_np, scan_pack, imu_pack, s2_np, n_iters = replays[3][i]
    N, K = scan_pack.shape[0], imu_pack.shape[0]
    b = pl.ScanBatch(
        points=torch.tensor(scan_pack[:, :3]), t_raw=torch.tensor(scan_pack[:, 3]),
        valid=torch.arange(N) < int(imu_pack[0, 7]), stamp=torch.zeros(()),
        epoch_shift=torch.tensor(imu_pack[2, 7]), imu_acc=torch.tensor(imu_pack[:, 0:3]),
        imu_gyro=torch.tensor(imu_pack[:, 3:6]), imu_stamp=torch.tensor(imu_pack[:, 6]),
        imu_valid=torch.arange(K) < int(imu_pack[1, 7]))
    s2, out = pl.build_scan_step(cfg, "cpu")(interop.lio_state_from_numpy(s_np, "cpu"), b)
    got = interop.lio_state_to_numpy(s2)
    assert int(out.n_iters) == int(n_iters)
    np.testing.assert_allclose(got["x"], s2_np["x"], rtol=0, atol=2e-4)
    atol_P = 2e-2 * np.abs(s2_np["P"]).max() if i == 1 else 5e-4
    np.testing.assert_allclose(got["P"], s2_np["P"], rtol=0, atol=atol_P)
    for k in ("prev_scan_stamp", "last_prop_time", "last_w_raw_bl", "last_w", "last_a"):
        np.testing.assert_allclose(got[k], s2_np[k], rtol=1e-5, atol=1e-6)
    # the map grew by the same number of points (insert sets equal; their
    # coordinates carry the ≤ 2e-4 pose difference)
    assert int(got["map.num_points"]) == int(s2_np["map.num_points"])
    assert np.isfinite(got["x"]).all() and st.XF == got["x"].shape[0]


def test_replay_matches_jax_and_tracks(replays):
    seq, jl, tl, _, _ = replays
    tp, jp = tl.positions(), jl.positions()
    assert tp.shape == jp.shape == (N_SCANS, 3)
    np.testing.assert_allclose(tl.stamps(), jl.stamps(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    for loc in (tl, jl):
        ate = synthetic.ate_rmse(loc.positions(), seq.traj.pos(loc.stamps()))
        assert ate < 0.15, ate


def test_replays_fold_imu_overflow(replays):
    """Every dispatch of the replay overflows the IMU batch, in both
    packages alike (the first scan carries the calibration backlog)."""
    overflows = replays[4]
    assert overflows["torch"] == overflows["jax"]
    assert len(overflows["torch"]) == N_SCANS and min(overflows["torch"]) > 0


@pytest.mark.parametrize("n", [8, 3])
def test_prop_step_matches_jax(replays, n):
    """build_prop_step from the JAX state before scan 2, on a full and a
    partial IMU chunk, against the JAX prop step."""
    cfg = _cfg(Config)
    K = cfg.tpu.imu_batch
    d = replays[3][2][0]
    rng = np.random.default_rng(n)
    rows = np.zeros((K, 8), np.float32)
    rows[:n, 0:3] = [0.3, -0.2, 9.81] + rng.normal(size=(n, 3)) * 0.1
    rows[:n, 3:6] = rng.normal(size=(n, 3)) * 0.05
    rows[:n, 6] = d["last_prop_time"] + 0.01 * np.arange(1, n + 1)
    rows[0, 7] = n
    carries = ("last_prop_time", "last_w_raw_bl", "bias_accel_corr", "bias_gyro_corr")
    want = jpl.build_prop_step(_cfg(JConfig))(
        jst.from_vector(jnp.asarray(d["x"])), jnp.asarray(d["P"]),
        *(jnp.asarray(d[k]) for k in carries), jnp.asarray(rows))
    got = pl.build_prop_step(cfg, "cpu")(
        st.from_vector(torch.tensor(d["x"])), torch.tensor(d["P"]),
        *(torch.tensor(d[k]) for k in carries), torch.tensor(rows[:, 0:3]),
        torch.tensor(rows[:, 3:6]), torch.tensor(rows[:, 6]), torch.arange(K) < n)
    np.testing.assert_allclose(st.as_vector(got[0]).numpy(),
                               np.asarray(jst.as_vector(want[0])), rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def _batch(scan_pack, imu_pack):
    N, K = scan_pack.shape[0], imu_pack.shape[0]
    return pl.ScanBatch(
        points=torch.tensor(scan_pack[:, :3]), t_raw=torch.tensor(scan_pack[:, 3]),
        valid=torch.arange(N) < int(imu_pack[0, 7]), stamp=torch.zeros(()),
        epoch_shift=torch.tensor(imu_pack[2, 7]), imu_acc=torch.tensor(imu_pack[:, 0:3]),
        imu_gyro=torch.tensor(imu_pack[:, 3:6]), imu_stamp=torch.tensor(imu_pack[:, 6]),
        imu_valid=torch.arange(K) < int(imu_pack[1, 7]))


def _jax_state(d, jcfg):
    s = jpl.init_state(jcfg)
    m = s.map._replace(**{k: jnp.asarray(d[f"map.{k}"]) for k in interop.MAP_FIELDS})
    return s._replace(x=jst.from_vector(jnp.asarray(d["x"])), P=jnp.asarray(d["P"]), map=m,
                      **{k: jnp.asarray(d[k]) for k in interop.CARRIES})


@pytest.fixture(scope="module")
def debug_steps():
    jcfg, cfg = _cfg(JConfig), _cfg(Config)
    jcfg.debug = cfg.debug = True
    return jpl.build_scan_step_split(jcfg, donate=False), pl.build_scan_step(cfg, "cpu"), jcfg


_FALLBACKS_SEEN = set()


@pytest.mark.parametrize("i", range(N_SCANS))
def test_debug_output_matches_jax(replays, debug_steps, i):
    """Where a scan keeps every window certificate (here the first, on the
    empty map) ``loop_fallback`` is False in both packages.  Where it fails some, the port's whole-loop
    kernel (its plain version here) reports the fallback as the TPU program
    would and ``iekf.counters`` counts it; the JAX package's CPU program
    has no whole-loop kernel and says False by construction."""
    jstep, step, jcfg = debug_steps
    n_fb = iekf.counters.loop_fallbacks
    s_np, scan_pack, imu_pack, _, _ = replays[3][i]
    _, want = jstep(_jax_state(s_np, jcfg), jnp.asarray(scan_pack), jnp.asarray(imu_pack))
    _, got = step(interop.lio_state_from_numpy(s_np, "cpu"), _batch(scan_pack, imu_pack))
    g, w = got.debug, want.debug
    assert type(g).__name__ == type(w).__name__ == "DebugOutput" and g._fields == w._fields
    np.testing.assert_array_equal(g.orig_valid.numpy(), np.asarray(w.orig_valid))
    np.testing.assert_array_equal(g.deskewed_valid.numpy(), np.asarray(w.deskewed_valid))
    v = g.orig_valid.numpy()
    np.testing.assert_allclose(g.orig_points.numpy()[v], np.asarray(w.orig_points)[v], atol=1e-6)
    np.testing.assert_allclose(g.deskewed.numpy()[v], np.asarray(w.deskewed)[v], atol=1e-5)
    kg, kw = g.match_keep.numpy(), np.asarray(w.match_keep)
    assert kg.shape == kw.shape and (kg == kw).mean() >= 0.99 and (i < 3 or kg.sum() > 50)
    both = kg & kw
    np.testing.assert_allclose(g.match_planes.numpy()[both], np.asarray(w.match_planes)[both],
                               atol=2e-3)
    np.testing.assert_allclose(g.match_dist.numpy()[both], np.asarray(w.match_dist)[both],
                               atol=2e-3)
    assert g.n_stale.dtype == torch.int32 and int(g.n_stale) == int(w.n_stale)
    assert bool(g.guard_fired) == bool(w.guard_fired)
    fallback = iekf.counters.loop_fallbacks > n_fb
    _FALLBACKS_SEEN.add(fallback)
    assert bool(g.loop_fallback) is fallback and bool(w.loop_fallback) is False
    assert fallback or int(g.n_stale) == 0
    np.testing.assert_allclose(float(g.gersh_min), float(w.gersh_min), rtol=2e-3)
    # the JAX CPU loop certifies min_eig ≥ D by the Gershgorin bound (+inf)
    # where it can; the port's whole-loop kernel always computes it
    assert float(g.min_eig) >= jcfg.ikfom.degeneracy_thresh or bool(g.guard_fired)


def test_debug_loop_fallback_seen_both_ways():
    """The scans above cover both outcomes of K6's certificates."""
    assert _FALLBACKS_SEEN == {True, False}


def test_debug_off_adds_nothing(replays):
    """The rule of tests/test_debug.py: with cfg.debug off no DebugOutput
    and the same state bit for bit; the step reads nothing on the host in
    either setting (the posterior re-match's branch is chosen on the
    device)."""
    s_np, scan_pack, imu_pack, _, _ = replays[3][3]
    cfg_on, cfg_off = _cfg(Config), _cfg(Config)
    cfg_on.debug = True
    calls = {}

    def run(cfg):
        from fast_limo_tpu_torch.models import measurement

        n0, orig, made = iekf.counters.host_syncs, measurement.make_h_model, []
        measurement.make_h_model = lambda *a, **kw: made.append(orig(*a, **kw)) or made[-1]
        try:
            out = pl.build_scan_step(cfg, "cpu")(interop.lio_state_from_numpy(s_np, "cpu"),
                                                 _batch(scan_pack, imu_pack))
        finally:
            measurement.make_h_model = orig
        calls[cfg.debug] = iekf.counters.host_syncs - n0
        return out

    (s_on, o_on), (s_off, o_off) = run(cfg_on), run(cfg_off)
    assert o_off.debug is None and o_on.debug is not None
    assert calls[True] == calls[False] == 0
    a, b = interop.lio_state_to_numpy(s_on), interop.lio_state_to_numpy(s_off)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("chunk", [1, 2])
def test_debug_rides_every_entry_point(replays, chunk):
    """Localizer.last_output carries the DebugOutput through the split step
    and, stacked on the chunk axis, through the chunk step."""
    cfg = _cfg(Config)
    cfg.debug, cfg.tpu.scan_chunk = True, chunk
    loc = Localizer(cfg, device="cpu")
    presets.replay(loc, presets.bench_sequence(seed=7, n_scans=2, points_per_scan=512))
    loc.flush()
    dbg = loc.last_output.debug
    lead = () if chunk == 1 else (chunk,)
    assert dbg.match_planes.shape == lead + (cfg.ikfom.mapping.MAX_NUM_PC2MATCH, 4)
    assert dbg.n_stale.shape == lead and dbg.loop_fallback.dtype == torch.bool
    assert np.isfinite(loc.positions()).all() and len(loc.trajectory) == 2


def test_split_body_replay_matches_jax(replays):
    seq, jl, _, _, _ = replays
    n0 = iekf.counters.loop_fallbacks
    tl = Localizer(_cfg(Config), device="cpu", split_body=True)
    presets.replay(tl, seq)
    assert iekf.counters.loop_fallbacks == n0       # K6's path is not taken at all
    assert [t["n_iters"] for t in tl.trajectory] == [t["n_iters"] for t in jl.trajectory]
    np.testing.assert_allclose(tl.positions(), jl.positions(), rtol=0, atol=1e-3)
    ate = synthetic.ate_rmse(tl.positions(), seq.traj.pos(tl.stamps()))
    assert ate < 0.15, ate
