"""The long-running session surface of fast_limo_tpu_torch against the JAX
package: the map's query and maintenance API (``knn``, ``radius_search``,
``evict_far``, the views), checkpoints in both directions, a resume from
one JAX-written checkpoint in both Localizers, the IMU-rate state
queries, the eviction cadence, and the Localizer's input check, device
default and bounded output retention.

Map comparisons are exact (tables, rows, validity, eviction) except for
squared distances: XLA-CPU contracts ``dx² + dy² + dz²`` into fused
multiply-adds, so the JAX side's distances are compared at 3e-7 relative
(≤ 2 ulp) in the kNN and at 1e-5 (the JAX package's own radius-search
criterion) against brute force.  Resumed trajectories agree within 1e-3 m
and the state queries within the prop-step tolerances of
tests/test_torch_pipeline.py (rtol 1e-4, atol 1e-5): the two packages'
float32 gain algebras differ in rounding.
"""

import dataclasses
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.models.localizer import Localizer as JLocalizer
from fast_limo_tpu.utils import checkpoint as jckpt
from fast_limo_tpu.utils.config import Config as JConfig
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.ops import knn, knn_rows
from fast_limo_tpu_torch.utils import checkpoint as ckpt
from fast_limo_tpu_torch.utils import interop, presets, validation
from fast_limo_tpu_torch.utils.config import Config

VOX = 1.2
N_SCANS, SAVE_AT = 6, 3


# ----------------------------------------------------------------- the map
@pytest.fixture(scope="module")
def maps():
    """The same 3000-point surface-like cloud inserted into both packages'
    maps (8192 entries, 3-point buckets)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-12, 12, (3000, 3))
    pts[:1500, 2] = rng.normal(0, 0.05, 1500)                 # ground
    pts[1500:2200, 1] = 4.0 + rng.normal(0, 0.05, 700)        # wall
    pts = np.float32(pts)
    tm = mp.insert(mp.create(8192, 3), torch.tensor(pts), torch.ones(3000, dtype=torch.bool),
                   voxel_size=VOX)
    jm = jmp.insert(jmp.create(8192, 3), jnp.asarray(pts), jnp.ones(3000, bool),
                    voxel_size=VOX)
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    return tm, jm


def _queries(n=60, seed=12):
    return np.float32(np.random.default_rng(seed).uniform(-10, 10, (n, 3)))


def _separated(sq):
    """Lanes whose distance differs from both neighbouring lanes' by more
    than 1e-5 relative: there the neighbour does not hang on a last-bit
    difference of the two packages' distances."""
    with np.errstate(invalid="ignore"):        # inf − inf on invalid lanes
        gap = np.abs(np.diff(sq, axis=1)) > 1e-5 * np.abs(sq[:, 1:])
    edge = np.ones((len(sq), 1), bool)
    return np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)


@pytest.mark.parametrize("view", ["coords", "counts", "points", "meta"])
def test_map_views_match_jax(maps, view):
    tm, jm = maps
    assert tm.capacity == jm.capacity == 8192
    got, want = getattr(tm, view).numpy(), np.asarray(getattr(jm, view))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbh", [4, 8, 27, -27])
def test_gather_rows_neighborhoods_match_jax(maps, nbh):
    tm, jm = maps
    q = _queries()
    rows, ncb, _ = mp.gather_rows(tm, torch.tensor(q), voxel_size=VOX, neighborhood=nbh)
    jrows, jncb, _ = jmp.gather_rows(jm, jnp.asarray(q), voxel_size=VOX, neighborhood=nbh)
    assert rows.shape[1] == (27 if nbh == -27 else 8)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(ncb.numpy(), np.asarray(jncb))
    cands = mp.gather_neighborhood(tm, torch.tensor(q), voxel_size=VOX, neighborhood=nbh)
    jcands = jmp.gather_neighborhood(jm, jnp.asarray(q), voxel_size=VOX, neighborhood=nbh)
    for g, w in zip(cands, jcands):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nbh,k", [(8, 5), (8, 32), (-27, 12), (-27, 64)])
def test_knn_matches_jax(maps, nbh, k):
    tm, jm = maps
    q = _queries()
    n0 = knn_rows.topk_from_table.launches
    nb, sq, vl = (a.numpy() for a in mp.knn(tm, torch.tensor(q), voxel_size=VOX, k=k,
                                             neighborhood=nbh))
    assert knn_rows.topk_from_table.launches == n0          # plain version on the CPU
    wn, ws, wv = (np.asarray(a) for a in jmp.knn(jm, jnp.asarray(q), voxel_size=VOX, k=k,
                                                 neighborhood=nbh))
    np.testing.assert_array_equal(vl, wv)
    np.testing.assert_allclose(sq[vl], ws[wv], rtol=3e-7, atol=0)
    sep = _separated(ws) & vl
    assert sep.sum() > vl.sum() // 2
    np.testing.assert_array_equal(nb[sep], wn[sep])
    assert vl.any()


@pytest.mark.parametrize("factor,max_results", [
    (0.9, 4), (0.9, 32), (1.9, 4), (1.9, 32), (1.9, 64), (3.1, 32), (3.1, 64), (6.5, 64)])
def test_radius_search_matches_jax_and_brute_force(maps, factor, max_results):
    tm, jm = maps
    q = _queries(n=17, seed=13)
    r = factor * VOX
    n0 = knn.masked_topk.launches
    nb, sq, vl = (a.numpy() for a in mp.radius_search(
        tm, torch.tensor(q), r, voxel_size=VOX, max_results=max_results))
    assert knn.masked_topk.launches == n0
    wn, ws, wv = (np.asarray(a) for a in jmp.radius_search(
        jm, jnp.asarray(q), r, voxel_size=VOX, max_results=max_results))
    np.testing.assert_array_equal(vl, wv)
    np.testing.assert_allclose(sq[vl], ws[wv], rtol=3e-7, atol=0)
    sep = _separated(ws) & vl
    np.testing.assert_array_equal(nb[sep], wn[sep])
    assert np.all(np.isinf(sq[~vl]))
    kept = ckpt.map_points(tm)
    for i in range(len(q)):
        d2 = np.sum((kept - q[i]) ** 2, axis=1)
        want = np.sort(d2[d2 <= r * r])[:max_results]
        got = sq[i][vl[i]]
        assert len(got) == len(want), (i, len(got), len(want))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert np.all(np.diff(got) >= 0)
        assert np.all(np.linalg.norm(nb[i][vl[i]] - q[i], axis=1) <= r + 1e-5)
    assert vl.any()


def test_radius_search_rejects_radii_beyond_13_cubed_blocks(maps):
    with pytest.raises(ValueError, match="13"):
        mp.radius_search(maps[0], torch.zeros((1, 3)), 15.7, voxel_size=VOX)


def test_evict_far_matches_jax_bit_for_bit(maps):
    tm, jm = maps
    table0 = tm.table.clone()
    center = np.float32([1.5, -2.0, 0.3])
    te = mp.evict_far(tm, torch.tensor(center), 6.0, voxel_size=VOX)
    je = jmp.evict_far(jm, jnp.asarray(center), 6.0, voxel_size=VOX)
    np.testing.assert_array_equal(te.table.numpy(), np.asarray(je.table))
    np.testing.assert_array_equal(te.ptable.numpy(), np.asarray(je.ptable))
    assert int(te.num_points) == int(je.num_points) < int(tm.num_points)
    assert torch.equal(tm.table, table0)                    # the input map is untouched
    np.testing.assert_array_equal(te.ptable.numpy(), mp._planarize(te.table, 3).numpy())
    # re-insert into the freed entries: both packages land the same points
    pts = np.float32(np.random.default_rng(14).uniform(-12, 12, (800, 3)))
    te = mp.insert(te, torch.tensor(pts), torch.ones(800, dtype=torch.bool), voxel_size=VOX)
    je = jmp.insert(je, jnp.asarray(pts), jnp.ones(800, bool), voxel_size=VOX)
    np.testing.assert_array_equal(te.table.numpy(), np.asarray(je.table))
    np.testing.assert_array_equal(te.ptable.numpy(), np.asarray(je.ptable))


def test_map_points_and_pcd_match_jax(maps, tmp_path):
    tm, jm = maps
    pts = ckpt.map_points(tm)
    np.testing.assert_array_equal(pts, np.asarray(jckpt.map_points(jm)))
    p = str(tmp_path / "map.pcd")
    assert ckpt.save_map_pcd(p, tm) == len(pts) > 0
    np.testing.assert_allclose(jckpt.load_map_pcd(p), pts, atol=1e-6)
    np.testing.assert_array_equal(ckpt.load_map_pcd(p), jckpt.load_map_pcd(p))


# ------------------------------------------------------------- the session
def _cfg(cls):
    """tests/test_torch_pipeline.py's configuration in either package."""
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
        v = getattr(src, f.name)
        setattr(out, f.name, dataclasses.replace(v) if dataclasses.is_dataclass(v) else v)
    return out


def _events(seq):
    """The replay's arrival order: ("imu", (stamp, acc, gyro)) and
    ("scan", (stamp, points, t_raw))."""
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    out, si = [], 0
    for k in range(len(stamps)):
        out.append(("imu", (stamps[k], acc[k], gyro[k])))
        while si < len(scans) and scans[si][0] <= stamps[k]:
            out.append(("scan", scans[si]))
            si += 1
    return out


def _feed(loc, ev):
    kind, a = ev
    if kind == "imu":
        loc.update_imu(*a)
    else:
        loc.update_pointcloud(a[1], a[2], a[0])


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A JAX Localizer replays the corridor and writes a checkpoint five IMU
    samples after scan SAVE_AT; a fresh JAX Localizer and a fresh port
    Localizer load it, receive the samples the first still held, are
    queried (IMU-rate fresh: propagated through those samples), and replay
    the rest of the stream."""
    seq = presets.bench_sequence(seed=7, n_scans=N_SCANS, points_per_scan=512)
    events = _events(seq)
    path = str(tmp_path_factory.mktemp("ck") / "session.npz")
    ja = JLocalizer(_cfg(JConfig))
    at = None
    for j, ev in enumerate(events):
        _feed(ja, ev)
        if at is None and len(ja._raw_outputs) == SAVE_AT and len(ja._imu_queue) == 5:
            ja.save_checkpoint(path)
            held_imu = list(ja._imu_queue)
            held_scans = [e for e in events[:j + 1] if e[0] == "scan"
                          and e[1][0] in {s.stamp for s in ja._scan_queue}]
            at = j
    assert at is not None
    resumed, queries = {}, {}
    for name, loc in (("jax", JLocalizer(_cfg(JConfig))),
                      ("torch", Localizer(_cfg(Config), device="cpu"))):
        loc.load_checkpoint(path)
        for s, a, g in held_imu:
            loc.update_imu(s, a, g)
        queries[name] = {"world": loc.get_world_state(), "body": loc.get_body_state(),
                         "pose_cov": loc.get_pose_covariance(),
                         "twist_cov": loc.get_twist_covariance()}
        for ev in held_scans + events[at + 1:]:
            _feed(loc, ev)
        resumed[name] = loc
    return seq, ja, resumed, queries, path


def test_resume_from_one_jax_checkpoint_in_both_packages(session):
    seq, ja, resumed, _, _ = session
    want = ja.positions()[SAVE_AT:]
    assert want.shape == (N_SCANS - SAVE_AT, 3)
    np.testing.assert_allclose(resumed["jax"].positions(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(resumed["torch"].positions(), resumed["jax"].positions(),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(resumed["torch"].stamps(), ja.stamps()[SAVE_AT:], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("part", ["world", "body"])
def test_state_queries_match_jax(session, part):
    got, want = session[3]["torch"][part], session[3]["jax"][part]
    assert set(got) == set(want)
    assert got["time"] == pytest.approx(want["time"], abs=1e-6)
    assert got["time"] > ja_last_stamp(session)
    for k in ("pos", "quat", "vel_body", "bg", "ba", "grav"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def ja_last_stamp(session):
    """Stamp of the last scan dispatched before the checkpoint."""
    return session[1].stamps()[SAVE_AT - 1]


@pytest.mark.parametrize("part", ["pose_cov", "twist_cov"])
def test_covariance_queries_match_jax(session, part):
    got, want = session[3]["torch"][part], np.asarray(session[3]["jax"][part])
    assert got.shape == want.shape == (6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def _leaves_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k], a[k].dtype), a[k], err_msg=k)


def _file_leaves(path):
    data = np.load(path, allow_pickle=False)
    return {k: data[k] for k in data.files if k != "__meta__"}


def test_checkpoint_jax_written_loads_in_the_port_and_back(session, tmp_path):
    """The JAX-written checkpoint loads into the port leaf for leaf; the
    port writes it back with the same keys, and the JAX package loads that."""
    path = session[4]
    cfg = _cfg(Config)
    s = ckpt.load_state(path, pl.init_state(cfg, "cpu"))
    flat = {k.replace("/", "__"): v.numpy() for k, v in ckpt._flatten_with_paths(s).items()}
    _leaves_equal(flat, _file_leaves(path))
    back = str(tmp_path / "back.npz")
    ckpt.save_state(back, s, extra=ckpt.load_extra(path))
    assert json.loads(str(np.load(back)["__meta__"])) == json.loads(str(np.load(path)["__meta__"]))
    _leaves_equal(_file_leaves(back), _file_leaves(path))
    js = jckpt.load_state(back, jpl.init_state(_cfg(JConfig)))
    jflat = {k.replace("/", "__"): np.asarray(v)
             for k, v in jckpt._flatten_with_paths(js)[0].items()}
    _leaves_equal(jflat, _file_leaves(path))


def test_checkpoint_leaves_land_on_the_template_device(session):
    s = ckpt.load_state(session[4], pl.init_state(_cfg(Config), "cpu"))
    for v in ckpt._flatten_with_paths(s).values():
        assert v.device.type == "cpu" and v.is_contiguous()
    assert s.map.num_points.dtype == torch.int32 and s.P.dtype == torch.float32


def test_load_rebuilds_planar_mirror_and_rejects_layout_stamps(session, tmp_path):
    cfg = _cfg(Config)
    p = str(tmp_path / "ck.npz")
    src = Localizer(cfg, device="cpu")
    src.load_checkpoint(session[4])
    src.save_checkpoint(p)
    d = dict(np.load(p, allow_pickle=False))
    d["map__ptable"] = d["map__ptable"][:, ::-1].copy()         # scrambled lanes
    np.savez_compressed(p, **d)
    loc = Localizer(cfg, device="cpu")
    loc.load_checkpoint(p)
    m = loc.state.map
    assert int(m.num_points) > 0
    assert torch.equal(m.ptable, mp._planarize(m.table, m.bucket))
    assert torch.equal(m.ptable, src.state.map.ptable)
    meta = json.loads(str(d["__meta__"]))
    meta["extra"]["map_layout"] = "block2x2x2/E8/SUB2/B2"
    d["__meta__"] = json.dumps(meta)
    np.savez_compressed(p, **d)
    with pytest.raises(ValueError, match="map layout"):
        Localizer(cfg, device="cpu").load_checkpoint(p)


def test_reset_clock_restarts_the_time_base(session):
    loc = Localizer(_cfg(Config), device="cpu")
    loc.load_checkpoint(session[4], reset_clock=True)
    assert loc.epoch is None and not loc._imu_queue
    assert float(loc.state.last_prop_time) == float(loc.state.prev_scan_stamp) == 0.0
    assert loc._last_consumed_stamp == -np.inf


def test_eviction_cadence_matches_jax(session):
    """Both Localizers, from the same loaded state, evict on the same
    cadence mark (the lagged probe: the first mark at 16 only takes the
    probe, the second at 32 reads it) and end with the same map."""
    path = session[4]
    runs = {}
    for name, loc in (("jax", JLocalizer(_cfg(JConfig))),
                      ("torch", Localizer(_cfg(Config), device="cpu"))):
        loc.load_checkpoint(path)
        loc.evict_radius, loc.evict_occupancy = 4.0, 0.01
        pos = np.float32(loc.get_world_state()["pos"])
        pos = jnp.asarray(pos) if name == "jax" else torch.tensor(pos)
        counts = []
        for _ in range(40):
            loc._maybe_evict(pos)
            counts.append(int(loc.state.map.num_points))
        runs[name] = (counts, np.asarray(loc.state.map.table), np.asarray(loc.state.map.ptable))
    (tc, tt, tp), (jc, jt, jp) = runs["torch"], runs["jax"]
    assert tc == jc
    drops = [i + 1 for i in range(1, 40) if tc[i] < tc[i - 1]]
    assert drops == [32], tc
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)


# ------------------------ device default, output retention, input check
def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises instead of running on the
    CPU; device="cpu" is the explicit way to the plain versions."""
    for fn in (Localizer.__init__, pl.init_state, pl.build_scan_step, pl.build_prop_step,
               interop.lio_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(Config)
    for call in (lambda: Localizer(cfg), lambda: pl.init_state(cfg),
                 lambda: pl.build_scan_step(cfg), lambda: pl.build_prop_step(cfg)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert Localizer(cfg, device="cpu").device.type == "cpu"


def test_outputs_are_released_from_the_device():
    """At most 64 scans' outputs stay on the device; older ones are copied
    to the host in one batch and their tensors dropped."""
    loc = Localizer(_cfg(Config), device="cpu")

    def out(i):
        f = torch.float32
        return pl.ScanOutput(
            pos=torch.full((3,), float(i)), quat=torch.tensor([1.0, 0, 0, 0]),
            vel=torch.zeros(3), final_scan=torch.zeros((512, 3)),
            final_valid=torch.zeros(512, dtype=torch.bool), scan_body=torch.zeros((512, 3)),
            n_iters=torch.tensor(2), n_deskewed=torch.tensor(500), n_pc2match=torch.tensor(i),
            scan_stamp=torch.tensor(0.05, dtype=f))

    for i in range(100):
        loc._raw_outputs.append((10.0 + i, out(i)))
        loc._bound_retention()
        assert sum(o is not None for _, o in loc._raw_outputs) <= 64
    assert all(o is None for _, o in loc._raw_outputs[:36])
    traj = loc.trajectory
    assert all(o is None for _, o in loc._raw_outputs)
    assert len(traj) == 100
    assert [t["n_pc2match"] for t in traj] == list(range(100))
    np.testing.assert_allclose(loc.positions()[:, 0], np.arange(100))
    np.testing.assert_allclose(loc.stamps(), 10.05 + np.arange(100), atol=1e-6)


@pytest.mark.parametrize("points,t_raw", [
    (np.zeros((10, 4)), np.zeros(10)),              # (N,4) cloud
    (np.zeros((10, 3)), np.zeros(9)),               # times of another length
    (np.zeros((10, 3)), np.full(10, np.nan)),       # no finite time
    (np.zeros((10, 3)), np.linspace(0, 50, 10)),    # VELODYNE seconds spanning 50 s
])
def test_malformed_cloud_is_rejected(points, t_raw):
    loc = Localizer(_cfg(Config), device="cpu")
    with pytest.raises(validation.PointcloudStructureError):
        loc.update_pointcloud(points, t_raw, 0.0)
    assert not loc._scan_queue
