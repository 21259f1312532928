"""The SLAM engine of the port against the JAX package: relocalization,
the engine on a short closed circuit, GPS priors, sessions, the CLI.

Both engines get the same numpy scans from a seed at
``__graft_entry__._tiny_cfg`` sizes with the KITTI-like map geometry (the
configuration of tests/test_torch_pipeline.py).  The circuit is a 5 m-radius
loop at 4 m/s, 36 scans of 1024 points, whose first revisit closes one loop
with a wide margin (ScanContext distance well under the threshold, one
candidate): both engines accept the same keyframes, close the same loop
edge and end with keyframe positions within 2e-3 m (odometry alone parts
the two float32 programs by 5e-4 m over these scans; the acceptance
decisions are exact).  A session written by either package loads in the
other.  The CLI runs on ``--device cpu`` with ate_m < 0.15.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.io import synthetic as jsyn
from fast_limo_tpu.models import relocalize as jrl
from fast_limo_tpu.models.slam import SLAM as JSLAM
from fast_limo_tpu.models.slam import Keyframe as JKeyframe
from fast_limo_tpu.models.slam import LoopConfig as JLoopConfig
from fast_limo_tpu.utils.config import Config as JConfig
from fast_limo_tpu_torch import cli
from fast_limo_tpu_torch.models import relocalize as rl
from fast_limo_tpu_torch.models import scancontext
from fast_limo_tpu_torch.models.slam import SLAM, Keyframe, LoopConfig
from fast_limo_tpu_torch.utils import interop, presets
from fast_limo_tpu_torch.utils.config import Config

from test_loop import ring_scene, yaw_rot
from test_torch_pipeline import _cfg

N_SCANS = 36
LOOP_KW = dict(kf_dist=1.5, exclude_recent=8, sc_dist_thresh=0.35, icp_min_inliers=100,
               icp_points=512, rebuild_points=1024, loop_weight=30.0, loop_cooldown=3.0)


def test_loop_config_and_keyframe_mirror_jax():
    assert dataclasses.asdict(LoopConfig()) == dataclasses.asdict(JLoopConfig())
    assert [f.name for f in dataclasses.fields(Keyframe)] == \
        [f.name for f in dataclasses.fields(JKeyframe)]
    assert dataclasses.asdict(presets.soak_loop_cfg())["max_keyframes"] == 64


# ------------------------------------------------------------- relocalize

def _make_kf(idx, pos, yaw, cloud):
    q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
    desc = scancontext.descriptor(torch.tensor(cloud), torch.ones(len(cloud), dtype=torch.bool))
    return dict(index=idx, stamp=float(idx), pos=np.asarray(pos, np.float32), quat=q,
                desc=desc.numpy(), ring_key=scancontext.ring_key(desc).numpy(), cloud=cloud,
                cloud_valid=np.ones(len(cloud), bool))


def test_relocalize_picks_the_same_keyframe_and_pose_as_jax():
    scenes = [ring_scene(np.random.default_rng(s), 512, w1_y=8.0 + 7 * s, w2_x=-12.0 - 6 * s)
              for s in range(3)]
    dicts = [_make_kf(i, [20.0 * i, 0, 0], 0.15 * i, scenes[i]) for i in range(3)]
    kfs, jkfs = interop.keyframes_from_dicts(dicts), [JKeyframe(**d) for d in dicts]
    assert interop.keyframes_to_dicts(jkfs)[1].keys() == interop.keyframes_to_dicts(kfs)[1].keys()
    t_q = np.array([0.5, -0.3, 0.0], np.float32)
    query = ((scenes[1] - t_q) @ yaw_rot(0.3)).astype(np.float32)
    ones = np.ones(len(query), bool)
    got = rl.relocalize(query, ones, kfs, sc_thresh=0.4, icp_min_inliers=100, device="cpu")
    want = jrl.relocalize(query, ones, jkfs, sc_thresh=0.4, icp_min_inliers=100)
    assert got.success and want.success and got.keyframe_index == want.keyframe_index == 1
    np.testing.assert_allclose(got.pos, want.pos, atol=1e-3)
    np.testing.assert_allclose(got.quat, want.quat, atol=1e-3)
    assert got.sc_dist == pytest.approx(want.sc_dist, abs=1e-5)
    assert got.icp_rmse == pytest.approx(want.icp_rmse, abs=1e-3)
    np.testing.assert_allclose(got.pos, dicts[1]["pos"] + [0.5, -0.3, 0.0], atol=0.15)
    alien = np.random.default_rng(9).uniform(-30, 30, (512, 3)).astype(np.float32)
    assert not rl.relocalize(alien, ones, kfs, sc_thresh=0.2, device="cpu").success
    assert not rl.relocalize(query, ones, [], device="cpu").success
    pair, vel = rl.relocalize_pair(query, ones, query, ones, 0.1, kfs, sc_thresh=0.4,
                                   icp_min_inliers=100, device="cpu")
    assert pair.success and np.allclose(vel, 0.0)


# ------------------------------------------------------- the engine, a loop

def _circuit(n=N_SCANS):
    return jsyn.SyntheticSequence(
        seed=11, n_scans=n, points_per_scan=1024, scan_rate=5.0, noise_pt=0.01,
        noise_gyro=8e-4, noise_acc=8e-3, max_range=25.0,
        traj=jsyn.LoopTrajectory(v_forward=4.0, radius=5.0, ramp_tau=0.8),
        world=jsyn.build_loop_world(11, radius=5.0, n_pts=40000))


def _drive(engine, seq, gps_every=0.0):
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    si, last = 0, -1e9
    for k in range(len(stamps)):
        engine.update_imu(stamps[k], acc[k], gyro[k])
        if gps_every and stamps[k] - last >= gps_every:
            last = stamps[k]
            engine.update_gps(stamps[k], seq.traj.pos(np.asarray([stamps[k]]))[0])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            engine.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
    engine.flush()
    return engine


@pytest.fixture(scope="module")
def engines():
    seq = _circuit()
    return (seq, _drive(SLAM(_cfg(Config), LoopConfig(**LOOP_KW), device="cpu"), seq),
            _drive(JSLAM(_cfg(JConfig), JLoopConfig(**LOOP_KW)), seq))


def test_loop_scene_matches_jax(engines):
    seq, a, b = engines
    assert len(a.keyframes) == len(b.keyframes) > LOOP_KW["exclude_recent"] + 2
    assert a.n_loops_closed == b.n_loops_closed == 1 and a.n_rebuilds == b.n_rebuilds == 1
    assert [k.scan_index for k in a.keyframes] == [k.scan_index for k in b.keyframes]
    assert [e[:2] for e in a.loop_edges] == [e[:2] for e in b.loop_edges]
    np.testing.assert_allclose(a.loop_edges[0][3], b.loop_edges[0][3], atol=2e-3)
    ka, kb = (np.array([k.pos for k in e.keyframes]) for e in (a, b))
    np.testing.assert_allclose(ka, kb, rtol=0, atol=2e-3)
    np.testing.assert_allclose(a.positions(), b.positions(), rtol=0, atol=2e-3)
    for k, j in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(k.desc != 0, np.asarray(j.desc) != 0)
        np.testing.assert_allclose(k.ring_key, j.ring_key, atol=1e-7)
    gt = seq.traj.pos(np.array([k.stamp for k in a.keyframes]))
    assert np.sqrt(np.mean(np.sum((ka - gt) ** 2, axis=1))) < 0.3
    # the rebuilt maps hold the same clouds at poses 2e-3 m apart: a point
    # on a bucket's edge may be admitted by one and not the other
    na, nb = int(a.loc.state.map.num_points), int(b.loc.state.map.num_points)
    assert abs(na - nb) <= 0.01 * nb


def test_state_queries_pass_through(engines):
    _, a, b = engines
    for name in ("get_world_state", "get_body_state"):
        got, want = getattr(a, name)(), getattr(b, name)()
        assert set(got) == set(want)
        np.testing.assert_allclose(got["pos"], np.asarray(want["pos"]), atol=2e-3)
    np.testing.assert_allclose(a.get_pose_covariance(), b.get_pose_covariance(), atol=1e-4)
    assert a.get_twist_covariance().shape == (6, 6) and len(a.stamps()) == N_SCANS


def test_sessions_load_across_packages(engines, tmp_path):
    _, a, b = engines
    pa, pb = str(tmp_path / "torch_session"), str(tmp_path / "jax_session")
    a.save_session(pa)
    b.save_session(pb)
    assert sorted(np.load(pa + ".keyframes.npz").files) == sorted(np.load(pb + ".keyframes.npz").files)
    a2 = SLAM(_cfg(Config), LoopConfig(**LOOP_KW), device="cpu")
    a2.load_session(pb)                               # a JAX session in the port
    b2 = JSLAM(_cfg(JConfig), JLoopConfig(**LOOP_KW))
    b2.load_session(pa)                               # the port's session in JAX
    for fresh, src in ((a2, b), (b2, a)):
        assert len(fresh.keyframes) == len(src.keyframes)
        assert [e[:2] for e in fresh.loop_edges] == [e[:2] for e in src.loop_edges]
        for k, j in zip(fresh.keyframes, src.keyframes):
            np.testing.assert_array_equal(np.asarray(k.pos), np.asarray(j.pos))
            np.testing.assert_array_equal(np.asarray(k.cloud), np.asarray(j.cloud))
            np.testing.assert_array_equal(np.asarray(k.rebuild_valid), np.asarray(j.rebuild_valid))
        assert int(fresh.loc.state.map.num_points) == int(src.loc.state.map.num_points)
        # (the JAX engine's corrected state is float64 under the tests' x64 mode)
        np.testing.assert_allclose(np.asarray(fresh.loc.state.P), np.asarray(src.loc.state.P),
                                   rtol=1e-6, atol=0)
    # relocalize the last keyframe's own cloud in the reloaded session
    kf = a.keyframes[-1]
    res = a2.relocalize_scan(kf.cloud, kf.cloud_valid, sc_thresh=0.5, icp_min_inliers=100)
    want = b.relocalize_scan(kf.cloud, kf.cloud_valid, sc_thresh=0.5, icp_min_inliers=100)
    assert res.success and want.success and res.keyframe_index == want.keyframe_index
    assert np.linalg.norm(res.pos - kf.pos) < 1.0
    r2, vel = a2.relocalize_bootstrap(kf.cloud, kf.cloud_valid, 0.0, kf.cloud, kf.cloud_valid, 0.2,
                                      sc_thresh=0.5, icp_min_inliers=100)
    assert r2.success and np.allclose(a2.loc.state.x.pos.numpy(), r2.pos, atol=1e-6)


def test_gps_priors_attach_and_correct_like_jax(engines):
    """GPS fixes between the circuit's keyframes (after the run, so no scan
    is replayed for it): both engines bind them to the same bracketing
    keyframes with the same α and chord-corrected targets, and the final
    smoothing moves the keyframes alike."""
    seq, a, b = engines
    stamps = [0.6 * a.keyframes[i].stamp + 0.4 * a.keyframes[i + 1].stamp for i in range(3, 9)]
    stamps.append(a.keyframes[10].stamp)               # lands on a keyframe: unary
    for e in (a, b):
        for ts in stamps:
            e.update_gps(ts, seq.traj.pos(np.asarray([ts]))[0], weight=20.0)
        assert e._gps_since_opt == len(stamps)
        e.flush()                                      # final smoothing
        assert e._gps_since_opt == 0 and not e._gps_buffer
    assert len(a.gps_factors) == len(b.gps_factors) == len(stamps)
    for fa, fb in zip(a.gps_factors, b.gps_factors):
        assert fa[0] == fb[0] and fa[2] == fb[2] == 20.0
        assert fa[3] == pytest.approx(fb[3], abs=1e-9)
        np.testing.assert_allclose(fa[1], fb[1], atol=2e-3)
    assert a.gps_factors[-1][3] == 0.0 and 0.3 < a.gps_factors[0][3] < 0.5
    ka, kb = (np.array([k.pos for k in e.keyframes]) for e in (a, b))
    np.testing.assert_allclose(ka, kb, rtol=0, atol=2e-3)
    gt = seq.traj.pos(np.array([k.stamp for k in a.keyframes]))
    assert np.sqrt(np.mean(np.sum((ka - gt) ** 2, axis=1))) < 0.15


def test_rebuild_keeps_insert_density():
    """The non-slow shape of tests/test_slam.py: the rebuild uses the
    near-insert-density rebuild clouds; legacy keyframes fall back to the
    ICP clouds.  Same map sizes as the JAX engine from the same keyframes."""
    from fast_limo_tpu.models import pipeline as jpl
    from fast_limo_tpu_torch.models import pipeline as pl

    lc = dict(icp_points=256, rebuild_points=4096, rebuild_batch=4)
    a = SLAM(_cfg(Config), LoopConfig(**lc), device="cpu")
    b = JSLAM(_cfg(JConfig), JLoopConfig(**lc))
    a.loc.state, b.loc.state = pl.init_state(a.cfg, "cpu"), jpl.init_state(b.cfg)
    rng = np.random.default_rng(0)
    for k in range(5):
        d = dict(index=k, stamp=float(k), pos=np.array([4.0 * k, 0, 0]),
                 quat=np.array([1.0, 0, 0, 0]), desc=np.zeros((20, 60), np.float32),
                 ring_key=np.zeros(20, np.float32),
                 cloud=rng.uniform(-20, 20, (256, 3)).astype(np.float32),
                 cloud_valid=np.ones(256, bool),
                 rebuild_cloud=rng.uniform(-20, 20, (4096, 3)).astype(np.float32),
                 rebuild_valid=np.ones(4096, bool))
        a.keyframes.append(Keyframe(**d))
        b.keyframes.append(JKeyframe(**d))
    sizes = []
    for legacy in (False, True):
        for e in (a, b):
            if legacy:
                for kf in e.keyframes:
                    kf.rebuild_cloud = kf.rebuild_valid = None
            e._rebuild_snapshot = None
            e._rebuild_map()
        sizes.append((int(a.loc.state.map.num_points), int(b.loc.state.map.num_points)))
    assert sizes[0][0] == sizes[0][1] and sizes[1][0] == sizes[1][1]
    assert sizes[1][0] > 0 and sizes[0][0] > 2 * sizes[1][0], sizes


def test_keyframe_cap_thins_like_jax():
    lc = dict(max_keyframes=12, exclude_recent=3, kf_dist=1.0)
    a, b = SLAM(_cfg(Config), LoopConfig(**lc), device="cpu"), JSLAM(_cfg(JConfig), JLoopConfig(**lc))
    for k in range(20):
        d = dict(index=k, stamp=float(k), pos=np.array([0.7 * k, 0.1 * (k % 3), 0.0]),
                 quat=np.array([1.0, 0, 0, 0]), desc=np.zeros((20, 60), np.float32),
                 ring_key=np.zeros(20, np.float32), cloud=np.zeros((4, 3), np.float32),
                 cloud_valid=np.ones(4, bool))
        a.keyframes.append(Keyframe(**d))
        b.keyframes.append(JKeyframe(**d))
    for e in (a, b):
        e.loop_edges = [(2, 15, np.array([1.0, 0, 0, 0]), np.zeros(3))]
        e.gps_factors = [(5, np.zeros(3), 1.0, 0.4)]
        e._enforce_keyframe_cap()
    assert [k.stamp for k in a.keyframes] == [k.stamp for k in b.keyframes]
    assert len(a.keyframes) <= 12 and a.loop_edges[0][:2] == b.loop_edges[0][:2]
    assert a.gps_factors[0][0] == b.gps_factors[0][0]


# ------------------------------------------------------------------ the CLI

def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out, dump, sess = (str(tmp_path / n) for n in ("t.tum", "d.npz", "sess"))
    rc = cli.main(["--device", "cpu", "--out", out, "synthetic", "--scans", "5",
                   "--debug-dump", dump, "--save-session", sess])
    text = capsys.readouterr().out
    info = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    assert not rc and info["scans"] == 5 and info["ate_m"] < 0.15 and info["loops"] == 0
    assert len(open(out).read().splitlines()) == 5
    from fast_limo_tpu_torch.models import pipeline as pl

    d = np.load(dump)
    assert set(pl.DebugOutput._fields) <= set(d.files) and d["match_planes"].ndim == 2
    assert np.load(sess + ".keyframes.npz")["n"] >= 1
    # options after the subcommand, odometry only, chunked, async
    rc = cli.main(["synthetic", "--scans", "4", "--device", "cpu", "--no-loop", "--chunk", "2",
                   "--debug-dump", dump])
    info = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")][-1])
    assert not rc and info["scans"] == 4 and np.load(dump)["match_planes"].ndim == 2
    rc = cli.main(["synthetic", "--scans", "3", "--device", "cpu", "--async",
                   "--load-session", sess])
    assert not rc and "ate_m" in capsys.readouterr().out


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(Config)
    from fast_limo_tpu_torch.models import posegraph
    from fast_limo_tpu_torch.models.localizer import Localizer

    for make in (lambda: Localizer(cfg), lambda: Localizer(cfg, split_body=True),
                 lambda: SLAM(cfg), lambda: posegraph.create(8, 8),
                 lambda: rl.relocalize(np.zeros((4, 3), np.float32), np.ones(4, bool), [None]),
                 lambda: cli.main(["synthetic", "--scans", "2"]),
                 lambda: cli.main(["kitti", "--drive", "x"]),
                 lambda: cli.main(["sequence", "--data", "x"]),
                 lambda: cli.main(["make-synthetic", "--dir", "x"])):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    with pytest.raises(SystemExit):                    # the JAX option is gone
        cli.main(["--platform", "cpu", "synthetic"])
