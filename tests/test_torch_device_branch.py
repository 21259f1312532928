"""The scan step decides on the device: the whole-loop kernel's fallback
and the re-match branch are ``torch.where`` selects over fixed shapes, as
``lax.cond`` is in the JAX package, and nothing is read on the host.

At tiny shapes on the CPU, against the JAX package on the same numpy
inputs:

* ``update_iterated`` with K6's ``ok`` forced True and forced False (its
  plain version's flag flipped and its result moved off) returns K6's
  moved bits where ``ok`` and the JAX result where not (rtol 1e-3 / atol
  2e-4, ``chip_smoke.py`` phase 4's bounds: the two gain algebras differ
  in float32 order only);
* one scan step at ``cfg.debug`` off and on runs with ``Tensor.item``,
  ``__bool__``, ``__int__``, ``__float__`` and ``tolist`` patched to raise —
  the CPU stand-in for ``torch.cuda.set_sync_debug_mode("error")``;
* the three re-match branches (window, stale patch, full), chosen on the
  device, give the JAX ``h_debug`` (stale count exact, keep mask on ≥ 99 %
  of the queries, planes and distances 2e-3 where both keep the match —
  ``tests/test_torch_pipeline.py``'s rule), and an active flag that is set
  changes no bit;
* K2's entry (map table + ``mapper.block_rows``' row indices) is bit-equal
  on the CPU to ``gather_rows`` + ``topk_from_rows_reference``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as ge
from fast_limo_tpu.models import iekf as jiekf
from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu.models import measurement as jmeas
from fast_limo_tpu.models import state as jst
from fast_limo_tpu_torch.models import iekf
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.models import measurement as meas
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.ops import knn_rows, so3, update_loop
from fast_limo_tpu_torch.utils import presets
from fast_limo_tpu_torch.utils.config import Config

VOXEL, K = 1.2, 5


def _pose(rng):
    qe = np.array([1.0, 0.01, -0.02, 0.005])
    return {"pos": rng.normal(size=3), "rot": np.array([np.cos(0.15), 0.0, 0.0, np.sin(0.15)]),
            "rot_LI": qe / np.linalg.norm(qe), "t_LI": np.array([0.1, -0.2, 0.3]),
            "vel": np.zeros(3), "bg": np.zeros(3), "ba": np.zeros(3),
            "grav": np.array([0.0, 0.0, -9.809])}


def _ts(d):
    return st.NavState(**{k: torch.tensor(np.float32(v)) for k, v in d.items()})


def _js(d):
    return jst.NavState(**{k: jnp.asarray(np.float32(v)) for k, v in d.items()})


def _vec(x):
    return np.asarray(st.as_vector(x) if isinstance(x, st.NavState) else jst.as_vector(x))


@pytest.fixture(scope="module")
def scene():
    """Noisy planes in both packages' maps (equal by construction) and
    body-frame queries taken near them at the pose x0."""
    rng = np.random.default_rng(11)
    g = rng.uniform(-9, 9, (6000, 3))
    g[:3000, 2] = rng.normal(0, 0.02, 3000)
    g[3000:4500, 1] = 4.0 + rng.normal(0, 0.02, 1500)
    g[4500:, 0] = -5.0 + 0.2 * g[4500:, 2] + rng.normal(0, 0.02, 1500)
    world = np.float32(g)
    tm = mp.insert(mp.create(8192, 6), torch.tensor(world),
                   torch.ones(len(world), dtype=torch.bool), voxel_size=VOXEL)
    jm = jmp.insert(jmp.create(8192, 6), jnp.asarray(world), jnp.ones(len(world), bool),
                    voxel_size=VOXEL)
    x0 = _pose(rng)
    sel = world[rng.choice(len(world), 640, replace=False)]
    R = np.asarray(jst.so3.quat_to_mat(jnp.asarray(np.float32(x0["rot"]))), np.float64)
    pc = np.float32((sel - x0["pos"]) @ R + rng.normal(0, 0.01, sel.shape))
    return tm, jm, x0, pc, rng.random(len(pc)) < 0.97


def _models(scene, budget=128):
    tm, jm, x0, pc, pc_valid = scene
    kw = dict(voxel_size=VOXEL, k=K, max_dist_plane=2.0, plane_threshold=0.1,
              max_num_matches=500, estimate_extrinsics=True, dynamic_gate=4.0,
              stale_budget=budget)
    th = meas.make_h_model(tm, torch.tensor(pc), torch.tensor(pc_valid), x0=_ts(x0), **kw)
    _, jh, jdbg = jmeas.make_h_model(jm, jnp.asarray(pc), jnp.asarray(pc_valid), x0=_js(x0),
                                     probes=4, knn_refresh="first", with_debug=True, **kw)
    return th, jh, jdbg


@pytest.mark.parametrize("force_ok", [True, False])
def test_update_iterated_takes_either_branch_on_the_device(scene, monkeypatch, force_ok):
    """K6's result where ``ok``, the exact loop's where not.  K6's plain
    result is moved off (pos + 0.25 m, P doubled), so the two outcomes are
    told apart: where ``ok`` the update returns those moved bits, where not
    it returns the loop's, which agree with the JAX update (its CPU program
    runs the exact loop)."""
    th, jh, _ = _models(scene)
    plain = update_loop.update_loop_plain
    moved = {}

    def forced(*a, **kw):
        x, P, aux = plain(*a, **kw)
        aux = aux.clone()
        aux[1] = 1.0 if force_ok else 0.0
        moved["x"] = x._replace(pos=x.pos + torch.tensor([0.25, 0.0, 0.0]))
        moved["P"] = 2.0 * P
        return moved["x"], moved["P"], aux

    monkeypatch.setattr(update_loop, "update_loop_plain", forced)
    x0 = dict(scene[2])
    x0["pos"] = x0["pos"] + np.array([0.03, -0.02, 0.01])
    P = np.float32(np.diag(np.r_[np.full(6, 1e-3), np.full(17, 1e-5)]))
    xt, Pt, nt, dg = iekf.update_iterated(_ts(x0), torch.tensor(P), th, R=1e-3, D=5.0,
                                          max_iters=3, limit=1e-3, with_diag=True)
    xj, Pj, nj = jiekf.update_iterated(_js(x0), jnp.asarray(P), jh, R=1e-3, D=5.0,
                                       max_iters=3, limit=1e-3)
    assert dg["loop_fallback"].dtype == torch.bool and bool(dg["loop_fallback"]) is not force_ok
    assert int(nt) == int(nj)
    assert np.abs(_vec(moved["x"]) - _vec(xj)).max() > 0.2
    if force_ok:
        np.testing.assert_array_equal(_vec(xt), _vec(moved["x"]))
        np.testing.assert_array_equal(Pt.numpy(), moved["P"].numpy())
    else:
        np.testing.assert_allclose(_vec(xt), _vec(xj), rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-3, atol=2e-4)


def _tiny_cfg():
    """``__graft_entry__._tiny_cfg`` in the port's Config."""
    src, out = ge._tiny_cfg(), Config()
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        setattr(out, f.name, dataclasses.replace(v) if dataclasses.is_dataclass(v) else v)
    return out


@pytest.fixture(scope="module")
def steady_scan():
    """(cfg, the state before scan 3 of a tiny replay, its two packs)."""
    cfg = _tiny_cfg()
    loc = Localizer(cfg, device="cpu")
    held, step = [], loc.scan_step

    def grab(s, scan_pack, imu_pack):
        held.append((s, scan_pack.clone(), imu_pack.clone()))
        return step(s, scan_pack, imu_pack)

    loc.scan_step = grab
    presets.replay(loc, presets.bench_sequence(seed=7, n_scans=4, points_per_scan=512))
    return cfg, held[3]


@pytest.mark.parametrize("debug", [False, True])
def test_scan_step_reads_nothing_on_the_host(steady_scan, monkeypatch, debug):
    cfg, (s, scan_pack, imu_pack) = steady_scan
    cfg.debug = debug
    step = pl.build_scan_step(cfg, "cpu")
    batch = pl._pack_reader(cfg, "cpu", 4)(scan_pack, imu_pack)

    def read(*a, **kw):
        raise AssertionError("the scan step read a tensor on the host")

    with monkeypatch.context() as mpatch:
        for name in ("item", "__bool__", "__int__", "__float__", "tolist"):
            mpatch.setattr(torch.Tensor, name, read)
        s2, out = step(s, batch)
    assert torch.isfinite(out.pos).all() and torch.isfinite(s2.P).all()
    assert (out.debug is not None) is debug
    if debug:
        assert out.debug.n_stale.dtype == torch.int32
        assert out.debug.loop_fallback.dtype == torch.bool


@pytest.mark.parametrize("shift,budget,branch", [(0.0, 128, 0), (0.35, 640, 1), (0.35, 1, 2)])
def test_rematch_branch_chosen_on_the_device(scene, shift, budget, branch):
    th, _, jdbg = _models(scene, budget)
    x = dict(scene[2])
    x["pos"] = x["pos"] + np.array([shift, -0.6 * shift, 0.1 * shift])
    n_abcd, keep, dist, viol = th.debug(_ts(x))
    assert th.last_branch.dtype == torch.int32 and int(th.last_branch) == branch
    glob = so3.quat_rotate(_ts(x).rot, th.pc) + _ts(x).pos
    flagged = th.rematch(glob, active=torch.tensor(True))
    assert torch.equal(flagged[0], n_abcd) and torch.equal(flagged[1], keep)
    jn, jkeep, jdist, jstale = (np.asarray(a) for a in jdbg(_js(x)))
    assert viol.dtype == torch.int32 and int(viol) == int(jstale)
    kg = keep.numpy()
    assert (kg == jkeep).mean() >= 0.99 and kg.sum() > 50
    both = kg & jkeep
    np.testing.assert_allclose(n_abcd.numpy()[both], jn[both], atol=2e-3)
    np.testing.assert_allclose(dist.numpy()[both], jdist[both], atol=2e-3)


@pytest.mark.parametrize("nbh", [8, -27])
@pytest.mark.parametrize("k", [5, 12])
def test_k2_table_entry_equals_gathered_rows(scene, nbh, k):
    tm, _, x0, pc, _ = scene
    q = so3.quat_rotate(_ts(x0).rot, torch.tensor(pc)) + _ts(x0).pos
    row_idx, ncb, _ = mp.block_rows(tm, q, voxel_size=VOXEL, neighborhood=nbh)
    assert row_idx.dtype == torch.int32 and row_idx.shape == ncb.shape[:2]
    got = knn_rows.topk_from_table(tm.ptable, row_idx, ncb, q, E=mp.E, B=tm.bucket, k=k,
                                   active=torch.tensor(True))
    rows, ncb2, _ = mp.gather_rows(tm, q, voxel_size=VOXEL, neighborhood=nbh)
    want = knn_rows.topk_from_rows_reference(rows, ncb2, q, E=mp.E, B=tm.bucket, k=k)
    assert torch.equal(ncb, ncb2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[2].any())
