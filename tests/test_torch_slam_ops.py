"""The SLAM layer's plain modules against the JAX package: ops/se3,
ops/geometry, models/scancontext, models/icp (and the closed-form 3×3
pieces of ops/plane that icp.estimate_normals uses).

The same numpy inputs from a seed go through both packages.  Tolerances:
se3/geometry 1e-5 (float32 rounding; exact small-angle branches at the
identity); ScanContext descriptors, best shift and retrieval order exact
on a structured two-wall scene (ring keys to one ulp of the mean,
distances 1e-5); ICP poses and normals (up to sign) within 1e-4, RMSE
within 5e-4 (the expanded square |a|²+|b|²−2a·b carries ~2e-5 m² of
float32 cancellation noise at these ranges), on ≤ 512-point clouds whose
nearest neighbours are well separated — the index arrays are not compared
(the expanded square rounds differently under XLA-CPU's FMA contraction),
inlier counts are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import icp as jicp
from fast_limo_tpu.models import scancontext as jsc
from fast_limo_tpu.ops import geometry as jgeo
from fast_limo_tpu.ops import plane as jplane
from fast_limo_tpu.ops import se3 as jse3
from fast_limo_tpu_torch.models import icp, scancontext
from fast_limo_tpu_torch.ops import geometry, plane, se3

from test_loop import ring_scene, yaw_rot


def _t(a):
    return torch.tensor(np.float32(a))


def _j(a):
    return jnp.asarray(np.float32(a))


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return np.float32(q / np.linalg.norm(q, axis=1, keepdims=True))


# ------------------------------------------------------------ se3, geometry

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_se3_exp_log_match_jax(scale):
    rng = np.random.default_rng(1)
    xi = np.float32(rng.normal(size=(16, 6)) * scale)
    (q, t), (qj, tj) = se3.exp(_t(xi)), jse3.exp(_j(xi))
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-6)
    np.testing.assert_allclose(se3.log(q, t).numpy(), np.asarray(jse3.log(qj, tj)), atol=1e-5)
    np.testing.assert_allclose(se3.log(q, t).numpy(), xi, atol=2e-5)


def test_se3_compose_inverse_and_geometry_match_jax():
    rng = np.random.default_rng(2)
    q1, q2 = _quats(rng, 8), _quats(rng, 8)
    t1, t2 = np.float32(rng.normal(size=(8, 3)) * 5), np.float32(rng.normal(size=(8, 3)) * 5)
    pts = np.float32(rng.normal(size=(8, 20, 3)) * 10)
    pairs = [
        (se3.compose(_t(q1), _t(t1), _t(q2), _t(t2)), jse3.compose(_j(q1), _j(t1), _j(q2), _j(t2))),
        (se3.inverse(_t(q1), _t(t1)), jse3.inverse(_j(q1), _j(t1))),
        (geometry.compose(_t(q1), _t(t1), _t(q2), _t(t2)),
         jgeo.compose(_j(q1), _j(t1), _j(q2), _j(t2))),
        (geometry.rt_inverse(_t(q1), _t(t1)), jgeo.rt_inverse(_j(q1), _j(t1))),
        ((geometry.rt_matrix(_t(q1), _t(t1)),), (jgeo.rt_matrix(_j(q1), _j(t1)),)),
        ((geometry.transform_points(_t(q1), _t(t1), _t(pts)),),
         (jgeo.transform_points(_j(q1), _j(t1), _j(pts)),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# -------------------------------------------------------------- scancontext

def _scene(seed, yaw=0.0, **kw):
    pts = ring_scene(np.random.default_rng(seed), 2000, **kw)
    return np.float32(pts @ yaw_rot(yaw).T)


SC = dict(n_ring=20, n_sector=60, max_radius=80.0, height_shift=2.0)


@pytest.mark.parametrize("yaw_sectors", [0, 4, 37])
def test_descriptor_ring_key_and_shift_match_jax(yaw_sectors):
    base = _scene(0)
    rot = _scene(0, yaw=yaw_sectors * 2 * np.pi / 60)
    valid = np.ones(len(base), bool)
    valid[::7] = False
    d = [scancontext.descriptor(_t(p), torch.tensor(valid), **SC) for p in (base, rot)]
    dj = [jsc.descriptor(_j(p), jnp.asarray(valid), **SC) for p in (base, rot)]
    for a, b in zip(d, dj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(scancontext.ring_key(a).numpy(), np.asarray(jsc.ring_key(b)),
                                   rtol=0, atol=1e-7)     # one float32 ulp of the mean
    (dist, shift), (dist_j, shift_j) = scancontext.distance(d[0], d[1]), jsc.distance(dj[0], dj[1])
    assert int(shift) == int(shift_j)
    np.testing.assert_allclose(float(dist), float(dist_j), atol=1e-5)
    yaw = scancontext.shift_to_yaw(int(shift), 60)
    assert yaw == pytest.approx(float(jsc.shift_to_yaw(shift_j, 60)), abs=1e-6)
    # the shift recovers the rotation to within one sector
    want_yaw = yaw_sectors * 2 * np.pi / 60
    wrap = [abs((yaw + sgn * want_yaw + np.pi) % (2 * np.pi) - np.pi) for sgn in (1, -1)]
    assert min(wrap) < 2 * np.pi / 60


def test_distance_over_a_database_and_retrieval_order_match_jax():
    places = [dict(w1_y=8.0 + 7 * s, w2_x=-12.0 - 6 * s) for s in range(5)]
    ones = torch.ones(2000, dtype=torch.bool)
    db = torch.stack([scancontext.descriptor(_t(_scene(s, **kw)), ones, **SC)
                      for s, kw in enumerate(places)])
    query = scancontext.descriptor(_t(_scene(9, yaw=0.4, **places[3])), ones, **SC)
    dists, shifts = scancontext.distance(query, db)          # all five at once
    for k in range(5):
        dk, sk = jsc.distance(jnp.asarray(query.numpy()), jnp.asarray(db[k].numpy()))
        one = scancontext.distance(query, db[k])
        assert int(shifts[k]) == int(sk) == int(one[1])
        np.testing.assert_allclose(float(dists[k]), float(dk), atol=1e-5)
    assert int(torch.argmin(dists)) == 3
    keys = scancontext.ring_key(db)
    kv = torch.tensor([True, True, False, True, True])
    got = scancontext.retrieve(scancontext.ring_key(query), keys, kv)
    want = jsc.retrieve(jnp.asarray(scancontext.ring_key(query).numpy()),
                        jnp.asarray(keys.numpy()), jnp.asarray(kv.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    order, order_j = (np.argsort(np.asarray(a), kind="stable").tolist() for a in (got, want))
    assert order == order_j
    assert np.isinf(got.numpy()[2])


# ---------------------------------------------------------------------- icp

def _clouds(seed, n=512, yaw=0.12, t=(0.4, -0.3, 0.1)):
    """A jittered grid on two walls and a floor (nearest neighbours well
    separated), and the same cloud seen from a pose offset by (yaw, t)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(-1, 2) * 1.5
    floor = np.c_[g - 12.0, np.full(len(g), -2.0)]
    wall1 = np.c_[g[:, 0] - 12.0, np.full(len(g), 9.0), g[:, 1] * 0.3 - 2.0]
    wall2 = np.c_[np.full(len(g), -11.0), g[:, 0] - 12.0, g[:, 1] * 0.3 - 2.0]
    dst = np.concatenate([floor, wall1, wall2])[rng.permutation(768)[:n]]
    dst = np.float32(dst + rng.normal(0, 0.05, dst.shape))
    src = np.float32((dst + rng.normal(0, 0.03, dst.shape) - np.float32(t))
                     @ yaw_rot(yaw))                             # p_dst ≈ R·p_src + t
    valid = np.ones(n, bool)
    valid[::11] = False
    return src, valid, dst, np.ones(n, bool)


def _assert_icp_close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat), atol=atol)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=atol)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=5e-4)
    assert int(got.n_inliers) == int(want.n_inliers)
    assert bool(got.converged) == bool(want.converged)
    assert got.n_inliers.dtype == torch.int32


@pytest.mark.parametrize("seeded", [False, True])
def test_icp_matches_jax(seeded):
    src, sv, dst, dv = _clouds(3)
    kw, jkw = {}, {}
    if seeded:
        q0 = np.float32([np.cos(0.05), 0, 0, np.sin(0.05)])
        kw = dict(init_quat=_t(q0), init_trans=_t([0.3, -0.2, 0.0]))
        jkw = dict(init_quat=_j(q0), init_trans=_j([0.3, -0.2, 0.0]))
    got = icp.icp(_t(src), torch.tensor(sv), _t(dst), torch.tensor(dv),
                  max_corr_dist=1.0, iters=15, **kw)
    want = jicp.icp(_j(src), jnp.asarray(sv), _j(dst), jnp.asarray(dv),
                    max_corr_dist=1.0, iters=15, **jkw)
    _assert_icp_close(got, want)
    np.testing.assert_allclose(got.trans.numpy(), [0.4, -0.3, 0.1], atol=0.02)


def test_plane_eig_pieces_match_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 3))
    M = np.float32(A @ A.transpose(0, 2, 1))
    M[:4] = np.float32(np.eye(3))[None] * np.float32([[[1.0]], [[2.0]], [[0.0]], [[5.0]]])
    got, want = plane._eigvals_sym3(_t(M)), jplane._eigvals_sym3(_j(M))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    (n, ok), (nj, okj) = plane._null_vector(_t(M), got[0]), jplane._null_vector(_j(M), want[0])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))


def test_normals_and_point_to_plane_match_jax():
    src, sv, dst, dv = _clouds(5, yaw=0.03, t=(0.15, -0.1, 0.05))
    nrm, ok = icp.estimate_normals(_t(dst), torch.tensor(dv), k=12, chunk=200)
    nrm_j, ok_j = jicp.estimate_normals(_j(dst), jnp.asarray(dv), k=12, chunk=256)
    ok, ok_j = ok.numpy(), np.asarray(ok_j)
    assert (ok == ok_j).mean() >= 0.99 and ok.sum() > 300
    both = ok & ok_j
    dots = np.abs(np.sum(nrm.numpy()[both] * np.asarray(nrm_j)[both], axis=1))
    assert dots.min() > 1.0 - 1e-4                  # equal up to sign
    # the refinement from the same normals
    q0, t0 = np.float32([1, 0, 0, 0]), np.float32([0.1, -0.05, 0.0])
    got = icp.icp_point_to_plane(_t(src), torch.tensor(sv), _t(dst), torch.tensor(dv),
                                 torch.tensor(np.asarray(nrm_j)), torch.tensor(ok_j),
                                 init_quat=_t(q0), init_trans=_t(t0), max_corr_dist=1.0, iters=8)
    want = jicp.icp_point_to_plane(_j(src), jnp.asarray(sv), _j(dst), jnp.asarray(dv),
                                   nrm_j, jnp.asarray(ok_j), init_quat=_j(q0), init_trans=_j(t0),
                                   max_corr_dist=1.0, iters=8)
    _assert_icp_close(got, want)
    np.testing.assert_allclose(got.trans.numpy(), [0.15, -0.1, 0.05], atol=0.03)
