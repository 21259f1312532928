"""K3 (plane fit), K4 (H statistics) and the measurement model: the port's
plain versions against the JAX package on the same numpy-seeded inputs.

Tolerances:
* K3: gates agree on ≥ 99.5 % of queries (the TPU kernel's Hastings
  arccos is 2e-7 rad off acos); coefficients rtol 5e-3 / atol 5e-4 where
  both pass (tests/test_plane_kernel.py); gated rows exactly zero.
* K4: rtol 1e-5 (tests/test_hstats.py) plus atol 1e-6·max|HᵀH| for
  entries that are sums of cancelling terms.
* make_h_model: the same branch is taken (window / stale patch / full
  re-match, chosen from the same stale count — on the device in the port,
  whose ``last_branch`` is the () int32 code 0 / 1 / 2) and HᵀH, Hᵀh agree
  to 1e-4·max — the fits differ in float32 summation order only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu.models import measurement as jmeas
from fast_limo_tpu.models import state as jst
from fast_limo_tpu.ops import hstats as jhs
from fast_limo_tpu.ops import plane_kernel as jpk
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.models import measurement as meas
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import hstats, plane_kernel


def _plane_nbrs(rng, N=1000, k=5):
    """Neighbour sets on noisy local planes (some outliers, some invalid)."""
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c = rng.uniform(-20, 20, (N, 3))
    t1 = np.cross(n, [0.3, 0.5, 0.8])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    a, b = rng.uniform(-0.6, 0.6, (2, N, k, 1))
    pts = c[:, None] + a * t1[:, None] + b * t2[:, None]
    noise = rng.normal(0, 0.01, (N, k))
    noise[rng.random((N, k)) < 0.05] *= 20
    pts = pts + noise[..., None] * n[:, None]
    sq = np.sort(rng.uniform(0.01, 6.0, (N, k)), axis=1)
    valid = rng.random((N, k)) < 0.95
    return np.float32(pts), np.float32(sq), valid


@pytest.mark.parametrize("kw", [dict(num_match_points=5, max_dist_plane=5.0, plane_threshold=0.1),
                                dict(num_match_points=3, max_dist_plane=2.0, plane_threshold=0.05)])
def test_plain_k3_matches_jax_kernel(rng, kw):
    pts, sq, valid = _plane_nbrs(rng)
    got_n, got_g = (a.numpy() for a in plane_kernel.fit_planes(
        torch.tensor(pts), torch.tensor(sq), torch.tensor(valid), **kw))
    want_n, want_g = (np.asarray(a) for a in jpk.fit_planes_tpu(
        jnp.asarray(pts), jnp.asarray(sq), jnp.asarray(valid), interpret=True, **kw))
    assert np.mean(got_g == want_g) >= 0.995
    both = got_g & want_g
    assert both.sum() > 100
    np.testing.assert_allclose(got_n[both], want_n[both], rtol=5e-3, atol=5e-4)
    assert np.all(got_n[~got_g] == 0.0)


def _pose(rng):
    q = rng.normal(size=4)
    qe = np.array([1.0, 0.01, -0.02, 0.005])
    return {"pos": rng.normal(size=3), "rot": q / np.linalg.norm(q),
            "rot_LI": qe / np.linalg.norm(qe), "t_LI": np.array([0.1, -0.2, 0.3]),
            "vel": np.zeros(3), "bg": np.zeros(3), "ba": np.zeros(3),
            "grav": np.array([0.0, 0.0, -9.809])}


def _ts(d):
    return st.NavState(**{k: torch.tensor(np.float32(v)) for k, v in d.items()})


def _js(d):
    return jst.NavState(**{k: jnp.asarray(np.float32(v)) for k, v in d.items()})


@pytest.mark.parametrize("ee", [True, False])
def test_plain_k4_matches_jax_kernel(rng, ee):
    pc = np.float32(rng.uniform(-20, 20, (500, 3)))
    n = rng.normal(size=(500, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n_abcd = np.float32(np.concatenate([n, rng.normal(size=(500, 1))], axis=1))
    keep = rng.random(500) < 0.8
    x = _pose(rng)
    Xj = jhs.pack_inputs(jnp.asarray(pc), jnp.asarray(n_abcd), jnp.asarray(keep))
    want = jhs.hstats_tpu(Xj, jhs.pack_scalars(_js(x)), estimate_extrinsics=ee,
                          interpret=True)
    X = hstats.pack_inputs(torch.tensor(pc), torch.tensor(n_abcd), torch.tensor(keep))
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj).reshape(-1))
    got = hstats.hstats(X, hstats.pack_scalars(_ts(x)), estimate_extrinsics=ee)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


# ------------------------------------------------------------ measurement

VOXEL, K = 1.2, 5


def _scene(rng, bucket=6, cap=8192):
    """A map of noisy planes in both packages (identical by construction:
    tests/test_torch_voxel_mapper.py) and body-frame queries near them."""
    g = rng.uniform(-9, 9, (6000, 3))
    g[:3000, 2] = rng.normal(0, 0.02, 3000)
    g[3000:4500, 1] = 4.0 + rng.normal(0, 0.02, 1500)
    g[4500:, 0] = -5.0 + 0.2 * g[4500:, 2] + rng.normal(0, 0.02, 1500)
    world = np.float32(g)
    tm = mp.insert(mp.create(cap, bucket), torch.tensor(world),
                   torch.ones(len(world), dtype=torch.bool), voxel_size=VOXEL)
    jm = jmp.insert(jmp.create(cap, bucket), jnp.asarray(world),
                    jnp.ones(len(world), bool), voxel_size=VOXEL)
    x0 = _pose(rng)
    x0["rot"] = np.array([np.cos(0.15), 0.0, 0.0, np.sin(0.15)])
    sel = world[rng.choice(len(world), 640, replace=False)]
    R = np.asarray(jst.so3.quat_to_mat(jnp.asarray(np.float32(x0["rot"]))), np.float64)
    pc = np.float32((sel - x0["pos"]) @ R + rng.normal(0, 0.01, sel.shape))
    pc_valid = rng.random(len(pc)) < 0.97
    return tm, jm, x0, pc, pc_valid


def _models(scene, budget):
    tm, jm, x0, pc, pc_valid = scene
    kw = dict(voxel_size=VOXEL, k=K, max_dist_plane=2.0, plane_threshold=0.1,
              max_num_matches=500, estimate_extrinsics=True, dynamic_gate=4.0,
              stale_budget=budget)
    th = meas.make_h_model(tm, torch.tensor(pc), torch.tensor(pc_valid), x0=_ts(x0), **kw)
    _, jh = jmeas.make_h_model(jm, jnp.asarray(pc), jnp.asarray(pc_valid), x0=_js(x0),
                               probes=4, knn_refresh="first", **kw)
    return th, jh


@pytest.mark.parametrize("shift,budget,branch", [(0.0, 128, "window"),
                                                 (0.35, 640, "patched"),
                                                 (0.35, 1, "full")])
def test_make_h_model_branches_match_jax(rng, shift, budget, branch):
    scene = _scene(rng)
    th, jh = _models(scene, budget)
    x = dict(scene[2])
    x["pos"] = x["pos"] + np.array([shift, -0.6 * shift, 0.1 * shift])
    HTH, HTh = th.stats(_ts(x))
    assert th.last_branch.dtype == torch.int32
    assert int(th.last_branch) == ("window", "patched", "full").index(branch)
    jHTH, jHTh = (np.asarray(a) for a in jh(_js(x)))
    np.testing.assert_allclose(HTH.numpy(), jHTH, rtol=0, atol=1e-4 * np.abs(jHTH).max())
    np.testing.assert_allclose(HTh.numpy(), jHTh, rtol=0, atol=1e-4 * np.abs(jHTh).max())
    assert np.abs(jHTH).max() > 0
