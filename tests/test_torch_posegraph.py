"""models/posegraph of the port against the JAX package: graph stores,
residuals, forward-mode Jacobians (including at the identity, where the
small-angle branches rule), and ``optimize`` with the dense and the chain
solver, a loop edge, interpolated priors (α > 0) and both Huber kernels.
The same numpy graph (≤ 32 nodes) goes through both; poses agree within
1e-4, Jacobians within 1e-5, costs within rtol 1e-3 + 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import posegraph as jpg
from fast_limo_tpu_torch.models import posegraph as pg
from fast_limo_tpu_torch.utils import interop


def _yaw_quat(a):
    return np.stack([np.cos(a / 2), 0 * a, 0 * a, np.sin(a / 2)], -1)


def _qmul(q, p):
    qw, qx, qy, qz = q.T
    pw, px, py, pz = p.T
    return np.stack([qw * pw - qx * px - qy * py - qz * pz, qw * px + qx * pw + qy * pz - qz * py,
                     qw * py - qx * pz + qy * pw + qz * px, qw * pz + qx * py - qy * px + qz * pw], -1)


def _rot(q, v):
    t = 2.0 * np.cross(q[:, 1:], v)
    return v + q[:, :1] * t + np.cross(q[:, 1:], t)


def _circle_graph(K=12, noise=0.3, seed=0):
    """A closed circuit: exact relative-pose edges (chain + one loop edge
    K−1 → 0), noisy initial positions, two priors (one interpolated)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    qs = _yaw_quat(ang)
    ts = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.1 * np.sin(3 * ang)], -1)
    ei = np.r_[np.arange(K - 1), K - 1]
    ej = np.r_[np.arange(1, K), 0]
    qi_inv = qs[ei] * np.array([1.0, -1, -1, -1])
    eq, et = _qmul(qi_inv, qs[ej]), _rot(qi_inv, ts[ej] - ts[ei])
    init_t = ts + rng.normal(0, noise, ts.shape)
    init_t[0] = ts[0]
    ew = np.r_[np.ones(K - 1), 5.0]
    priors = dict(prior_idx=[3, 7], prior_pos=[0.7 * ts[3] + 0.3 * ts[4], ts[7]],
                  prior_weight=[2.0, 1.0], prior_alpha=[0.3, 0.0])
    return (qs, init_t, ei, ej, eq, et, ew), priors, ts


@pytest.fixture(scope="module")
def graphs():
    args, priors, ts = _circle_graph()
    return jpg.from_arrays(*args, **priors), pg.from_arrays(*args, **priors, device="cpu"), ts


def test_from_arrays_and_interop_match_jax(graphs):
    gj, gt, _ = graphs
    for f in gj._fields:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    back = interop.posegraph_from_numpy({f: np.asarray(getattr(gj, f)) for f in gj._fields}, "cpu")
    for f, a in interop.posegraph_to_numpy(back).items():
        np.testing.assert_array_equal(a, getattr(gt, f).numpy(), err_msg=f)


def test_incremental_build_matches_jax():
    gj, gt = jpg.create(8, 8, 4), pg.create(8, 8, 4, device="cpu")
    rng = np.random.default_rng(1)
    for k in range(3):
        q = np.float32(_yaw_quat(np.array(0.2 * k)))
        t = np.float32(rng.normal(size=3))
        gj, gt = jpg.add_node(gj, jnp.asarray(q), jnp.asarray(t)), pg.add_node(gt, q, t)
    gj = jpg.add_edge(gj, 0, 1, jnp.asarray(q), jnp.asarray(t), 2.0)
    gt = pg.add_edge(gt, 0, 1, q, t, 2.0)
    gj = jpg.add_prior(gj, 2, jnp.asarray(t), 3.0, 0.25)
    gt = pg.add_prior(gt, 2, t, 3.0, 0.25)
    for f in gj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gj, f)), getattr(gt, f).numpy(), err_msg=f)


@pytest.mark.parametrize("at_identity", [False, True])
def test_residuals_and_jacobians_match_jax(at_identity):
    rng = np.random.default_rng(2)
    E = 6

    def quats():
        if at_identity:
            return np.float32(np.tile([1.0, 0, 0, 0], (E, 1)))
        q = rng.normal(size=(E, 4))
        return np.float32(q / np.linalg.norm(q, axis=1, keepdims=True))

    qi, qj = quats(), quats()
    ti = np.float32(rng.normal(size=(E, 3)) * (0 if at_identity else 3))
    tj = np.float32(ti if at_identity else rng.normal(size=(E, 3)) * 3)
    # the measurement equals the relative pose at the identity case: r = 0,
    # every small-angle branch taken
    qm = quats() if not at_identity else qi
    tm = np.float32(rng.normal(size=(E, 3))) if not at_identity else np.zeros((E, 3), np.float32)
    args = (qi, ti, qj, tj, qm, tm)
    r, Ji, Jj = pg._residual_and_jacobians(pg._edge_residual, tuple(torch.tensor(a) for a in args))
    z = jnp.zeros(6, jnp.float32)
    axes = (0,) * 6 + (None, None)
    jargs = tuple(jnp.asarray(a) for a in args)
    rj = jax.vmap(jpg._edge_residual, in_axes=axes)(*jargs, z, z)
    Jij = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=6), in_axes=axes)(*jargs, z, z)
    Jjj = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=7), in_axes=axes)(*jargs, z, z)
    assert r.dtype == Ji.dtype == torch.float32 and Ji.shape == (E, 6, 6)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Jij), atol=1e-5)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jjj), atol=1e-5)
    assert np.isfinite(Ji.numpy()).all() and np.isfinite(Jj.numpy()).all()

    alpha = np.float32(rng.uniform(0, 0.9, E))
    pm = np.float32(rng.normal(size=(E, 3)))
    pargs = (qi, ti, qj, tj, alpha, pm)
    rp, Ja, Jb = pg._residual_and_jacobians(pg._prior_residual, tuple(torch.tensor(a) for a in pargs))
    jp = tuple(jnp.asarray(a) for a in pargs)
    np.testing.assert_allclose(
        rp.numpy(), np.asarray(jax.vmap(jpg._prior_residual, in_axes=axes)(*jp, z, z)), atol=1e-5)
    for g, n in ((Ja, 6), (Jb, 7)):
        w = jax.vmap(jax.jacfwd(jpg._prior_residual, argnums=n), in_axes=axes)(*jp, z, z)
        assert g.shape == (E, 3, 6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("solver,robust", [("dense", 0.0), ("dense", 0.5), ("chain", 0.5)])
def test_optimize_matches_jax(graphs, solver, robust):
    gj, gt, ts = graphs
    kw = dict(iters=6, solver=solver, robust_delta=robust, robust_delta_priors=robust)
    oj, cj = jpg.optimize(gj, **kw)
    ot, ct = pg.optimize(gt, **kw)
    np.testing.assert_allclose(ot.trans.numpy(), np.asarray(oj.trans), atol=1e-4)
    np.testing.assert_allclose(ot.quat.numpy(), np.asarray(oj.quat), atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-9)
    assert ct.shape == (6,) and float(ct[-1]) < 1e-3 * float(ct[0])
    # the loop edge and the priors pull the noisy circuit back onto the truth
    assert np.abs(ot.trans.numpy()[:12] - ts).max() < 0.02
    np.testing.assert_array_equal(ot.trans.numpy()[0], gt.trans.numpy()[0])      # gauge


def test_corrupted_edge_with_and_without_huber_matches_jax():
    args, priors, ts = _circle_graph(noise=0.05, seed=3)
    args[5][4] += np.array([3.0, -2.0, 0.5])            # one corrupted odometry edge
    gj, gt = jpg.from_arrays(*args, **priors), pg.from_arrays(*args, **priors, device="cpu")
    for delta in (0.0, 0.5):
        kw = dict(iters=6, solver="dense", robust_delta=delta, robust_delta_priors=delta)
        oj, _ = jpg.optimize(gj, **kw)
        ot, _ = pg.optimize(gt, **kw)
        np.testing.assert_allclose(ot.trans.numpy(), np.asarray(oj.trans), atol=2e-4)
        np.testing.assert_allclose(ot.quat.numpy(), np.asarray(oj.quat), atol=2e-4)


def test_auto_solver_rule():
    """"auto": chain on a CPU tensor above 128 nodes of capacity, dense at
    or under it (and dense on any CUDA tensor)."""
    args, priors, _ = _circle_graph(K=10, noise=0.1, seed=4)
    calls = []
    orig = pg._chain_solve
    pg._chain_solve = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        small = pg.from_arrays(*args, **priors, device="cpu")
        big = pg.from_arrays(*args, **priors, max_nodes=256, device="cpu")
        a, _ = pg.optimize(small, iters=2)
        assert not calls
        b, _ = pg.optimize(big, iters=2)
        assert len(calls) == 2
    finally:
        pg._chain_solve = orig
    np.testing.assert_allclose(a.trans.numpy()[:10], b.trans.numpy()[:10], atol=1e-4)
