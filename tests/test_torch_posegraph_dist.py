"""The port's edge-sharded pose graph (``posegraph.optimize_distributed``
on the in-process backend, 4 ranks on the CPU) against its own
single-rank ``optimize`` and the JAX package's ``optimize_distributed``
on the 4-device virtual mesh: twins of tests/test_gps.py:121-139 (a
drifted chain with two GPS priors, 8 iterations) and
tests/test_loop.py:263-285 (a noisy 6-node chain, 5 iterations).
Bounds: theirs (trans within 1e-4, costs within rtol 1e-4) against the
port's single rank; against the JAX package the port's own
tests/test_torch_posegraph.py bounds (trans 1e-4, costs rtol 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import posegraph as jpg
from fast_limo_tpu.parallel import sharded as jsh
from fast_limo_tpu_torch.models import posegraph as pg
from fast_limo_tpu_torch.ops import so3
from fast_limo_tpu_torch.parallel import sharded
from fast_limo_tpu_torch.utils import interop

from test_gps import _chain_with_drift
from test_loop import _rel


def _gps_graph():
    g, true_pos, _ = _chain_with_drift()
    for k in (3, 7):
        g = jpg.add_prior(g, k, jnp.asarray(true_pos[k], jnp.float32), 50.0)
    return g


def _loop_graph():
    g = jpg.create(8, 16)
    rng = np.random.default_rng(1)
    poses = [(np.array([1.0, 0, 0, 0]), np.array([float(k), 0.1 * k, 0])) for k in range(6)]
    for q, t in poses:
        g = jpg.add_node(g, jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32))
    for k in range(1, 6):
        qr, tr = _rel(poses[k - 1], poses[k])
        g = jpg.add_edge(g, k - 1, k, jnp.asarray(qr, jnp.float32),
                         jnp.asarray(tr + rng.normal(0, 0.05, 3), jnp.float32))
    return g


@pytest.mark.parametrize("make,iters", [(_gps_graph, 8), (_loop_graph, 5)],
                         ids=["gps_chain", "loop_chain"])
def test_distributed_matches_single_and_jax(make, iters):
    jg = make()
    g = interop.posegraph_from_numpy({f: np.asarray(getattr(jg, f)) for f in jg._fields}, "cpu")
    g1, c1 = pg.optimize(g, iters=iters)
    mesh = sharded.make_mesh(4)
    g2, c2 = pg.optimize_distributed(g, mesh, iters=iters, axis="map")
    np.testing.assert_allclose(g2.trans.numpy(), g1.trans.numpy(), atol=1e-4)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=1e-4)
    assert mesh.received(0)["posegraph_psum_bytes"] > 0
    jg2, jc2 = jpg.optimize_distributed(jg, jsh.make_mesh(4), iters=iters, axis="map")
    np.testing.assert_allclose(g2.trans.numpy(), np.asarray(jg2.trans), atol=1e-4)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), rtol=1e-3, atol=1e-9)


def test_edge_slices_cover_the_edges():
    g = interop.posegraph_from_numpy(
        {f: np.asarray(getattr(_loop_graph(), f)) for f in jpg.PoseGraph._fields}, "cpu")
    parts = [pg.edge_slice(g, r, 4) for r in range(4)]
    for f in ("edge_i", "edge_j", "edge_quat", "edge_trans", "edge_weight"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]), getattr(g, f))
    assert all(torch.equal(p.trans, g.trans) for p in parts)
    with pytest.raises(ValueError, match="not divisible"):
        pg.optimize_distributed(g, sharded.make_mesh(3), iters=1)


def _ring_graph(noise=1.0, n=61, loops=7, dtype=torch.float32):
    """A loop of ``n`` poses on a 10 m circle: drifted odometry edges
    (noise × (2 cm, 0.2°)) and ``loops`` closures from the last poses to
    the first; nodes start at the dead-reckoned odometry.  Edge capacity
    n + loops (68 at the defaults, divisible by 4)."""
    rng = np.random.default_rng(7)
    th = 2 * np.pi * np.arange(n) / n
    true = [(np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)]),
             np.array([10 * np.cos(a), 10 * np.sin(a), 0.1 * np.sin(3 * a)])) for a in th]

    def rel(a, b):
        qa, ta = (torch.tensor(v, dtype=torch.float64) for v in a)
        qb, tb = (torch.tensor(v, dtype=torch.float64) for v in b)
        qi = so3.quat_conj(qa)
        q = so3.quat_mul(qi, qb)
        t = so3.quat_rotate(qi, tb - ta)
        q = so3.quat_mul(q, so3.exp_quat(torch.tensor(rng.normal(0, 0.0035 * noise, 3))))
        return q, t + torch.tensor(rng.normal(0, 0.02 * noise, 3))

    g = pg.create(n, n + loops, dtype=dtype, device="cpu")
    q, t = (torch.tensor(v, dtype=torch.float64) for v in true[0])
    g = pg.add_node(g, q, t)
    for k in range(1, n):
        qr, tr = rel(true[k - 1], true[k])
        t, q = t + so3.quat_rotate(q, tr), so3.quat_normalize(so3.quat_mul(q, qr))
        g = pg.add_node(g, q, t)
        g = pg.add_edge(g, k - 1, k, qr, tr)
    for i in range(loops):
        qr, tr = rel(true[n - 1 - i], true[i])
        g = pg.add_edge(g, n - 1 - i, i, qr, tr)
    return g


def cost_errors(noise: float = 1.0, iters: int = 8) -> dict:
    """Float32 costs of the ring graph on one rank and on four, each
    against the float64 one-rank costs (max relative error over the
    iterations), and the float64 four-rank costs against the same."""
    def rtol(a, b):
        return float(((a.double() - b.double()).abs() / b.double().abs()).max())

    g32 = _ring_graph(noise)
    g64 = g32._replace(**{f: getattr(g32, f).double() for f in g32._fields
                          if getattr(g32, f).is_floating_point()})
    c64 = pg.optimize(g64, iters=iters)[1]
    return {"one_rank": rtol(pg.optimize(g32, iters=iters)[1], c64),
            "four_ranks": rtol(pg.optimize_distributed(g32, sharded.make_mesh(4),
                                                       iters=iters)[1], c64),
            "float64_four_ranks": rtol(pg.optimize_distributed(g64, sharded.make_mesh(4),
                                                               iters=iters)[1], c64)}


@pytest.mark.parametrize("noise", [1.0, 0.1], ids=["drifted", "near_floor"])
def test_float32_cost_error_of_four_ranks_stays_near_one_ranks(noise):
    """The witness behind phase 11 (c)'s float32 bound in chip_smoke.py:
    split over four ranks, the float32 costs sit off the float64 ones by
    about as much as one rank's do (the bound is max(1e-4, 2 × one
    rank's)); in float64 the two agree to the 1e-4 of tests/test_gps.py.
    At a tenth of the noise the converged cost sits near its float32
    floor and one rank's own error passes 1e-4, as on the soak's graph."""
    e = cost_errors(noise)
    print(e)
    assert e["four_ranks"] <= max(1e-4, 2 * e["one_rank"])
    assert e["float64_four_ranks"] <= 1e-4


if __name__ == "__main__":
    for noise in (1.0, 0.1):
        print(f"noise x {noise}: {cost_errors(noise)}")
