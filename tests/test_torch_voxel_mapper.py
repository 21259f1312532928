"""Voxel downsample, voxel-hash map and the K2 kNN kernel: the port against
the JAX package on the same numpy-seeded inputs.  The comparisons are
EXACT: voxel sets, map table/ptable after inserts, gathered rows, K2's
validity, and K2's squared distances against an IEEE float32 NumPy
evaluation.

Two places where the JAX package's CPU backend (XLA) does not round like
IEEE float32, and what is compared there instead:
* XLA rewrites ``p / leaf`` by a constant into ``p * (1/leaf)``; the port
  divides (floor(p / leaf) must not move points across voxel
  boundaries).  The two agree exactly for power-of-two leaves, which the
  voxel-set test uses; ``floor_div`` is checked against NumPy's division.
* XLA contracts ``dx² + dy² + dz²`` into fused multiply-adds, so its K2
  distances differ from a plain float32 evaluation in the last bit: they
  are compared at 3e-7 relative (≤ 2 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu.ops import knn_rows as jknn
from fast_limo_tpu.ops import voxel as jvoxel
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.ops import knn_rows, voxel

VOXEL = 1.2


def _cloud(rng, n, center=(0.0, 0.0, 0.0), spread=6.0):
    """Surface-like points: jittered samples of a few planes (dense voxels,
    multi-point runs, bucket overflow) plus scattered outliers."""
    pts = rng.uniform(-spread, spread, (n, 3))
    pts[: n // 2, 2] = rng.normal(0, 0.03, n // 2)                   # ground
    pts[n // 2: 3 * n // 4, 1] = 3.0 + rng.normal(0, 0.03, n // 4)   # wall
    return np.float32(pts + np.asarray(center))


def test_voxel_sets_bit_equal(rng):
    pts = np.float32(rng.uniform(-20, 20, (3000, 3)))
    pts[::7] = pts[::7].round(1)               # points on leaf boundaries
    valid = rng.random(3000) < 0.9
    for leaf in (0.5, 1.0, 0.25):
        got_p, got_v = voxel.voxel_downsample(torch.tensor(pts), torch.tensor(valid), leaf)
        want_p, want_v = jax.jit(jvoxel.voxel_downsample, static_argnums=2)(
            jnp.asarray(pts), jnp.asarray(valid), leaf)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("leaf", [0.1, 0.3, 1.2])
def test_floor_div_is_true_division(leaf):
    """floor(p / leaf) by IEEE float32 division, also for values that sit
    on voxel boundaries (k·leaf rounded to float32)."""
    x = np.float32(np.arange(-300, 300) * np.float32(leaf))
    got = voxel.floor_div(torch.tensor(x), leaf).numpy()
    np.testing.assert_array_equal(got, np.floor(x / np.float32(leaf)))


def _map_pair(cap=4096, bucket=2):
    return mp.create(cap, bucket), jmp.create(cap, bucket)


def _assert_maps_equal(tm, jm):
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    np.testing.assert_array_equal(tm.ptable.numpy(), np.asarray(jm.ptable))
    assert int(tm.num_points) == int(jm.num_points)


@pytest.mark.parametrize("bucket", [2, 6])
def test_insert_sequence_bit_equal(rng, bucket):
    """Three inserts from the same (empty) state: new voxels, re-visited
    voxels, full buckets and crowded groups all land identically.  Bucket 6
    (``map_points_per_voxel`` of the benchmark's configurations) also takes
    runs longer than the bucket onto partly filled ones."""
    tm, jm = _map_pair(cap=1024, bucket=bucket)
    for i in range(3):
        pts = _cloud(rng, 1500, center=(0.8 * i, 0.3 * i, 0.0))
        valid = rng.random(len(pts)) < 0.95
        tm = mp.insert(tm, torch.tensor(pts), torch.tensor(valid), voxel_size=VOXEL)
        jm = jmp.insert(jm, jnp.asarray(pts), jnp.asarray(valid), voxel_size=VOXEL)
        _assert_maps_equal(tm, jm)
    assert int(tm.num_points) > 0


def test_layout_version_matches_jax():
    """Same table layouts: the same arrays mean the same map (utils/interop)."""
    for b in (2, 6):
        assert mp.layout_version(b) == jmp.layout_version(b)


def test_hash_matches_int32_wraparound(rng):
    c = rng.integers(-40000, 40000, (500, 3)).astype(np.int32)
    got = mp._hash(torch.tensor(c), 8192).numpy()
    want = np.asarray(jmp._hash(jnp.asarray(c), 8192))
    np.testing.assert_array_equal(got, want)


def _filled_map(rng):
    tm, jm = _map_pair(cap=2048, bucket=3)
    pts = _cloud(rng, 4000)
    valid = np.ones(len(pts), bool)
    tm = mp.insert(tm, torch.tensor(pts), torch.tensor(valid), voxel_size=VOXEL)
    jm = jmp.insert(jm, jnp.asarray(pts), jnp.asarray(valid), voxel_size=VOXEL)
    return tm, jm


def test_gather_rows_equal(rng):
    tm, jm = _filled_map(rng)
    q = np.float32(rng.uniform(-7, 7, (257, 3)))
    rows, ncb, _ = mp.gather_rows(tm, torch.tensor(q), voxel_size=VOXEL)
    jrows, jncb, owned = jmp.gather_rows(jm, jnp.asarray(q), voxel_size=VOXEL)
    assert owned is None
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(ncb.numpy(), np.asarray(jncb))


def _numpy_topk(jrows, jncb, q, k):
    """K2 in NumPy float32 from the JAX package's candidate decode."""
    cand, cvalid = (np.asarray(a) for a in jmp.cands_from_rows(jrows, jncb, None, 3))
    N = q.shape[0]
    cand, cvalid = cand.reshape(N, -1, 3), cvalid.reshape(N, -1)
    d = cand - q[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2 = np.where(cvalid, d2, np.float32(np.inf))
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    sq = np.take_along_axis(d2, idx, 1)
    return np.take_along_axis(cand, idx[..., None], 1), sq, np.isfinite(sq)


@pytest.mark.parametrize("k", [5, 12])
def test_plain_k2_matches_jax(rng, k):
    """Plain K2 against the interpret-mode TPU kernel and the jnp reference
    (valid exact, sq ≤ 2 ulp, neighbours exact where both distances agree
    bitwise and are finite — the TPU kernel's picks among +inf are
    arbitrary), and bit-equal to the NumPy float32 evaluation."""
    tm, jm = _filled_map(rng)
    q = np.float32(rng.uniform(-7, 7, (200, 3)))
    q[:20] = q[:20] + 30.0                     # queries with few/no candidates
    row_idx, ncb, _ = mp.block_rows(tm, torch.tensor(q), voxel_size=VOXEL)
    nb, sq, vl = (a.numpy() for a in knn_rows.topk_from_table(
        tm.ptable, row_idx, ncb, torch.tensor(q), E=mp.E, B=3, k=k))
    jrows, jncb, _ = jmp.gather_rows(jm, jnp.asarray(q), voxel_size=VOXEL)
    rn, rs, rv = _numpy_topk(jrows, jncb, q, k)
    np.testing.assert_array_equal(sq, rs)
    np.testing.assert_array_equal(vl, rv)
    np.testing.assert_array_equal(nb, rn)
    for want in (jknn.topk_from_rows_tpu(jrows, jncb, jnp.asarray(q), E=jmp.E, B=3, k=k,
                                         interpret=True),
                 jknn.topk_from_rows_reference(jrows, jncb, jnp.asarray(q), E=jmp.E, B=3, k=k)):
        wn, ws, wv = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(vl, wv)
        np.testing.assert_allclose(sq[vl], ws[wv], rtol=3e-7, atol=0)
        same = np.all(sq == ws, axis=1)
        np.testing.assert_array_equal(nb[same][vl[same]], wn[same][wv[same]])
    assert vl.any() and not vl.all()
