"""K7's redesigned schedule (csrc/masked_topk.cu, csrc/compact_select.cuh)
and its table entry, on the CPU.

1. A NumPy emulation of the kernel's schedule — the validity streamed in
   tiles of 16-column chunks (two a thread, the row's byte offset from a
   16-byte boundary included) or, for the table entry, one thread a (row,
   entry) with a row's slots placed by ballot prefix counts; the valid
   columns compacted by a block scan into ``cap`` entries and the first k
   invalid ones kept for the tail; the distance bits; the radix select over
   the compacted entries (8-bit digits, stopping when the chosen bucket
   holds exactly the entries still wanted), the survivors collected in an
   arbitrary (shuffled) order and ranked by (bits, column); the global
   path when the valid count exceeds ``cap`` or a valid distance is not
   finite — is bit-equal to the plain stable sort (``sq``, ``valid`` and
   ``nbrs``, invalid tail included) on seeded cases: fewer than k valid,
   all valid, heavy ties, k = 128, an overflowing capacity, non-finite
   distances.
2. The table entry's plain version (``knn.masked_topk_from_table`` on CPU
   tensors) is bit-equal to ``gather_rows`` → ``cands_from_rows`` →
   ``masked_topk_reference`` on a small map (ties, a query with fewer than
   k stored points around it, an empty neighbourhood), and
   ``mapper.radius_search``'s wide branch agrees with the JAX package's:
   the decoded candidates bit for bit, ``valid`` exactly, ``sq`` within
   3e-7 relative (XLA-CPU contracts the distance into fused multiply-adds,
   ≤ 2 ulp) and ``nbrs`` exactly where the distances are separated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.ops import knn

NT = 256
INF_BITS = 0x7F800000


# ------------------------------------------------------------ the emulation
def _bits(x):
    return np.float32(x).view(np.uint32)


def _d2_bits(p, q):
    d = np.float32(p) - np.float32(q)
    with np.errstate(over="ignore", invalid="ignore"):
        return _bits((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])


def _scan(vals):
    """Exclusive block scan in thread order, and the total."""
    vals = np.asarray(vals, np.int64)
    return np.cumsum(vals) - vals, int(vals.sum())


def _phase_a_dense(mrow, k, cap, off):
    """fl_compact_dense: (valid count, col[:cap], first k invalid)."""
    C = len(mrow)
    nchunk = (C + off + 15) // 16
    col, inv = np.full(cap, -1), np.full(k, -1)
    nbase = ibase = 0
    for j0 in range(0, nchunk, 2 * NT):
        vl, il = [], []
        for tid in range(NT):
            v, i = [], []
            for u in range(2):
                j = j0 + 2 * tid + u
                if j >= nchunk:
                    continue
                for b in range(16):
                    c = 16 * j - off + b
                    if 0 <= c < C:
                        (v if mrow[c] else i).append(c)
            vl.append(v)
            il.append(i)
        ev, tv = _scan([len(v) for v in vl])
        ei, ti = _scan([len(i) for i in il])
        for tid in range(NT):
            for n, c in enumerate(vl[tid]):
                if nbase + ev[tid] + n < cap:
                    col[nbase + ev[tid] + n] = c
            for n, c in enumerate(il[tid]):
                if ibase + ei[tid] + n < k:
                    inv[ibase + ei[tid] + n] = c
        nbase += tv
        ibase += ti
    return nbase, col, inv


def _phase_a_table(ptable, rows, ncq, B, k, cap):
    """fl_compact_table (E = 16): thread (v, e) counts its valid slots, a
    block scan gives each row's base, slot s of the row's 16 entries is
    placed by the prefix count of its ballot."""
    V = len(rows)
    col, inv = np.full(cap, -1), np.full(k, -1)
    nbase = ibase = 0
    for v0 in range(0, V, NT // 16):
        nv = np.zeros(NT, np.int64)
        ni = np.zeros(NT, np.int64)
        okm = np.zeros(NT, bool)
        cnts = np.zeros(NT, np.float32)
        for tid in range(NT):
            v, e = v0 + tid // 16, tid % 16
            if v >= V:
                continue
            r = ptable[rows[v]]
            cnt = r[48 + e]
            ok = cnt > 0 and all(np.floor(r[16 * a + e] * np.float32(0.5)) == np.float32(ncq[v, a])
                                 for a in range(3))
            okm[tid], cnts[tid] = ok, cnt
            nv[tid] = sum(ok and np.float32(s) < cnt for s in range(B))
            ni[tid] = B - nv[tid]
        ev, tv = _scan(nv)
        ei, ti = _scan(ni)
        for h in range(NT // 16):
            v = v0 + h
            if v >= V:
                continue
            lanes = range(16 * h, 16 * h + 16)
            pv, pi = nbase + ev[16 * h], ibase + ei[16 * h]
            for s in range(B):
                isv = [okm[t] and np.float32(s) < cnts[t] for t in lanes]
                for e, t in enumerate(lanes):
                    c = v * 16 * B + 16 * s + e
                    if isv[e]:
                        p = pv + sum(isv[:e])
                        if p < cap:
                            col[p] = c
                    else:
                        p = pi + sum(not x for x in isv[:e])
                        if p < k:
                            inv[p] = c
                pv += sum(isv)
                pi += 16 - sum(isv)
        nbase += tv
        ibase += ti
    return nbase, col, inv


def _select(n, col, inv, C, k, cap, bits_of, gbits_of, rng):
    """fl_select_compacted → (columns in output order, sq bits, valid)."""
    m = min(n, cap)
    bits = np.array([bits_of(c) for c in col[:m]], np.uint32)
    if n > cap or (bits >= INF_BITS).any():
        # the global path: the stable order of (canonical bits, column)
        gb = np.array([gbits_of(c) for c in range(C)], np.uint32)
        gb = np.where((gb & 0x7FFFFFFF) > INF_BITS, np.uint32(0x7FC00000), gb)
        order = np.argsort(gb, kind="stable")[:k]
        return order, gb[order], gb[order] < INF_BITS
    if n > k:
        prefix, mask, kk, cnt = 0, 0, k, n
        for shift in (24, 16, 8, 0):
            sel = (bits & np.uint32(mask)) == prefix
            hist = np.bincount((bits[sel] >> np.uint32(shift)) & 0xFF, minlength=256)
            hi = np.cumsum(hist)
            lo = hi - hist
            b = int(np.nonzero((lo < kk) & (kk <= hi))[0][0])
            prefix |= b << shift
            mask |= 0xFF << shift
            kk, cnt = kk - int(lo[b]), int(hist[b])
            if cnt == kk:
                break
        masked = bits & np.uint32(mask)
        if cnt == kk:
            idx = np.nonzero(masked <= prefix)[0]
        else:
            eq = np.nonzero(bits == prefix)[0][:kk]
            idx = np.concatenate([np.nonzero(bits < prefix)[0], eq])
        assert len(idx) == k
        idx = rng.permutation(idx)                  # the atomics' order
        su, sc = bits[idx], col[idx]
    else:
        su, sc = bits, col[:m]
    ms = min(n, k)
    out_c, out_b = np.empty(k, np.int64), np.empty(k, np.uint32)
    for j in range(ms):
        r = int(np.sum((su < su[j]) | ((su == su[j]) & (sc < sc[j]))))
        out_c[r], out_b[r] = sc[j], su[j]
    out_c[ms:], out_b[ms:] = inv[:k - ms], INF_BITS
    return out_c, out_b, np.arange(k) < ms


def _emulate_dense(cand, valid, q, k, cap, off, rng):
    outs = []
    for i in range(len(q)):
        n, col, inv = _phase_a_dense(valid[i], k, cap, off)
        outs.append(_select(
            n, col, inv, cand.shape[1], k, cap, lambda c: _d2_bits(cand[i, c], q[i]),
            lambda c: _d2_bits(cand[i, c], q[i]) if valid[i, c] else INF_BITS, rng))
    cols = np.stack([o[0] for o in outs])
    nb = np.take_along_axis(cand, cols[..., None], 1)
    sq = np.stack([o[1] for o in outs]).view(np.float32)
    vl = np.stack([o[2] for o in outs])
    return nb, np.where(vl, sq, np.float32(np.inf)), vl


def _dense_case(rng, N, C, frac, ties=False, scale=3.0):
    cand = np.float32(rng.normal(size=(N, C, 3)) * scale)
    q = np.float32(rng.normal(size=(N, 3)))
    if ties:
        cand, q = np.round(cand), np.round(q)
    return cand, rng.random((N, C)) < frac, q


def _dense_cases():
    rng = np.random.default_rng(7)
    out = {
        "random": (*_dense_case(rng, 6, 300, 0.3), 16, 300, 0),
        "fewer_than_k": (*_dense_case(rng, 5, 200, 0.02), 16, 200, 3),
        "all_valid": (*_dense_case(rng, 4, 260, 1.0), 16, 260, 9),
        "none_valid": (*_dense_case(rng, 3, 100, 0.0), 8, 100, 1),
        "heavy_ties": (*_dense_case(rng, 6, 400, 0.6, ties=True, scale=1.0), 32, 400, 15),
        "k128": (*_dense_case(rng, 4, 700, 0.5), 128, 700, 4),
        "k128_few": (*_dense_case(rng, 3, 700, 0.1), 128, 700, 0),
        "overflow": (*_dense_case(rng, 4, 600, 0.7), 16, 200, 6),
        "two_tiles": (*_dense_case(rng, 2, 9000, 0.05), 16, 4096, 2),
    }
    cand, valid, q = _dense_case(rng, 4, 200, 0.5)
    cand[0, 3] = 1e30                       # a valid column at +inf distance
    valid[0, 3] = True
    cand[1, 7, 1] = np.nan                  # a valid NaN distance
    valid[1, 7] = True
    out["nonfinite"] = (cand, valid, q, 16, 200, 0)
    return out


DENSE = _dense_cases()


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_schedule_is_the_stable_sort(name):
    cand, valid, q, k, cap, off = DENSE[name]
    got = _emulate_dense(cand, valid, q, k, cap, off, np.random.default_rng(1))
    want = knn.masked_topk_reference(torch.tensor(cand), torch.tensor(valid), torch.tensor(q),
                                     k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


# ------------------------------------------------------------ the table entry
VOX = 1.2


@pytest.fixture(scope="module")
def small_map():
    """A 2500-point cloud in a 4096-entry map of 3-point buckets, with four
    points at exactly 2 m from (20.5, 20.5, 20.5) (ties) and a sparse
    corner; the same inserts into the JAX package's map."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-8, 8, (2500, 3))
    pts[:1200, 2] = rng.normal(0, 0.05, 1200)
    pts[-3:] = [[40.0, 40.0, 40.0], [40.5, 40.2, 39.9], [39.6, 40.4, 40.1]]
    pts[:4] = [[22.5, 20.5, 20.5], [20.5, 22.5, 20.5], [20.5, 20.5, 22.5], [18.5, 20.5, 20.5]]
    pts = np.float32(pts)
    tm = mp.insert(mp.create(4096, 3), torch.tensor(pts), torch.ones(len(pts), dtype=torch.bool),
                   voxel_size=VOX)
    jm = jmp.insert(jmp.create(4096, 3), jnp.asarray(pts), jnp.ones(len(pts), bool),
                    voxel_size=VOX)
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    q = np.float32(np.concatenate([
        [[20.5, 20.5, 20.5], [40.1, 40.1, 40.0], [60.0, -60.0, 60.0]],
        rng.uniform(-7, 7, (9, 3))]))
    return tm, jm, q


def _wide_rows(tm, q, radius):
    mb = int(np.ceil(radius / (2 * VOX) - 1e-9))
    ncb = (mp.block_coords(mp.voxel_coords(q, VOX))[:, None, :]
           + mp._block_offsets(mb, q.device)[None])
    return mp._hash(ncb, tm.groups).to(torch.int32), ncb.to(torch.int32)


@pytest.mark.parametrize("factor,k", [(3.1, 4), (3.1, 32), (3.1, 128), (6.5, 16)])
def test_table_entry_plain_is_the_composition(small_map, factor, k):
    tm, _, qn = small_map
    q = torch.tensor(qn)
    row_idx, ncb = _wide_rows(tm, q, factor * VOX)
    n0 = knn.masked_topk_from_table.launches
    got = knn.masked_topk_from_table(tm.ptable, row_idx, ncb, q, E=mp.E, B=tm.bucket, k=k)
    assert knn.masked_topk_from_table.launches == n0           # CPU: the plain version
    rows = tm.ptable[row_idx.long()]
    cand, cvalid = mp.cands_from_rows(rows, ncb, None, tm.bucket)
    N = len(q)
    want = knn.masked_topk_reference(cand.reshape(N, -1, 3), cvalid.reshape(N, -1), q, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    vl = got[2].numpy()
    assert vl[0, :min(k, 4)].all() and np.all(got[1].numpy()[0, :min(k, 4)] == 4.0)   # ties
    assert 0 < vl[1].sum() < k or k <= 3                       # the sparse corner
    assert not vl[2].any()                                     # nothing stored around it


@pytest.mark.parametrize("factor,k", [(3.1, 32), (6.5, 16)])
def test_table_schedule_is_the_composition(small_map, factor, k):
    """The table entry's Phase A emulated, then the shared select (with a
    capacity small enough that some queries take the global path)."""
    tm, _, qn = small_map
    q = torch.tensor(qn)
    row_idx, ncb = _wide_rows(tm, q, factor * VOX)
    want = knn.masked_topk_from_table(tm.ptable, row_idx, ncb, q, E=mp.E, B=tm.bucket, k=k)
    ptab, B = tm.ptable.numpy(), tm.bucket
    EB = 16 * B
    rng = np.random.default_rng(3)
    for i in range(len(qn)):
        rows, ncq = row_idx[i].numpy(), ncb[i].numpy()
        C = len(rows) * EB
        cap = 64 if i % 2 else C
        n, col, inv = _phase_a_table(ptab, rows, ncq, B, k, cap)

        def slot(c):
            v, r = divmod(c, EB)
            s, e = divmod(r, 16)
            p = ptab[rows[v]]
            return np.float32([p[64 + r], p[64 + EB + r], p[64 + 2 * EB + r]]), p, s, e, v

        def gbits(c):
            xyz, p, s, e, v = slot(c)
            cnt = p[48 + e]
            ok = cnt > 0 and np.float32(s) < cnt and all(
                np.floor(p[16 * a + e] * np.float32(0.5)) == np.float32(ncq[v, a])
                for a in range(3))
            return _d2_bits(xyz, qn[i]) if ok else INF_BITS

        cols, b, vl = _select(n, col, inv, C, k, cap, lambda c: _d2_bits(slot(c)[0], qn[i]),
                              gbits, rng)
        np.testing.assert_array_equal(vl, want[2][i].numpy())
        np.testing.assert_array_equal(np.where(vl, b.view(np.float32), np.inf), want[1][i].numpy())
        np.testing.assert_array_equal(np.stack([slot(c)[0] for c in cols]), want[0][i].numpy())


@pytest.mark.parametrize("factor,k", [(3.1, 8), (3.1, 64), (6.5, 32)])
def test_wide_radius_search_matches_jax(small_map, factor, k):
    tm, jm, qn = small_map
    r = factor * VOX
    q = torch.tensor(qn)
    row_idx, ncb = _wide_rows(tm, q, r)
    rows = tm.ptable[row_idx.long()]
    cand, cvalid = mp.cands_from_rows(rows, ncb, None, tm.bucket)
    jrows = jm.ptable[np.asarray(row_idx.long())]
    jcand, jvalid = jmp.cands_from_rows(jrows, jnp.asarray(ncb.numpy()), None, jm.bucket)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    np.testing.assert_array_equal(cvalid.numpy(), np.asarray(jvalid))
    nb, sq, vl = (a.numpy() for a in mp.radius_search(tm, q, r, voxel_size=VOX, max_results=k))
    wn, ws, wv = (np.asarray(a) for a in jmp.radius_search(jm, jnp.asarray(qn), r,
                                                            voxel_size=VOX, max_results=k))
    np.testing.assert_array_equal(vl, wv)
    np.testing.assert_allclose(sq[vl], ws[wv], rtol=3e-7, atol=0)
    assert np.all(np.isinf(sq[~vl])) and np.all(np.isinf(ws[~wv]))
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(ws, axis=1)) > 1e-5 * np.abs(ws[:, 1:])
    edge = np.ones((len(ws), 1), bool)
    sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1) & vl
    np.testing.assert_array_equal(nb[sep], wn[sep])
    assert vl[0].any() and not vl[2].any()
