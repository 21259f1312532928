"""K2's schedules (csrc/knn_rows.cu, csrc/table_rows.cuh) and its select
entry, on the CPU.

1. A NumPy emulation of the kernel — the warp schedule: a half-warp a row,
   lane e decoding entry e once, one ballot a slot placing the valid
   columns in column order into a list of ``cap`` entries and the first k
   invalid columns for the tail, one dense pass computing the list's
   distance bits; then k rounds of
   a warp min (the smallest bits, then the lowest list index; only the
   winning lane rescans) or the warp radix select (8-bit digits, a lane's
   eight bins, stopping when the chosen bin holds exactly the entries still
   wanted, survivors collected in list order and ranked by shuffles); the
   exact path over all columns when the list overflows or a valid distance
   is not finite — and the block schedule (K7's table schedule, emulated by
   ``test_torch_k7_schedule``, with sq NaN where the distance is NaN) are
   bit-equal to ``knn_rows.topk_from_table_reference`` in ``sq``, ``valid``
   and ``nbrs``, invalid tail included: at k = 1 … 128, V = 8 and 27, with
   ties, queries with fewer than k stored points around them and none, an
   overflowing list, and NaN and +inf distances in filled slots.
2. The select entry's plain version is bit-equal to the two-call
   composition (the ``idx`` rows, then every query) at the window, patch,
   full and inactive settings, and an emulation of the kernel's work-item
   rule writes, in the branch the stale count takes, exactly those rows.
3. K2's plain version agrees with the JAX ``topk_from_rows_reference`` and
   ``topk_from_rows_tpu(interpret=True)`` on the same rows: ``valid``
   exactly, ``sq`` within rtol 1e-5 (``tests/test_pallas_knn.py``), ``nbrs``
   exactly where the distances are separated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.ops import knn_rows as jkr
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.ops import knn_rows
from test_torch_k7_schedule import INF_BITS, _bits, _phase_a_table, _select

VOX = 1.2
CANON_NAN = 0x7FC00000
NONE = 0xFFFFFFFF


# ------------------------------------------------------------ the emulation
def _d2_bits(p, q):
    d = np.float32(p) - np.float32(q)
    with np.errstate(over="ignore", invalid="ignore"):
        return int(_bits((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]))


def _entry_ok(r, ncv):
    """(kept, counts) of a row's 16 entries: table_rows.cuh's fl_entry_ok."""
    cnt = r[48:64]
    ok = cnt > 0
    for a in range(3):
        ok &= np.floor(r[16 * a:16 * a + 16] * np.float32(0.5)) == np.float32(ncv[a])
    return ok, cnt


def _point(ptab, rows, B, c):
    EB = 16 * B
    v, r = divmod(c, EB)
    p = ptab[rows[v]]
    return np.float32([p[64 + r], p[64 + EB + r], p[64 + 2 * EB + r]])


def _col_bits(ptab, rows, ncq, B, q, c):
    """fl_col_bits: one column decoded alone, +inf where invalid."""
    v, r = divmod(c, 16 * B)
    ok, cnt = _entry_ok(ptab[rows[v]], ncq[v])
    s, e = divmod(r, 16)
    return _d2_bits(_point(ptab, rows, B, c), q) if ok[e] and np.float32(s) < cnt[e] \
        else INF_BITS


def _warp_decode(ptab, rows, ncq, q, B, k, cap):
    """fl_k2_warp_decode: (valid count, wb[cap], wc[cap], winv[32], nonfinite);
    columns as plain indices (the kernel packs them as row << 16 | slot-major
    position, which orders alike)."""
    V, EB = len(rows), 16 * B
    wb, wc, winv = np.full(cap, NONE, np.int64), np.full(cap, -1), np.full(32, -1)
    nbase = ibase = 0
    for v0 in range(0, V, 2):
        halves = []
        for h in range(2):
            v = v0 + h
            if v < V:
                ok, cnt = _entry_ok(ptab[rows[v]], ncq[v])
                halves.append((v, True, ok, cnt))
            else:
                halves.append((v, False, np.zeros(16, bool), np.zeros(16, np.float32)))
        nv = [int(sum((ok & (np.float32(s) < cnt)).sum() for s in range(B)))
              for _, _, ok, cnt in halves]
        lo, tv = nv[0], nv[0] + nv[1]
        pv, pi = [nbase, nbase + lo], [ibase, ibase + EB - lo]
        for s in range(B):
            for h, (v, inn, ok, cnt) in enumerate(halves):
                isv = ok & (np.float32(s) < cnt)
                isi = inn & ~isv
                for e in range(16):
                    c = v * EB + 16 * s + e
                    if isv[e]:
                        p = pv[h] + int(isv[:e].sum())
                        if p < cap:
                            wc[p] = c
                    elif isi[e]:
                        p = pi[h] + int(isi[:e].sum())
                        if p < k:
                            winv[p] = c
                pv[h] += int(isv.sum())
                pi[h] += int(isi.sum())
        nbase += tv
        ibase += (2 if v0 + 1 < V else 1) * EB - tv
    for i in range(min(nbase, cap)):   # the dense pass over the list
        wb[i] = _d2_bits(_point(ptab, rows, B, int(wc[i])), q)
    nf = bool((wb[:min(nbase, cap)] >= INF_BITS).any())
    return nbase, wb, wc, winv, nf


def _min_rounds(wb, n, k):
    """fl_k2_min_rounds → [(list index, bits)] in output order."""
    wb = wb.copy()
    best = {}

    def rescan(lane):
        own = [(int(wb[i]), i) for i in range(lane, n, 32)]
        best[lane] = min(own) if own else (NONE, -1)   # strict <: the lowest index of a tie

    for lane in range(32):
        rescan(lane)
    out = []
    for _ in range(min(n, k)):
        g = min(b[0] for b in best.values())
        gi = min(b[1] for b in best.values() if b[0] == g)
        out.append((gi, g))
        wb[gi] = NONE
        rescan(gi % 32)
    return out


def _radix(wb, n, k):
    """fl_k2_radix (n > k) → survivors [(list index, bits)] in list order."""
    bits = wb[:n]
    prefix, mask, kk, cnt = 0, 0, k, n
    for shift in (24, 16, 8, 0):
        sel = (bits & mask) == prefix
        hist = np.bincount((bits[sel] >> shift) & 0xFF, minlength=256)
        lane_sum = hist.reshape(32, 8).sum(1)
        lo = np.cumsum(lane_sum) - lane_sum          # each lane's exclusive base
        found = []
        for lane in range(32):
            acc = int(lo[lane])
            for j in range(8):
                hi = acc + int(hist[8 * lane + j])
                if acc < kk <= hi:
                    found.append((8 * lane + j, kk - acc, int(hist[8 * lane + j])))
                acc = hi
        dig, kk, cnt = found[0]
        prefix |= dig << shift
        mask |= 0xFF << shift
        if cnt == kk:
            break
    surv, neq = [], 0
    for i0 in range(0, n, 32):
        if len(surv) >= k:
            break
        chunk = range(i0, min(i0 + 32, n))
        if cnt == kk:
            take = [i for i in chunk if (int(bits[i]) & mask) <= prefix]
        else:
            take = []
            for i in chunk:
                if bits[i] < prefix:
                    take.append(i)
                elif bits[i] == prefix:
                    if neq < kk:
                        take.append(i)
                    neq += 1
        surv += take
    assert len(surv) == k
    return [(i, int(bits[i])) for i in surv]


def _all_columns(ptab, rows, ncq, B, q, k):
    """fl_k2_all_columns: k rounds over all C columns, NaN canonical, each
    round the smallest (bits, column) after the last pick."""
    C = len(rows) * 16 * B
    u = np.array([_col_bits(ptab, rows, ncq, B, q, c) for c in range(C)], np.int64)
    u = np.where((u & 0x7FFFFFFF) > INF_BITS, CANON_NAN, u)
    out, lu, lc = [], 0, -1
    for _ in range(k):
        after = (u > lu) | ((u == lu) & (np.arange(C) > lc))
        g = int(u[after].min())
        gc = int(np.nonzero(after & (u == g))[0][0])
        out.append((gc, g))
        lu, lc = g, gc
    return out


def _emulate_warp(ptab, rows, ncq, q, B, k, cap, radix):
    """fl_k2_warp_kernel for one query → (columns, bits) in output order."""
    n, wb, wc, winv, nf = _warp_decode(ptab, rows, ncq, q, B, k, cap)
    if n > cap or nf:
        cols, us = zip(*_all_columns(ptab, rows, ncq, B, q, k))
        return list(cols), list(us)
    ms = min(n, k)
    if not radix:
        picks = _min_rounds(wb, n, k)
    else:
        surv = _radix(wb, n, k) if n > k else [(i, int(wb[i])) for i in range(n)]
        picks = [None] * ms
        for lane, (i, u) in enumerate(surv):   # the shuffle rank
            r = sum((ut < u) or (ut == u and t < lane) for t, (_, ut) in enumerate(surv))
            picks[r] = (i, u)
    cols = [int(wc[i]) for i, _ in picks] + [int(c) for c in winv[:k - ms]]
    return cols, [u for _, u in picks] + [INF_BITS] * (k - ms)


def _emulate_block(ptab, rows, ncq, q, B, k, cap, rng):
    """K7's table schedule (fl_table_topk<kRawSq = true>)."""
    C = len(rows) * 16 * B
    n, col, inv = _phase_a_table(ptab, rows, ncq, B, k, cap)
    cols, b, _ = _select(n, col, inv, C, k, cap,
                         lambda c: _d2_bits(_point(ptab, rows, B, c), q),
                         lambda c: _col_bits(ptab, rows, ncq, B, q, c), rng)
    return [int(c) for c in cols], [int(u) for u in b]


def _emulate(ptab, row_idx, nc, qs, B, k, mode, cap):
    rng = np.random.default_rng(3)
    nb, sq, vl = [], [], []
    for i in range(len(qs)):
        args = (ptab, row_idx[i], nc[i], qs[i], B, k, cap)
        if mode == "block":
            cols, us = _emulate_block(*args, rng)
        else:
            cols, us = _emulate_warp(*args, radix=mode == "warp_radix")
        nb.append([_point(ptab, row_idx[i], B, c) for c in cols])
        us = np.array(us, np.uint32)
        sq.append(us.view(np.float32))
        vl.append(us < INF_BITS)
    return np.float32(nb), np.stack(sq), np.stack(vl)


# ------------------------------------------------------------ the cases
@pytest.fixture(scope="module")
def small_map():
    """1800 points in a 4096-entry map of 3-point buckets: a surface, a
    duplicated point, points at exactly equal distances from (20.5, 20.5,
    20.5), a sparse corner at (40, 40, 40) and nothing near (60, -60, 60);
    a JAX map from the same inserts."""
    from fast_limo_tpu.models import mapper as jmp

    rng = np.random.default_rng(9)
    pts = rng.uniform(-6, 6, (1800, 3))
    pts[:900, 2] = rng.normal(0, 0.05, 900)
    pts[-2:] = [[40.0, 40.0, 40.0], [40.5, 40.2, 39.9]]
    pts[:6] = [[20.75, 20.5, 20.5], [20.25, 20.5, 20.5], [20.5, 20.75, 20.5],
               [20.5, 20.25, 20.5], [1.0, 1.0, 0.0], [1.0, 1.0, 0.0]]
    pts = np.float32(pts)
    tm = mp.insert(mp.create(4096, 3), torch.tensor(pts), torch.ones(len(pts), dtype=torch.bool),
                   voxel_size=VOX)
    jm = jmp.insert(jmp.create(4096, 3), jnp.asarray(pts), jnp.ones(len(pts), bool),
                    voxel_size=VOX)
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    q = np.float32(np.concatenate([
        [[20.5, 20.5, 20.5], [40.1, 40.1, 40.0], [60.0, -60.0, 60.0], [1.0, 1.0, 0.1]],
        rng.uniform(-5, 5, (6, 3))]))
    return tm, jm, q


def _rows(tm, q, V):
    return mp.block_rows(tm, torch.tensor(q), voxel_size=VOX,
                         neighborhood=8 if V == 8 else -27)[:2]


def _held(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())   # NaN equals NaN here


def _case(tm, q, V, k):
    row_idx, ncb = _rows(tm, q, V)
    want = knn_rows.topk_from_table_reference(tm.ptable, row_idx, ncb, torch.tensor(q), E=mp.E,
                                              B=tm.bucket, k=k)
    return tm.ptable.numpy(), row_idx.numpy(), ncb.numpy(), want


@pytest.mark.parametrize("V", [8, 27])
@pytest.mark.parametrize("k", [1, 5, 12, 16, 32, 64, 128])
def test_schedules_are_the_stable_sort(small_map, V, k):
    tm, _, q = small_map
    ptab, row_idx, ncb, want = _case(tm, q, V, k)
    vl = want[2].numpy()
    assert vl.any() and not vl[2].any() and (vl[1].sum() < k or k == 1)
    modes = ["block"] + (["warp_min", "warp_radix"] if k <= knn_rows.WARP_KMAX else [])
    C = V * 16 * tm.bucket
    for mode in modes:
        cap = knn_rows.warp_cap(V, tm.bucket) if mode != "block" else min(C, 4096)
        _held(_emulate(ptab, row_idx, ncb, q, tm.bucket, k, mode, cap), want)


@pytest.mark.parametrize("mode,cap", [("warp_min", 6), ("warp_radix", 6), ("warp_radix", 20),
                                      ("block", 16)])
def test_an_overflowing_list_takes_the_exact_path(small_map, mode, cap):
    tm, _, q = small_map
    k = 5
    ptab, row_idx, ncb, want = _case(tm, q, 27, k)
    _held(_emulate(ptab, row_idx, ncb, q, tm.bucket, k, mode, cap), want)


@pytest.mark.parametrize("value", [np.nan, 1e30, np.inf])
@pytest.mark.parametrize("k", [5, 40])
def test_nonfinite_distances_sort_as_the_plain_version(small_map, value, k):
    """A filled slot of a kept entry holds NaN, 1e30 (an overflowing
    distance) or +inf: NaN sorts after +inf, +inf among the invalid
    columns by column, and sq is NaN where the distance is."""
    tm, _, q = small_map
    ptab = tm.ptable.clone()
    row_idx, ncb = _rows(tm, q, 8)
    for i in (0, 3):   # a kept entry's first slot in each query's first filled row
        for v in range(8):
            r = ptab[row_idx[i, v]].numpy()
            ok, _ = _entry_ok(r, ncb[i, v].numpy())
            if ok.any():
                e = int(np.nonzero(ok)[0][0])
                ptab[row_idx[i, v], 64 + e] = float(value)
                break
    want = knn_rows.topk_from_table_reference(ptab, row_idx, ncb, torch.tensor(q), E=mp.E,
                                              B=tm.bucket, k=k)
    for i in (0, 3):   # the warp schedule sees it: its exact path
        assert _warp_decode(ptab.numpy(), row_idx[i].numpy(), ncb[i].numpy(), q[i], tm.bucket,
                            min(k, knn_rows.WARP_KMAX), knn_rows.warp_cap(8, tm.bucket))[4]
    modes = ["block"] + (["warp_min", "warp_radix"] if k <= knn_rows.WARP_KMAX else [])
    for mode in modes:
        cap = knn_rows.warp_cap(8, tm.bucket) if mode != "block" else 8 * 16 * tm.bucket
        _held(_emulate(ptab.numpy(), row_idx.numpy(), ncb.numpy(), q, tm.bucket, k, mode, cap),
              want)


# ------------------------------------------------------------ the select entry
def _item(i, N, budget, viol, idx):
    """fl_k2_item: (query, "patch" | "full", output row) or None."""
    if viol == 0:
        return None
    if viol <= budget:
        return (int(idx[i]), "patch", i) if i < budget else None
    return i, "full", i


@pytest.mark.parametrize("viol", [0, 3, 40])
def test_select_entry_is_the_two_call_composition(small_map, viol):
    tm, _, qn = small_map
    q = torch.tensor(qn)
    N, budget, k = len(qn), 4, 5
    row_idx, ncb = _rows(tm, qn, 8)
    stale = torch.zeros(N, dtype=torch.bool)
    stale[[1, 4, 7][:min(viol, 3)]] = True
    idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:budget]
    v = torch.tensor(viol, dtype=torch.int32)
    n0 = knn_rows.topk_from_table.launches
    kw = dict(E=mp.E, B=tm.bucket, k=k)
    for active in (None, torch.tensor(True), torch.tensor(False)):
        patch, full = knn_rows.topk_from_table_select(tm.ptable, row_idx, ncb, q, idx, v, **kw,
                                                      active=active)
        two = (knn_rows.topk_from_table(tm.ptable, row_idx[idx], ncb[idx], q[idx], **kw),
               knn_rows.topk_from_table(tm.ptable, row_idx, ncb, q, **kw))
        for got, want in zip((patch, full), two):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert knn_rows.topk_from_table.launches == n0          # CPU: the plain versions
    # the kernel's work-item rule writes the taken branch's rows, each the
    # plain version of its query
    single = knn_rows.topk_from_table_reference(tm.ptable, row_idx, ncb, q, **kw)
    written = {"patch": set(), "full": set()}
    for i in range(N):
        it = _item(i, N, budget, viol, idx.numpy())
        if it is None:
            continue
        qi, where, o = it
        out = patch if where == "patch" else full
        assert all(torch.equal(out[j][o], single[j][qi]) for j in range(3))
        written[where].add(o)
    taken = {0: (set(), set()), 3: (set(range(budget)), set()), 40: (set(), set(range(N)))}
    assert (written["patch"], written["full"]) == taken[viol]


# ------------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("V,k", [(8, 5), (27, 12)])
def test_plain_version_matches_jax(small_map, V, k):
    tm, jm, qn = small_map
    row_idx, ncb = _rows(tm, qn, V)
    got = [a.numpy() for a in knn_rows.topk_from_table(
        tm.ptable, row_idx, ncb, torch.tensor(qn), E=mp.E, B=tm.bucket, k=k)]
    jrows = jm.ptable[np.asarray(row_idx.long())]
    kw = dict(E=mp.E, B=jm.bucket, k=k)
    wants = [jkr.topk_from_rows_reference(jrows, jnp.asarray(ncb.numpy()), jnp.asarray(qn), **kw)]
    if V == 8:   # the Pallas kernel at a tiny size, interpret mode
        wants.append(jkr.topk_from_rows_tpu(jrows, jnp.asarray(ncb.numpy()), jnp.asarray(qn),
                                            interpret=True, **kw))
    for want in wants:
        wn, ws, wv = (np.asarray(a) for a in want)
        nb, sq, vl = got
        np.testing.assert_array_equal(vl, wv)
        np.testing.assert_allclose(sq[vl], ws[wv], rtol=1e-5, atol=0)
        assert np.all(np.isinf(sq[~vl])) and np.all(np.isinf(ws[~wv]))
        with np.errstate(invalid="ignore"):
            gap = np.abs(np.diff(ws, axis=1)) > 1e-5 * np.abs(ws[:, 1:])
        edge = np.ones((len(ws), 1), bool)
        sep = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1) & vl
        assert sep.sum() > 10
        np.testing.assert_array_equal(nb[sep], wn[sep])
