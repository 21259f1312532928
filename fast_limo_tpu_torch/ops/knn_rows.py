"""K2 — k nearest candidates from planar block rows (port of
fast_limo_tpu/ops/knn_rows.py).

``topk_from_table`` takes the map's planar table and an (N, V) int32 row
index (``mapper.block_rows``), so the block-row gather is never
materialised.  Its callers: the main path's window resolve and the map
queries (``mapper.knn``, the narrow ``radius_search`` branches).  It also
takes an optional active flag (a () bool device tensor): a clear flag
makes the kernel return at once, and the caller discards its outputs.
``topk_from_table_select`` is the exact loop's re-match in one launch: it
reads the stale count ``viol`` on the device and computes the patch of
the ``idx`` queries, or every query, or nothing (see its docstring).

On CUDA tensors both launch ``csrc/knn_rows.cu``; on CPU tensors they run
their plain versions, the gather followed by ``topk_from_rows_reference``
(planar decode + masked squared distances + a stable sort) — the JAX
``topk_from_rows_reference`` on the gathered rows.  Both return the k
smallest squared distances ascending, ties to the lowest candidate column
(columns v-major, then slot-major ``s·E + e`` — the TPU kernel's order),
with ``sq``/``valid``/``nbrs`` bit-equal between kernel and plain version,
invalid tail included.  The kernel's schedule follows from (V, k) alone
(``schedule``): one warp a query for k ≤ ``WARP_KMAX``, else one block a
query (K7's table schedule); it takes E = 16 entries a row and
1 ≤ k ≤ KMAX, and raises beyond that.  ``_run`` / ``_launch`` take a
``mode`` that forces a schedule, for the card tests and the timings.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch, knn

KMAX = 128        # FL_SELECT_KMAX of csrc/topk_select.cuh
WARP_KMAX = 32    # FL_K2_WARP_KMAX: one output row a lane
MODES = {"block": 0, "warp_min": 1, "warp_radix": 2}   # FlK2Mode


def warp_cap(V: int, B: int) -> int:
    """A warp's list of compacted (distance, column) pairs: half a query's
    V·16·B columns, since a row keeps at most the 8 entries of its block's
    8 voxels.  A query with more valid columns takes the warp's exact path
    over all columns (slower, the same bits)."""
    return V * 8 * B


def schedule(V: int, k: int) -> str:
    """The kernel's schedule at V rows a query and k results: a warp a
    query up to k = WARP_KMAX, else a block a query.  The warp selects by k
    rounds of a warp min up to k = 8 (k = 16 beyond 8 rows, whose longer
    lists make the radix passes dearer), above that by the radix select:
    the faster of the two at every (V, k) the port launches (PERF §6)."""
    if k > WARP_KMAX:
        return "block"
    return "warp_min" if k <= (16 if V > 8 else 8) else "warp_radix"


def candidate_d2(rows, nc, queries, *, E: int, B: int):
    """Masked squared distances (N, V·B·E) and candidate coords (N,V·B·E,3)."""
    from fast_limo_tpu_torch.models import mapper as mp

    cand_pts, cand_valid = mp.cands_from_rows(rows, nc, None, B)
    N = queries.shape[0]
    pts = cand_pts.reshape(N, -1, 3)
    return knn.masked_d2(pts, cand_valid.reshape(N, -1), queries), pts


def topk_from_rows_reference(rows, nc, queries, *, E: int, B: int, k: int):
    """The plain top-k over gathered rows (N,V,WP)."""
    d2, pts = candidate_d2(rows, nc, queries, E=E, B=B)
    sq, idx = torch.sort(d2, dim=1, stable=True)
    sq, idx = sq[:, :k], idx[:, :k]
    nbrs = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))
    return nbrs, sq, torch.isfinite(sq)


def topk_from_table_reference(ptable, row_idx, nc, queries, *, E: int, B: int, k: int):
    """The plain version: the gather, then ``topk_from_rows_reference``."""
    return topk_from_rows_reference(ptable[row_idx.long()], nc, queries, E=E, B=B, k=k)


def topk_from_table_select_reference(ptable, row_idx, nc, queries, idx, *, E: int, B: int,
                                     k: int):
    """The select entry's plain version: both branches, the patch as the
    plain version on the ``idx`` rows, the full re-match on every query."""
    patch = topk_from_table_reference(ptable, row_idx[idx], nc[idx], queries[idx], E=E, B=B,
                                      k=k)
    return patch, topk_from_table_reference(ptable, row_idx, nc, queries, E=E, B=B, k=k)


def _outputs(N: int, k: int, dev):
    return (torch.empty((N, k, 3), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.bool, device=dev))


def _run(ptable, row_idx, nc, queries, active, viol, idx, *, E: int, B: int, k: int,
         mode=None):
    """One launch: the full outputs, and with ``viol`` the patch's too;
    ``mode`` forces a schedule."""
    N, V = nc.shape[0], nc.shape[1]
    WP = ptable.shape[-1]
    C = V * E * B
    if not 1 <= k <= min(KMAX, C):
        raise ValueError(f"the knn_rows kernel takes 1 <= k <= min({KMAX}, C = {C}), got {k}")
    if E != 16 or WP != 4 * E + 3 * E * B:
        raise ValueError(f"row width {WP} is not one planar group of E=16 entries, B={B}")
    mode = mode or schedule(V, k)
    if mode != "block" and k > WARP_KMAX:
        raise ValueError(f"the warp schedule takes k <= {WARP_KMAX}, got {k}")
    dispatch.require(ptable, "ptable", shape=(ptable.shape[0], WP))
    dispatch.require(row_idx, "row_idx", dtype=torch.int32, shape=(N, V))
    dispatch.require(nc, "nc", dtype=torch.int32, shape=(N, V, 3))
    dispatch.require(queries, "queries", shape=(N, 3))
    dev = ptable.device
    full = _outputs(N, k, dev)
    patch = (None, None, None)
    if viol is not None:
        dispatch.require(viol, "viol", dtype=torch.int32, shape=())
        dispatch.require(idx, "idx", dtype=torch.int64, shape=(idx.shape[0],))
        if not 1 <= idx.shape[0] <= N:
            raise ValueError(f"idx has {idx.shape[0]} rows for {N} queries")
        patch = _outputs(idx.shape[0], k, dev)
    cap = warp_cap(V, B) if mode != "block" else min(C, knn.CAP)
    err = dispatch.library().fl_knn_rows(
        dispatch.ptr(ptable), dispatch.ptr(row_idx), dispatch.ptr(nc), dispatch.ptr(queries),
        dispatch.flag(active), None if viol is None else dispatch.ptr(viol),
        None if viol is None else dispatch.ptr(idx), N, V, WP, E, B, k, MODES[mode], cap,
        0 if viol is None else idx.shape[0], *(dispatch.ptr(t) for t in full),
        *(None if t is None else dispatch.ptr(t) for t in patch), dispatch.stream())
    dispatch.check(err, "knn_rows")
    topk_from_table.launches += 1
    topk_from_table.window_launches += int(viol is None)
    return patch, full


def _launch(ptable, row_idx, nc, queries, active, *, E: int, B: int, k: int, mode=None):
    """``topk_from_table`` on CUDA tensors; ``mode`` forces a schedule."""
    return _run(ptable, row_idx, nc, queries, active, None, None, E=E, B=B, k=k, mode=mode)[1]


def topk_from_table(ptable, row_idx, nc, queries, *, E: int, B: int, k: int, active=None):
    """ptable (G,WP) f32, row_idx (N,V) int32 table rows, nc (N,V,3) int32
    block coords, queries (N,3) → (nbrs (N,k,3), sq (N,k) ascending,
    valid (N,k)): the top-k over the rows ``ptable[row_idx]``.  With
    ``active`` (() bool) clear the kernel does nothing and the outputs are
    unspecified (on the CPU the plain version computes them anyway)."""
    if not dispatch.on_cuda(ptable):
        return topk_from_table_reference(ptable, row_idx, nc, queries, E=E, B=B, k=k)
    return _launch(ptable.contiguous(), row_idx.to(torch.int32).contiguous(),
                   nc.to(torch.int32).contiguous(), queries.contiguous(), active,
                   E=E, B=B, k=k)


# One count for the kernel: both entries add to it; the launches without a
# select patch (the window resolves) are counted apart as well.
dispatch.counted(topk_from_table, "window_launches")


def topk_from_table_select(ptable, row_idx, nc, queries, idx, viol, *, E: int, B: int, k: int,
                           active=None):
    """The exact loop's re-match, one launch: ptable, row_idx (N,V), nc
    (N,V,3), queries (N,3) as ``topk_from_table``; idx (budget,) int64 the
    patch's queries (the stale ones first); viol () int32 the stale count
    → (patch, full), each (nbrs, sq, valid), of budget and N rows.  On the
    card: nothing when ``active`` is clear or ``viol == 0``; the patch
    (row i: query idx[i]) when ``0 < viol ≤ budget``; else the full
    re-match.  The branch not taken is unspecified.  On the CPU both come
    from the plain version."""
    if not dispatch.on_cuda(ptable):
        return topk_from_table_select_reference(ptable, row_idx, nc, queries, idx, E=E, B=B,
                                                k=k)
    return _run(ptable.contiguous(), row_idx.to(torch.int32).contiguous(),
                nc.to(torch.int32).contiguous(), queries.contiguous(), active,
                viol.contiguous(), idx.contiguous(), E=E, B=B, k=k)
