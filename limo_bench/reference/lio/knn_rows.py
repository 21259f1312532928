"""K2's plain versions (the port's ``ops/knn_rows``): the top-k over map-table rows
and the exact loop's re-match select, in PyTorch."""

from __future__ import annotations

import torch

from reference.lio import knn

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
    from reference.lio import mapper as mp

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


def topk_from_table(ptable, row_idx, nc, queries, *, E: int, B: int, k: int, active=None):
    """ptable (G,WP) f32, row_idx (N,V) int32 table rows, nc (N,V,3) int32
    block coords, queries (N,3) → (nbrs (N,k,3), sq (N,k) ascending,
    valid (N,k)): the top-k over the rows ``ptable[row_idx]``.  With
    ``active`` (() bool) clear the kernel does nothing and the outputs are
    unspecified (on the CPU the plain version computes them anyway)."""
    return topk_from_table_reference(ptable, row_idx, nc, queries, E=E, B=B, k=k)


# One count for the kernel: both entries add to it.


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
    return topk_from_table_select_reference(ptable, row_idx, nc, queries, idx, E=E, B=B,
                                            k=k)
