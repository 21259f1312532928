"""K2 — k nearest candidates from planar block rows (port of
fast_limo_tpu/ops/knn_rows.py).

``topk_from_table`` takes the map's planar table and an (N, V) int32 row
index (``mapper.block_rows``), so the block-row gather is never
materialised.  Every caller goes through it: the main path's window
resolve and the exact loop's re-matches, and the map queries
(``mapper.knn``, the narrow ``radius_search`` branches).  It also takes
an optional active flag (a () bool device tensor): a clear flag makes the
kernel return at once, and the caller discards its outputs.

On CUDA tensors it launches ``csrc/knn_rows.cu``; on CPU tensors it runs
its plain version, the gather followed by ``topk_from_rows_reference``
(planar decode + masked squared distances + a stable sort) — the JAX
``topk_from_rows_reference`` on the gathered rows.  Both return the k
smallest squared distances ascending, ties to the lowest candidate column
(columns v-major, then slot-major ``s·E + e`` — the TPU kernel's order),
with ``sq``/``valid`` bit-equal between kernel and plain version.  The
kernel takes k ≤ KMAX (the radix select of ``csrc/topk_select.cuh``);
beyond that it raises.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch, knn

KMAX = 128      # FL_SELECT_KMAX of csrc/topk_select.cuh


def candidate_d2(rows, nc, queries, *, E: int, B: int):
    """Masked squared distances (N, V·B·E) and candidate coords (N,V·B·E,3)."""
    from fast_limo_tpu_torch.models import mapper as mp

    cand_pts, cand_valid = mp.cands_from_rows(rows, nc, B)
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


def _launch(ptable, row_idx, nc, queries, active, *, E: int, B: int, k: int):
    N, V = nc.shape[0], nc.shape[1]
    WP = ptable.shape[-1]
    if not 1 <= k <= KMAX:
        raise ValueError(f"the knn_rows kernel takes 1 <= k <= {KMAX}, got {k}")
    if WP != 4 * E + 3 * E * B:
        raise ValueError(f"row width {WP} is not one planar group of E={E}, B={B}")
    dispatch.require(ptable, "ptable", shape=(ptable.shape[0], WP))
    dispatch.require(row_idx, "row_idx", dtype=torch.int32, shape=(N, V))
    dispatch.require(nc, "nc", dtype=torch.int32, shape=(N, V, 3))
    dispatch.require(queries, "queries", shape=(N, 3))
    dev = ptable.device
    nbrs = torch.empty((N, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((N, k), dtype=torch.float32, device=dev)
    valid = torch.empty((N, k), dtype=torch.bool, device=dev)
    err = dispatch.library().fl_knn_rows(
        dispatch.ptr(ptable), dispatch.ptr(row_idx), dispatch.ptr(nc), dispatch.ptr(queries),
        N, V, WP, E, B, k, dispatch.flag(active),
        dispatch.ptr(nbrs), dispatch.ptr(sq), dispatch.ptr(valid), dispatch.stream())
    dispatch.check(err, "knn_rows")
    topk_from_table.launches += 1
    return nbrs, sq, valid


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


topk_from_table.launches = 0
