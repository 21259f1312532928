"""K2 — k nearest candidates from gathered planar block rows (port of
fast_limo_tpu/ops/knn_rows.py).

``topk_from_rows`` launches ``csrc/knn_rows.cu`` on CUDA tensors and runs
``topk_from_rows_reference`` (plain torch: planar decode + masked squared
distances + a stable sort) on CPU tensors.  Both return the k smallest
squared distances ascending, ties to the lowest candidate column (columns
v-major, then slot-major ``s·E + e`` — the TPU kernel's order), with
``sq``/``valid`` bit-equal between the two.  The kernel takes k ≤ KMAX
(the radix select of ``csrc/topk_select.cuh``); beyond that it raises.
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
    d2, pts = candidate_d2(rows, nc, queries, E=E, B=B)
    sq, idx = torch.sort(d2, dim=1, stable=True)
    sq, idx = sq[:, :k], idx[:, :k]
    nbrs = torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))
    return nbrs, sq, torch.isfinite(sq)


def _launch(rows, nc, queries, *, E: int, B: int, k: int):
    N, V, WP = rows.shape
    if not 1 <= k <= KMAX:
        raise ValueError(f"the knn_rows kernel takes 1 <= k <= {KMAX}, got {k}")
    if WP != 4 * E + 3 * E * B:
        raise ValueError(f"row width {WP} is not one planar group of E={E}, B={B}")
    dispatch.require(rows, "rows")
    dispatch.require(nc, "nc", dtype=torch.int32, shape=(N, V, 3))
    dispatch.require(queries, "queries", shape=(N, 3))
    dev = rows.device
    nbrs = torch.empty((N, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((N, k), dtype=torch.float32, device=dev)
    valid = torch.empty((N, k), dtype=torch.bool, device=dev)
    err = dispatch.library().fl_knn_rows(
        dispatch.ptr(rows), dispatch.ptr(nc), dispatch.ptr(queries), N, V, WP,
        E, B, k, dispatch.ptr(nbrs), dispatch.ptr(sq), dispatch.ptr(valid),
        dispatch.stream())
    dispatch.check(err, "knn_rows")
    topk_from_rows.launches += 1
    return nbrs, sq, valid


def topk_from_rows(rows, nc, queries, *, E: int, B: int, k: int):
    """rows (N,V,WP) f32, nc (N,V,3) int32 block coords, queries (N,3) →
    (nbrs (N,k,3), sq (N,k) ascending, valid (N,k))."""
    if not dispatch.on_cuda(rows):
        return topk_from_rows_reference(rows, nc, queries, E=E, B=B, k=k)
    return _launch(rows.contiguous(), nc.to(torch.int32).contiguous(),
                   queries.contiguous(), E=E, B=B, k=k)


topk_from_rows.launches = 0
