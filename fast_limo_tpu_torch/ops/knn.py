"""K7 — masked k nearest (port of fast_limo_tpu/ops/knn.py), two entries.

``masked_topk`` takes dense per-query candidates (N, C, 3) and their mask;
``masked_topk_from_table`` takes the map's planar table, an (N, V) int32
row index and the (N, V, 3) block coordinates, and decodes the rows in the
kernel (block match, bucket counts), so neither the gathered rows nor the
(N, C, 3) candidates are materialised — ``mapper.radius_search``'s wide
branch calls it once for all its queries.  On CUDA tensors both launch
``csrc/masked_topk.cu``; on CPU tensors they run their plain versions,
``masked_topk_reference`` (masked squared distances in the association
order ``(dx² + dy²) + dz²``, then a stable sort) and, for the table entry,
the gather → ``mapper.cands_from_rows`` → ``masked_topk_reference``
composition.  Both return the k smallest squared distances ascending,
ties to the lowest candidate column, with ``sq``/``valid``/``nbrs``
bit-equal between kernel and plain version, invalid tail included.

The kernel compacts a query's valid columns into shared memory (``CAP``
at most, 8 bytes each) and selects there; a query with more valid columns
takes the kernel's multi-pass select over global memory.  It takes
``k ≤ KMAX`` and ``k ≤ C``; beyond that it raises.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

KMAX = 128       # FL_SELECT_KMAX of csrc/topk_select.cuh
# A query's block (256 threads, FL_K7_NT of csrc/compact_select.cuh) holds
# at most CAP compacted entries (8 bytes each, 32 KB of shared memory); a
# query with more valid columns takes the kernel's global path.
CAP = 4096


def masked_d2(cand_pts, cand_valid, queries):
    """(N,C) squared distances, +inf where the candidate is invalid."""
    dx = cand_pts[..., 0] - queries[:, 0:1]
    dy = cand_pts[..., 1] - queries[:, 1:2]
    dz = cand_pts[..., 2] - queries[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz      # the kernel's association order
    return torch.where(cand_valid, d2, torch.full_like(d2, float("inf")))


def _check_k(C: int, k: int) -> None:
    if not 1 <= k <= C:
        raise ValueError(f"k = {k} needs 1 <= k <= C = {C} candidates")


def masked_topk_reference(cand_pts, cand_valid, queries, *, k: int):
    _check_k(cand_pts.shape[1], k)
    sq, idx = torch.sort(masked_d2(cand_pts, cand_valid, queries), dim=1, stable=True)
    sq, idx = sq[:, :k], idx[:, :k]
    nbrs = torch.gather(cand_pts, 1, idx[..., None].expand(-1, -1, 3))
    valid = torch.isfinite(sq)
    return nbrs, torch.where(valid, sq, torch.full_like(sq, float("inf"))), valid


def masked_topk_from_table_reference(ptable, row_idx, ncb, queries, *, E: int, B: int, k: int):
    """The table entry's plain version: ``ptable[row_idx]`` →
    ``cands_from_rows`` → ``masked_topk_reference``, in query chunks that
    bound the gathered rows to 2^24 floats (queries are independent, so
    the chunks change no bit)."""
    from fast_limo_tpu_torch.models import mapper

    N, V = row_idx.shape
    _check_k(V * E * B, k)
    chunk = max(8, (1 << 24) // max(1, V * ptable.shape[1]))
    outs = []
    for i0 in range(0, N, chunk):
        rows = ptable[row_idx[i0:i0 + chunk].long()]
        cand_pts, cand_valid = mapper.cands_from_rows(rows, ncb[i0:i0 + chunk], None, B)
        n = rows.shape[0]
        outs.append(masked_topk_reference(cand_pts.reshape(n, -1, 3), cand_valid.reshape(n, -1),
                                          queries[i0:i0 + chunk], k=k))
    if not outs:
        z = queries.new_zeros((0, k))
        return queries.new_zeros((0, k, 3)), z, z.bool()
    return tuple(torch.cat(x) for x in zip(*outs))


def _outputs(N: int, k: int, dev):
    return (torch.empty((N, k, 3), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.float32, device=dev),
            torch.empty((N, k), dtype=torch.bool, device=dev))


def _check_kmax(k: int) -> None:
    if k > KMAX:
        raise ValueError(f"the masked_topk kernel takes k <= {KMAX}, got {k}")


def _launch(cand_pts, cand_valid, queries, *, k: int):
    N, C, _ = cand_pts.shape
    _check_k(C, k)
    _check_kmax(k)
    dispatch.require(cand_pts, "cand_pts", shape=(N, C, 3))
    dispatch.require(cand_valid, "cand_valid", dtype=torch.bool, shape=(N, C))
    dispatch.require(queries, "queries", shape=(N, 3))
    nbrs, sq, valid = _outputs(N, k, cand_pts.device)
    if N == 0:
        return nbrs, sq, valid
    err = dispatch.library().fl_masked_topk(
        dispatch.ptr(cand_pts), dispatch.ptr(cand_valid), dispatch.ptr(queries), N, C, k,
        min(C, CAP), dispatch.ptr(nbrs), dispatch.ptr(sq), dispatch.ptr(valid),
        dispatch.stream())
    dispatch.check(err, "masked_topk")
    masked_topk.launches += 1
    return nbrs, sq, valid


def masked_topk(cand_pts, cand_valid, queries, *, k: int):
    """cand_pts (N,C,3) f32, cand_valid (N,C) bool, queries (N,3) →
    (nbrs (N,k,3), sq (N,k) ascending, valid (N,k)); invalid lanes carry
    ``sq = +inf``."""
    if not dispatch.on_cuda(cand_pts):
        return masked_topk_reference(cand_pts, cand_valid, queries, k=k)
    return _launch(cand_pts.to(torch.float32).contiguous(), cand_valid.to(torch.bool).contiguous(),
                   queries.to(torch.float32).contiguous(), k=k)


dispatch.counted(masked_topk)


def _launch_table(ptable, row_idx, ncb, queries, *, E: int, B: int, k: int):
    N, V = row_idx.shape
    WP = ptable.shape[-1]
    C = V * E * B
    _check_k(C, k)
    _check_kmax(k)
    if E != 16 or WP != 4 * E + 3 * E * B:
        raise ValueError(f"row width {WP} is not one planar group of E=16 entries, B={B}")
    dispatch.require(ptable, "ptable", shape=(ptable.shape[0], WP))
    dispatch.require(row_idx, "row_idx", dtype=torch.int32, shape=(N, V))
    dispatch.require(ncb, "ncb", dtype=torch.int32, shape=(N, V, 3))
    dispatch.require(queries, "queries", shape=(N, 3))
    nbrs, sq, valid = _outputs(N, k, ptable.device)
    if N == 0:
        return nbrs, sq, valid
    err = dispatch.library().fl_masked_topk_table(
        dispatch.ptr(ptable), dispatch.ptr(row_idx), dispatch.ptr(ncb), dispatch.ptr(queries),
        N, V, WP, E, B, k, min(C, CAP),
        dispatch.ptr(nbrs), dispatch.ptr(sq), dispatch.ptr(valid), dispatch.stream())
    dispatch.check(err, "masked_topk_table")
    masked_topk_from_table.launches += 1
    return nbrs, sq, valid


def masked_topk_from_table(ptable, row_idx, ncb, queries, *, E: int, B: int, k: int):
    """ptable (G,WP) f32 planar map rows, row_idx (N,V) int32 table rows,
    ncb (N,V,3) int32 block coords, queries (N,3) → (nbrs (N,k,3), sq
    (N,k) ascending, valid (N,k)): ``masked_topk`` over the candidates
    ``cands_from_rows(ptable[row_idx], ncb)`` (columns v-major, then slot,
    then entry), none of which is materialised on the card."""
    if not dispatch.on_cuda(ptable):
        return masked_topk_from_table_reference(ptable, row_idx, ncb, queries, E=E, B=B, k=k)
    return _launch_table(ptable.contiguous(), row_idx.to(torch.int32).contiguous(),
                         ncb.to(torch.int32).contiguous(), queries.to(torch.float32).contiguous(),
                         E=E, B=B, k=k)


dispatch.counted(masked_topk_from_table)
