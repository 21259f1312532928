"""K7 — masked k nearest over dense per-query candidate sets (port of
fast_limo_tpu/ops/knn.py).

``masked_topk`` launches ``csrc/masked_topk.cu`` on CUDA tensors and runs
``masked_topk_reference`` (plain torch: masked squared distances in the
association order ``(dx² + dy²) + dz²``, then a stable sort) on CPU
tensors.  Both return the k smallest squared distances ascending, ties to
the lowest candidate column, with ``sq``/``valid`` bit-equal between the
two.  The kernel takes ``k ≤ KMAX`` and ``k ≤ C``; beyond that it raises.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

KMAX = 128      # FL_SELECT_KMAX of csrc/topk_select.cuh


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


def _launch(cand_pts, cand_valid, queries, *, k: int):
    N, C, _ = cand_pts.shape
    _check_k(C, k)
    if k > KMAX:
        raise ValueError(f"the masked_topk kernel takes k <= {KMAX}, got {k}")
    dispatch.require(cand_pts, "cand_pts", shape=(N, C, 3))
    dispatch.require(cand_valid, "cand_valid", dtype=torch.bool, shape=(N, C))
    dispatch.require(queries, "queries", shape=(N, 3))
    dev = cand_pts.device
    nbrs = torch.empty((N, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((N, k), dtype=torch.float32, device=dev)
    valid = torch.empty((N, k), dtype=torch.bool, device=dev)
    if N == 0:
        return nbrs, sq, valid
    err = dispatch.library().fl_masked_topk(
        dispatch.ptr(cand_pts), dispatch.ptr(cand_valid), dispatch.ptr(queries), N, C, k,
        dispatch.ptr(nbrs), dispatch.ptr(sq), dispatch.ptr(valid), dispatch.stream())
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


masked_topk.launches = 0
