"""Small unrolled factorizations (port of the parts of
fast_limo_tpu/ops/linalg.py the update uses): the masked Cholesky
measurement compression behind ``gain.gain_reference``."""

from __future__ import annotations

import torch


def chol(A, *, dead_thresh=0.0):
    """Lower-triangular Cholesky of a small SPD matrix, column by column.
    A pivot ≤ ``dead_thresh`` drops its whole column (graceful rank loss)."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        a_j = A[:, j]
        for L_k in cols:
            a_j = a_j - L_k * L_k[j]
        d = a_j[j]
        alive = d > dead_thresh
        safe = torch.sqrt(torch.clamp(d, min=1e-30))
        inv = torch.where(alive, 1.0 / safe, torch.zeros_like(safe))
        cols.append(a_j * inv * (idx >= j).to(A.dtype))
    return torch.stack(cols, dim=1)


def solve_lower(L, b):
    """x with L x = b (L lower-triangular, b a vector), forward substitution."""
    rows = []
    for i in range(L.shape[0]):
        acc = b[i]
        for k, r in enumerate(rows):
            acc = acc - L[i, k] * r
        d = L[i, i]
        nz = d != 0
        inv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                          torch.zeros_like(d))
        rows.append(acc * inv)
    return torch.stack(rows)


def masked_chol_compress(HTH, HTh):
    """Exact 12-row compression of (HᵀH, Hᵀh) with unobserved dims:
    (H̃ (n,n), h̃ (n,)) with H̃ᵀH̃ == HᵀH and H̃ᵀh̃ == Hᵀh."""
    diag = torch.diagonal(HTH)
    iszero = diag == 0
    A = HTH + torch.diag(iszero.to(HTH.dtype))
    L = chol(A, dead_thresh=1e-12 * torch.clamp(diag.max(), min=0.0))
    Ht = L.T * (~iszero).to(HTH.dtype)[:, None]
    h = solve_lower(L, HTh)
    return Ht, torch.where(iszero, torch.zeros_like(h), h)
