"""The iEKF gain algebra (port of fast_limo_tpu/ops/gain.py).

From the sufficient statistics (HᵀH, Hᵀh), the chart-projected covariance
P and the scalar noise R (reference esekfom.hpp:1701-1709):

    L    = masked-Cholesky(HᵀH)  ;  H̃ = Lᵀ  ;  h̃ = L⁻¹(Hᵀh)
    S    = H̃·P[:12,:12]·H̃ᵀ/R + I
    K    = P[:, :12]·H̃ᵀ·S⁻¹/R   (Gauss-Jordan WITH partial pivoting —
                                 load-bearing: f32 P's slight asymmetry
                                 makes S slightly indefinite)
    K_x  = K·H̃ ; K_h = K·h̃

``gain`` launches K8 (``csrc/gain.cu``) on CUDA tensors; on CPU tensors it
runs ``gain_math``, its plain version: the exact algebra of the device
function ``csrc/gain.cuh``, which K8 launches standalone and the
iteration-body kernels K5/K6 run inside their body.  ``gain_reference``
solves with ``torch.linalg.solve`` (the second oracle).
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

M = 12   # observed dims
NS = 23  # error-state dims


def gain_reference(HTH, HTh, P, R):
    """Returns ``(K_x (23,12), K_h (23,), K (23,12))``."""
    from fast_limo_tpu_torch.ops import linalg

    Ht12, h_c = linalg.masked_chol_compress(HTH, HTh)
    PHt = P[:, 0:M] @ Ht12.T
    S = (Ht12 @ PHt[0:M]) / R + torch.eye(M, dtype=P.dtype, device=P.device)
    K_ = torch.linalg.solve(S.T, PHt.T).T / R
    return K_ @ Ht12, K_ @ h_c, K_


def gain_math(A, u, Pm, inv_R):
    """The kernel's gain algebra on plain tensors.

    A (M,M) = HᵀH, u (M,) = Hᵀh, Pm (NS,M) = P[:, :12], inv_R scalar.
    Returns (K_x (NS,M), K_h (NS,), K (NS,M))."""
    A = A.clone()
    diag = torch.diagonal(A).clone()
    iszero = diag == 0.0
    idx = torch.arange(M, device=A.device)
    A[idx, idx] = torch.where(iszero, torch.ones_like(diag), diag)
    dead = 1e-12 * diag.max()

    # masked Cholesky A = L·Lᵀ (left-looking)
    L = torch.zeros_like(A)
    for j in range(M):
        a_j = A[:, j] - L @ L[j]
        d = a_j[j]
        inv_p = torch.where(d > dead, torch.rsqrt(torch.clamp(d, min=1e-30)),
                            torch.zeros_like(d))
        L[:, j] = torch.where(idx >= j, a_j * inv_p, torch.zeros_like(a_j))

    Ht = torch.where(iszero[:, None], torch.zeros_like(L), L.T)
    h = torch.zeros_like(u)
    for i in range(M):
        acc = u[i] - torch.sum(L[i] * h)
        dd = L[i, i]
        nz = dd != 0.0
        inv_d = torch.where(nz, 1.0 / torch.where(nz, dd, torch.ones_like(dd)),
                            torch.zeros_like(dd))
        h[i] = acc * inv_d
    h = torch.where(iszero, torch.zeros_like(h), h)

    PHt = Pm @ Ht.T                                        # (NS, M)
    S = (Ht @ PHt[:M]) * inv_R + torch.eye(M, dtype=A.dtype, device=A.device)

    # Gauss-Jordan with partial pivoting on Sᵀ; RHS = PHtᵀ (M, NS)
    Aug = torch.cat([S.T, PHt.T], dim=1)                   # (M, M+NS)
    for k in range(M):
        cand = torch.where(idx >= k, torch.abs(Aug[:, k]),
                           torch.full_like(Aug[:, k], -1.0))
        piv = torch.argmax(cand).reshape(1)              # the pivot row, on the device
        is_piv = (idx == piv)[:, None]
        rp = Aug.index_select(0, piv)[0]
        rk = Aug[k].clone()
        pkv = rp[k]
        nz = pkv != 0.0
        inv_pk = torch.where(nz, 1.0 / torch.where(nz, pkv, torch.ones_like(pkv)),
                             torch.zeros_like(pkv))
        prow = rp * inv_pk
        Aug = torch.where(is_piv, rk[None, :], Aug)
        Aug[k] = prow
        factor = Aug[:, k].clone()
        factor[k] = 0.0
        Aug = Aug - factor[:, None] * prow[None, :]

    K = Aug[:, M:].T * inv_R                               # (NS, M)
    return K @ Ht, torch.sum(K * h[None, :], dim=1), K


def _launch(HTH, HTh, P, R):
    dev = P.device
    dispatch.require(HTH, "HTH", shape=(M, M))
    dispatch.require(HTh, "HTh", shape=(M,))
    dispatch.require(P, "P", shape=(NS, NS))
    K_x = torch.empty((NS, M), dtype=torch.float32, device=dev)
    K_h = torch.empty(NS, dtype=torch.float32, device=dev)
    K = torch.empty((NS, M), dtype=torch.float32, device=dev)
    err = dispatch.library().fl_gain(
        dispatch.ptr(HTH), dispatch.ptr(HTh), dispatch.ptr(P), 1.0 / float(R),
        dispatch.ptr(K_x), dispatch.ptr(K_h), dispatch.ptr(K), dispatch.stream())
    dispatch.check(err, "gain")
    gain.launches += 1
    return K_x, K_h, K


def gain(HTH, HTh, P, R):
    """K8: ``(K_x (23,12), K_h (23,), K (23,12))`` from HᵀH (12,12), Hᵀh
    (12,), the chart-projected covariance P (23,23; columns 0:12 are read)
    and the scalar noise R.  A CUDA tensor goes through the kernel (float32,
    contiguous, exact shapes: anything else raises), a CPU tensor through
    ``gain_math``."""
    if not dispatch.on_cuda(P):
        inv_R = torch.tensor(1.0 / R, dtype=P.dtype)
        return gain_math(HTH, HTh, P[:, 0:M], inv_R)
    return _launch(HTH, HTh, P, R)


dispatch.counted(gain)
