"""Batched plane fitting with the reference's validity gates (port of
fast_limo_tpu/ops/plane.py; reference Objects/Plane.cpp:23-121).

The fit is the translation-invariant centroid-PCA plane of the JAX package
(see its module docstring for the deliberate divergence from the
reference's origin-dependent estimator).  ``fit_planes`` is the K3 kernel
wrapper (ops/plane_kernel.py): gated-out rows come back zero.
``_eigvals_sym3`` and ``_null_vector`` are the closed-form 3×3 pieces as
plain functions on tensors (``icp.estimate_normals`` uses them).
"""

from __future__ import annotations

import torch

from reference.lio import plane_kernel


def _eigvals_sym3(M):
    """Closed-form ascending eigenvalues (lmin, lmid, lmax) of batched
    symmetric 3×3 matrices (trigonometric method on the matrix scaled by
    its own deviator norm, so intermediates are O(1) at any point scale)."""
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    q = (m00 + m11 + m22) / 3.0
    p2 = ((m00 - q) ** 2 + (m11 - q) ** 2 + (m22 - q) ** 2) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    psafe = torch.where(p > 0, p, torch.ones_like(p))
    b00, b11, b22 = (m00 - q) / psafe, (m11 - q) / psafe, (m22 - q) / psafe
    c01, c02, c12 = m01 / psafe, m02 / psafe, m12 / psafe
    detB = (b00 * (b11 * b22 - c12 * c12)
            - c01 * (c01 * b22 - c12 * c02)
            + c02 * (c01 * c12 - b11 * c02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    lmid = 3.0 * q - lmax - lmin
    iso = p2 <= 0          # all eigenvalues equal q
    return torch.where(iso, q, lmin), torch.where(iso, q, lmid), torch.where(iso, q, lmax)


def _null_vector(M, lam):
    """Unit vector spanning the (near-)null space of ``M − lam·I``: the
    largest-norm cross product of row pairs.  Returns (vector, ok)."""
    A = M - lam[..., None, None] * torch.eye(3, dtype=M.dtype, device=M.device)
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    bestn = torch.clamp(torch.maximum(torch.maximum(n01, n02), n12), min=0.0)
    norm = torch.sqrt(bestn)
    ok = norm > 1e-20
    return best / torch.where(ok, norm, torch.ones_like(norm))[..., None], ok


def fit_planes(nbrs, sq_dists, nbr_valid, *, num_match_points: int,
               max_dist_plane: float, plane_threshold: float, active=None):
    """nbrs (N,k,3), sq_dists (N,k) ascending, nbr_valid (N,k) →
    (n_abcd (N,4) with ``n·p + d ≈ 0``, ``|n| = 1``, ``d ≥ 0``; good (N,));
    ``active``: K3's optional flag (``plane_kernel.fit_planes``)."""
    return plane_kernel.fit_planes(
        nbrs, sq_dists, nbr_valid, num_match_points=num_match_points,
        max_dist_plane=max_dist_plane, plane_threshold=plane_threshold, active=active)


def point_to_plane(n_abcd, pts):
    """Signed distance n·p + d (Plane.cpp:50-56)."""
    return torch.sum(n_abcd[..., :3] * pts, dim=-1) + n_abcd[..., 3]
