"""Small-cloud rigid registration for loop-closure verification (port of
fast_limo_tpu/models/icp.py).

Correspondence search is a dense (M,N) squared-distance matrix — one
matrix product — followed by a weighted Kabsch/Umeyama solve per
iteration.  The iterations are Python loops of fixed length with no host
read inside.  Used to turn a ScanContext hit into a verified relative-pose
constraint and for relocalization refinement.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fast_limo_tpu_torch.ops import plane as plane_op
from fast_limo_tpu_torch.ops import so3


class ICPResult(NamedTuple):
    quat: torch.Tensor       # (4,) target←source rotation
    trans: torch.Tensor      # (3,)
    rmse: torch.Tensor       # () inlier RMSE
    n_inliers: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool


def _sq_dists(a, b):
    """(M,N) squared distances via the |a|²+|b|²−2a·b expansion."""
    return (torch.sum(a * a, dim=-1)[:, None]
            + torch.sum(b * b, dim=-1)[None, :]
            - 2.0 * a @ b.T)


def _kabsch(src, dst, w):
    """Weighted rigid alignment src→dst: returns (R, t)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def _nearest(moved, src_valid, dst_masked, big):
    """Nearest masked destination per source point: (index (M,), d² (M,)).
    The expansion can go slightly negative in float32, so d² is floored."""
    d2 = _sq_dists(torch.where(src_valid[:, None], moved, -big), dst_masked)
    nn_d2, nn = torch.min(d2, dim=1)
    return nn, torch.clamp(nn_d2, min=0.0)


def icp(src, src_valid, dst, dst_valid, *, init_quat=None, init_trans=None,
        max_corr_dist: float = 2.0, iters: int = 10,
        coarse_mult: float = 4.0) -> ICPResult:
    """Point-to-point ICP aligning ``src`` onto ``dst``.

    src (M,3) / dst (N,3) with validity masks; init transform optional.
    The correspondence gate anneals from ``coarse_mult*max_corr_dist`` down
    to ``max_corr_dist`` (coarse-to-fine) so far, rotation-informative
    points are not rejected before the pose is roughly right."""
    dtype, dev = src.dtype, src.device
    q = init_quat.to(dtype) if init_quat is not None else so3.quat_identity(dtype, dev)
    t = init_trans.to(dtype) if init_trans is not None else torch.zeros(3, dtype=dtype, device=dev)

    big = torch.tensor(1e9, dtype=dtype, device=dev)
    dst_masked = torch.where(dst_valid[:, None], dst, big)
    gates = torch.linspace(coarse_mult, 1.0, iters, dtype=dtype) * max_corr_dist

    rmse = wsum = None
    for gate in gates.tolist():
        moved = so3.quat_rotate(q, src) + t
        nn, nn_d2 = _nearest(moved, src_valid, dst_masked, big)
        w = (src_valid & (nn_d2 < gate * gate)).to(dtype)
        R_d, t_d = _kabsch(moved, dst[nn], w)
        q = so3.quat_mul(so3.mat_to_quat(R_d), q)
        t = R_d @ t + t_d
        wsum = torch.sum(w)
        rmse = torch.sqrt(torch.sum(nn_d2 * w) / torch.clamp(wsum, min=1.0))
    return ICPResult(quat=q, trans=t, rmse=rmse, n_inliers=wsum.to(torch.int32),
                     converged=rmse < max_corr_dist)


def estimate_normals(pts, valid, *, k: int = 12, chunk: int = 1024):
    """Per-point unit normals from k-NN centered PCA (batched, chunked).

    The (chunk,N) distance tiles keep memory bounded for rebuild-density
    clouds.  Returns ``(normals (N,3), ok (N,))`` — ``ok`` is False where
    the neighborhood is rank-deficient or the point is invalid.
    Orientation is arbitrary (point-to-plane residuals are sign-invariant
    through Gauss-Newton)."""
    dtype = pts.dtype
    N = pts.shape[0]
    big = torch.tensor(1e9, dtype=dtype, device=pts.device)
    masked = torch.where(valid[:, None], pts, big)
    nrm, oks = [], []
    for i0 in range(0, N, chunk):
        d2 = _sq_dists(masked[i0:i0 + chunk], masked)       # (chunk, N)
        neg, idx = torch.topk(-d2, k, dim=1)                # ascending distance
        nbrs = pts[idx]                                     # (chunk, k, 3)
        nvalid = valid[idx] & (-neg < big)
        cnt = torch.sum(nvalid, dim=1)
        c = torch.sum(nbrs * nvalid[..., None], dim=1) / torch.clamp(cnt, min=1.0)[:, None]
        qv = (nbrs - c[:, None, :]) * nvalid[..., None]
        M = torch.einsum("nki,nkj->nij", qv, qv)
        lmin, lmid, _ = plane_op._eigvals_sym3(M)
        n_unit, ok = plane_op._null_vector(M, lmin)
        # surface-ness: the patch must be anisotropic (planar, not
        # volumetric noise) and populated
        nrm.append(n_unit)
        oks.append(ok & (cnt >= 5) & (lmid > 4.0 * lmin))
    return torch.cat(nrm), torch.cat(oks) & valid


def icp_point_to_plane(src, src_valid, dst, dst_valid, dst_normals, nrm_ok,
                       *, init_quat, init_trans, max_corr_dist: float = 1.0,
                       iters: int = 8, huber: float = 0.3) -> ICPResult:
    """Point-to-plane refinement: minimizes ``Σ w·(n_j·(R·p_i + t − q_j))²``
    by Gauss-Newton with Huber IRLS weights.  Run AFTER a coarse
    point-to-point alignment (which plateaus at about half the cloud's
    sampling distance)."""
    dtype, dev = src.dtype, src.device
    big = torch.tensor(1e9, dtype=dtype, device=dev)
    dst_masked = torch.where((dst_valid & nrm_ok)[:, None], dst, big)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    q, t = init_quat.to(dtype), init_trans.to(dtype)
    rmse = n_in = None
    for _ in range(iters):
        moved = so3.quat_rotate(q, src) + t
        nn, nn_d2 = _nearest(moved, src_valid, dst_masked, big)
        n = dst_normals[nn]                              # (M,3)
        r = torch.sum(n * (moved - dst[nn]), dim=-1)     # (M,)
        w = (src_valid & (nn_d2 < max_corr_dist * max_corr_dist)).to(dtype)
        # Huber IRLS on the plane residual
        w = w * torch.clamp(huber / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
        J = torch.cat([so3.cross(moved, n), n], dim=-1)  # (M,6)
        Jw = J * w[:, None]
        A = Jw.T @ J + 1e-6 * eye6
        b = -Jw.T @ r
        xi = torch.linalg.solve(A, b)                    # [ω, δt]
        dq = so3.exp_quat(xi[:3])
        q = so3.quat_normalize(so3.quat_mul(dq, q))
        t = so3.quat_rotate(dq, t) + xi[3:]
        rmse = torch.sqrt(torch.sum(w * r * r) / torch.clamp(torch.sum(w), min=1.0))
        n_in = torch.sum((w > 0).to(torch.int32))
    return ICPResult(quat=q, trans=t, rmse=rmse, n_inliers=n_in.to(torch.int32),
                     converged=rmse < max_corr_dist)
