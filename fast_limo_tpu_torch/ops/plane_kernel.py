"""K3 — fused plane fit + gates (port of fast_limo_tpu/ops/plane_kernel.py).

``fit_planes`` launches ``csrc/plane.cu`` on CUDA tensors and runs
``fit_planes_plain`` on CPU tensors.  Both run ``fit_math``: centroid over
the valid neighbours (select-masked), centred scatter, closed-form
eigenvalues, largest-cross-product null vector, ``d ≥ 0`` sign, and the
enough / kth-distance / residual / planarity-spread / finite gates.
Gated-out rows are exactly zero (consumers mask by ``good``).  An optional
active flag (a () bool device tensor) lets the exact update loop launch
the kernel on every scan: a clear flag makes it return at once, and the
caller discards its outputs.

``fit_planes_select`` is the exact update loop's re-match in one launch of
the same kernel: the window fit, the stale patch and the full re-match
(the JAX package's ``lax.cond`` chain), each query fitted only on the row
that the device's stale count selects (``fit_planes_select_plain``: three
``fit_planes_plain`` calls and ``merge_fits``).
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch


def fit_math(nx, ny, nz, nv, kth, *, num_match_points: int,
             max_dist_plane: float, plane_threshold: float):
    """The fit on lists of k per-query tensors (coords and 0/1 validity)."""
    k = len(nx)
    f32 = nx[0].dtype
    zero = torch.zeros_like(nx[0])
    keep = [v > 0 for v in nv]
    mx = [torch.where(keep[j], nx[j], zero) for j in range(k)]
    my = [torch.where(keep[j], ny[j], zero) for j in range(k)]
    mz = [torch.where(keep[j], nz[j], zero) for j in range(k)]
    nw = nv[0]
    for j in range(1, k):
        nw = nw + nv[j]
    n_valid = nw
    nw = torch.clamp(nw, min=1.0)
    cx, cy, cz = mx[0], my[0], mz[0]
    for j in range(1, k):
        cx, cy, cz = cx + mx[j], cy + my[j], cz + mz[j]
    cx, cy, cz = cx / nw, cy / nw, cz / nw

    m00 = m11 = m22 = m01 = m02 = m12 = zero
    qs = []
    for j in range(k):
        qx = torch.where(keep[j], mx[j] - cx, zero)
        qy = torch.where(keep[j], my[j] - cy, zero)
        qz = torch.where(keep[j], mz[j] - cz, zero)
        qs.append((qx, qy, qz))
        m00, m11, m22 = m00 + qx * qx, m11 + qy * qy, m22 + qz * qz
        m01, m02, m12 = m01 + qx * qy, m02 + qx * qz, m12 + qy * qz

    p1 = m01 * m01 + m02 * m02 + m12 * m12
    q = (m00 + m11 + m22) / 3.0
    e0, e1, e2 = m00 - q, m11 - q, m22 - q
    p2 = (e0 * e0 + e1 * e1 + e2 * e2) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.where(p > 0, p, torch.ones_like(p))
    b00, b11, b22 = e0 / ps, e1 / ps, e2 / ps
    c01, c02, c12 = m01 / ps, m02 / ps, m12 / ps
    detB = (b00 * (b11 * b22 - c12 * c12) - c01 * (c01 * b22 - c12 * c02)
            + c02 * (c01 * c12 - b11 * c02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    lmid = 3.0 * q - lmax - lmin
    iso = p2 <= 0
    lmid = torch.where(iso, q, lmid)
    lmin = torch.where(iso, q, lmin)

    a00, a11, a22 = m00 - lmin, m11 - lmin, m22 - lmin
    c01x, c01y, c01z = m01 * m12 - m02 * a11, m02 * m01 - a00 * m12, a00 * a11 - m01 * m01
    c02x, c02y, c02z = m01 * a22 - m02 * m12, m02 * m02 - a00 * a22, a00 * m12 - m01 * m02
    c12x, c12y, c12z = a11 * a22 - m12 * m12, m12 * m02 - m01 * a22, m01 * m12 - a11 * m02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = n02 >= n12
    bx = torch.where(use01, c01x, torch.where(use02, c02x, c12x))
    by = torch.where(use01, c01y, torch.where(use02, c02y, c12y))
    bz = torch.where(use01, c01z, torch.where(use02, c02z, c12z))
    bestn = torch.clamp(torch.maximum(torch.maximum(n01, n02), n12), min=0.0)
    norm = torch.sqrt(bestn)
    okn = norm > 1e-20
    inv = 1.0 / torch.where(okn, norm, torch.ones_like(norm))
    ux, uy, uz = bx * inv, by * inv, bz * inv
    d = -(ux * cx + uy * cy + uz * cz)
    flip = torch.where(d < 0, -1.0, 1.0).to(f32)
    ux, uy, uz, d = ux * flip, uy * flip, uz * flip, d * flip

    res_ok = torch.ones_like(keep[0])
    finite = torch.ones_like(keep[0])
    for j in range(k):
        qx, qy, qz = qs[j]
        res = qx * ux + qy * uy + qz * uz
        res_ok = res_ok & (~keep[j] | (torch.abs(res) <= plane_threshold))
        finite = finite & torch.isfinite(nx[j]) & torch.isfinite(ny[j]) \
            & torch.isfinite(nz[j])
    enough = n_valid >= num_match_points
    close = kth < max_dist_plane
    thr2 = torch.tensor(plane_threshold * plane_threshold, dtype=f32)
    spread_ok = lmid > nw * thr2.to(nw.device)
    finite = finite & torch.isfinite(ux) & torch.isfinite(uy) \
        & torch.isfinite(uz) & torch.isfinite(d)
    good = enough & close & okn & res_ok & spread_ok & finite
    out = torch.stack([ux, uy, uz, d], dim=-1)
    return torch.where(good[..., None], out, torch.zeros_like(out)), good


def _kth(sq_dists, num_match_points):
    N, k = sq_dists.shape
    fmax = torch.finfo(torch.float32).max
    if num_match_points > k:
        return torch.full((N,), fmax, dtype=torch.float32, device=sq_dists.device)
    kth = sq_dists[:, num_match_points - 1]
    return torch.where(torch.isnan(kth), torch.full_like(kth, fmax), kth)


def fit_planes_plain(nbrs, sq_dists, nbr_valid, *, num_match_points: int,
                     max_dist_plane: float, plane_threshold: float):
    k = nbrs.shape[1]
    nv = nbr_valid.to(nbrs.dtype)
    return fit_math([nbrs[:, j, 0] for j in range(k)],
                    [nbrs[:, j, 1] for j in range(k)],
                    [nbrs[:, j, 2] for j in range(k)],
                    [nv[:, j] for j in range(k)],
                    _kth(sq_dists, num_match_points),
                    num_match_points=num_match_points,
                    max_dist_plane=max_dist_plane,
                    plane_threshold=plane_threshold)


def _launch(nbrs, sq_dists, nbr_valid, active, *, num_match_points, max_dist_plane,
            plane_threshold):
    N, k, _ = nbrs.shape
    dispatch.require(nbrs, "nbrs")
    dispatch.require(sq_dists, "sq_dists", shape=(N, k))
    dispatch.require(nbr_valid, "nbr_valid", dtype=torch.bool, shape=(N, k))
    n_abcd = torch.empty((N, 4), dtype=torch.float32, device=nbrs.device)
    good = torch.empty((N,), dtype=torch.bool, device=nbrs.device)
    err = dispatch.library().fl_fit_planes(
        dispatch.ptr(nbrs), dispatch.ptr(sq_dists), dispatch.ptr(nbr_valid), N,
        k, int(num_match_points), float(max_dist_plane), float(plane_threshold),
        float(plane_threshold) * float(plane_threshold), dispatch.flag(active),
        dispatch.ptr(n_abcd), dispatch.ptr(good), dispatch.stream())
    dispatch.check(err, "fit_planes")
    fit_planes.launches += 1
    return n_abcd, good


def fit_planes(nbrs, sq_dists, nbr_valid, *, num_match_points: int,
               max_dist_plane: float, plane_threshold: float, active=None):
    """(N,k,3), (N,k), (N,k) → (n_abcd (N,4), good (N,)); unspecified
    outputs where ``active`` (() bool) is clear on the card."""
    kw = dict(num_match_points=num_match_points,
              max_dist_plane=float(max_dist_plane),
              plane_threshold=float(plane_threshold))
    if not dispatch.on_cuda(nbrs):
        return fit_planes_plain(nbrs, sq_dists, nbr_valid, **kw)
    return _launch(nbrs.contiguous(), sq_dists.contiguous(),
                   nbr_valid.contiguous(), active, **kw)


dispatch.counted(fit_planes)


def merge_fits(fit_w, fit_p, fit_f, idx, stale, viol):
    """The re-match's result from its three fits, ``(n_abcd, good)`` each:
    the window fit (N rows), the patch's fit of the queries ``idx`` (B,)
    (only those that are ``stale`` (N,) are taken) and the full fit (N
    rows); the device count ``viol`` (() int32) picks window (0), patched
    (≤ B) or full."""
    n_w, good_w = fit_w
    n_s, good_s = fit_p
    sel_ok = stale[idx]
    n_m, good_m = n_w.clone(), good_w.clone()
    n_m[idx] = torch.where(sel_ok[:, None], n_s, n_w[idx])
    good_m[idx] = torch.where(sel_ok, good_s, good_w[idx])
    some, few = viol > 0, viol <= idx.shape[0]
    return tuple(torch.where(some, torch.where(few, p, f), w)
                 for w, p, f in zip(fit_w, (n_m, good_m), fit_f))


def fit_planes_select_plain(win, patch, idx, stale, full, viol, *, num_match_points: int,
                            max_dist_plane: float, plane_threshold: float):
    kw = dict(num_match_points=num_match_points, max_dist_plane=max_dist_plane,
              plane_threshold=plane_threshold)
    nbrs_w, sq_w = win
    return merge_fits(fit_planes_plain(nbrs_w, sq_w, torch.isfinite(sq_w), **kw),
                      fit_planes_plain(*patch, **kw), fit_planes_plain(*full, **kw),
                      idx, stale, viol)


def _launch_select(win, patch, idx, stale, full, viol, active, *, num_match_points,
                   max_dist_plane, plane_threshold):
    nbrs_w, sq_w = win
    N, k, _ = nbrs_w.shape
    B = idx.shape[0]
    dispatch.require(nbrs_w, "nbrs_w")
    dispatch.require(sq_w, "sq_w", shape=(N, k))
    for name, (nb, sq, vl), rows in (("patch", patch, B), ("full", full, N)):
        dispatch.require(nb, f"nbrs of {name}", shape=(rows, k, 3))
        dispatch.require(sq, f"sq of {name}", shape=(rows, k))
        dispatch.require(vl, f"valid of {name}", dtype=torch.bool, shape=(rows, k))
    dispatch.require(idx, "idx", dtype=torch.int64, shape=(B,))
    dispatch.require(stale, "stale", dtype=torch.bool, shape=(N,))
    dispatch.require(viol, "viol", dtype=torch.int32, shape=())
    if B > N:
        raise ValueError(f"idx has {B} rows for {N} queries")
    n_abcd = torch.empty((N, 4), dtype=torch.float32, device=nbrs_w.device)
    good = torch.empty((N,), dtype=torch.bool, device=nbrs_w.device)
    err = dispatch.library().fl_fit_planes_select(
        dispatch.ptr(nbrs_w), dispatch.ptr(sq_w), *(dispatch.ptr(t) for t in patch),
        dispatch.ptr(idx), dispatch.ptr(stale), *(dispatch.ptr(t) for t in full),
        dispatch.ptr(viol), N, B, k, int(num_match_points), float(max_dist_plane),
        float(plane_threshold), float(plane_threshold) * float(plane_threshold),
        dispatch.flag(active), dispatch.ptr(n_abcd), dispatch.ptr(good), dispatch.stream())
    dispatch.check(err, "fit_planes_select")
    fit_planes_select.launches += 1
    return n_abcd, good


def fit_planes_select(win, patch, idx, stale, full, viol, *, num_match_points: int,
                      max_dist_plane: float, plane_threshold: float, active=None):
    """The re-match's fit in one launch: ``win`` = (nbrs (N,k,3), sq (N,k);
    valid where sq is finite), ``patch`` = (nbrs (B,k,3), sq, valid) of the
    queries ``idx`` (B,) int64, ``stale`` (N,) bool, ``full`` = (nbrs
    (N,k,3), sq, valid), ``viol`` () int32 → ``(n_abcd (N,4), good (N,))``
    as ``merge_fits`` of the three fits; unspecified outputs where
    ``active`` (() bool) is clear on the card."""
    kw = dict(num_match_points=num_match_points,
              max_dist_plane=float(max_dist_plane),
              plane_threshold=float(plane_threshold))
    if not dispatch.on_cuda(win[0]):
        return fit_planes_select_plain(win, patch, idx, stale, full, viol, **kw)
    c = lambda ts: tuple(t.contiguous() for t in ts)
    return _launch_select(c(win), c(patch), idx.contiguous(), stale.contiguous(), c(full),
                          viol.contiguous(), active, **kw)


dispatch.counted(fit_planes_select)
