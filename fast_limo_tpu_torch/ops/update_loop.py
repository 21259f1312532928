"""K6 — the whole iterated update in one launch, window mode (port of
fast_limo_tpu/ops/update_loop.py).

All ``MAX_NUM_ITERS+1`` masked iterations of ``iekf.update_iterated``,
each running the EXACT window re-match over every query's frozen top-W
candidate window (true distances at the iterate, exact k-of-W selection
with ties to the lowest slot, a fresh plane fit, the two-pass dynamic
gate, the point-order MAX_NUM_MATCHES cap), the staleness certificates of
``measurement._stale_mask`` (cert_a: no outside-window candidate can enter
the top-k; cert_b: block crossings keep coverage; the ``cnt < W`` clause),
the statistics and the iteration body.

``update_loop`` launches ``csrc/update_loop.cu`` (one thread-block
cluster; the scalars 1/R, limit and D by value, so a launch uploads
nothing and needs no host sync) on CUDA tensors;
``update_loop_plain`` runs the same iterations in plain torch.  Both
compute the chart difference with atan2, so — unlike the TPU kernel's
atan series — ``ok`` certifies the staleness certificates alone: when it
is False the caller re-runs the exact per-iteration loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import dispatch
from fast_limo_tpu_torch.ops.hstats import glob_math, h_rows, stats_from_rows
from fast_limo_tpu_torch.ops.plane_kernel import fit_math
from fast_limo_tpu_torch.ops.update_body import NS, XF, iter_core
from fast_limo_tpu_torch.ops.voxel import floor_div

_BIG = 3.0e38


class Window(NamedTuple):
    """Window re-match parameters."""

    k: int
    W: int
    voxel_size: float
    max_dist_plane: float
    plane_threshold: float
    max_num_matches: int
    dynamic_gate: float


def pack_window(pc, pc_valid, nbrs_w, vld_w, cnt_w):
    """Flat ((5+3W)·Np,) channel stack [px py pz pc_valid cnt | wx0 wy0 wz0 |
    wx1 …], Np = 128·⌈N/128⌉ (the JAX ((5+3W)·Nr, 128) layout, flattened).
    Invalid window slots are zeroed."""
    N, W, _ = nbrs_w.shape
    Np = N + (-N) % 128
    f32 = torch.float32
    safe = torch.where(vld_w[..., None], nbrs_w, torch.zeros_like(nbrs_w))
    X = torch.zeros((5 + 3 * W, Np), dtype=f32, device=pc.device)
    X[0:3, :N] = pc.T.to(f32)
    X[3, :N] = pc_valid.to(f32)
    X[4, :N] = cnt_w.to(f32)
    X[5:, :N] = safe.permute(1, 2, 0).reshape(3 * W, N).to(f32)
    return X.reshape(-1)


def _window_match(chans, glob, it: int, frozen, win: Window):
    """One iteration's exact window re-match (the kernel's per-point phase):
    ((ux, uy, uz, d), keep, badq, frozen', the k-th squared distance)."""
    px, py, pz, pvld, cnt, wx, wy, wz = chans
    k, W = win.k, win.W
    gx, gy, gz = glob
    big = torch.full_like(gx, _BIG)
    d2 = []
    for j in range(W):
        dx, dy, dz = gx - wx[j], gy - wy[j], gz - wz[j]
        d2.append(torch.where(cnt > j + 0.5, dx * dx + dy * dy + dz * dz, big))
    if it == 0:
        dmax = d2[0]
        for j in range(1, W):
            dmax = torch.maximum(dmax, d2[j])
        b0 = [torch.floor((floor_div(g, win.voxel_size) - 1.0) * 0.5)
              for g in glob]
        lo = [(2.0 * b + 1.0) * win.voxel_size for b in b0]
        frozen = (glob, b0, lo, torch.sqrt(dmax))

    taken = [torch.zeros_like(gx, dtype=torch.bool) for _ in range(W)]
    sxs, sys_, szs, svs = [], [], [], []
    kth = big
    for _ in range(k):
        m = big
        for j in range(W):
            m = torch.minimum(m, torch.where(taken[j], big, d2[j]))
        found = torch.zeros_like(taken[0])
        sx, sy, sz = torch.zeros_like(gx), torch.zeros_like(gx), torch.zeros_like(gx)
        for j in range(W):
            pj = ~taken[j] & (d2[j] == m) & ~found & (m < _BIG)
            taken[j] = taken[j] | pj
            found = found | pj
            sx = torch.where(pj, wx[j], sx)
            sy = torch.where(pj, wy[j], sy)
            sz = torch.where(pj, wz[j], sz)
        sxs.append(sx)
        sys_.append(sy)
        szs.append(sz)
        svs.append(found.to(gx.dtype))
        kth = m

    n_abcd, good = fit_math(sxs, sys_, szs, svs, kth, num_match_points=k,
                            max_dist_plane=win.max_dist_plane,
                            plane_threshold=win.plane_threshold)
    ux, uy, uz, dpl = n_abcd.unbind(-1)
    good = good & (pvld > 0)

    if win.dynamic_gate > 0:
        ad = torch.abs(ux * gx + uy * gy + uz * gz + dpl)
        gf = good.to(gx.dtype)
        m1 = torch.sum(ad * gf) / torch.clamp(torch.sum(gf), min=1.0)
        trim = torch.where(ad <= 3.0 * m1 + 0.05, gf, torch.zeros_like(gf))
        m2v = torch.sum(ad * trim) / torch.clamp(torch.sum(trim), min=1.0)
        tau = torch.clamp(win.dynamic_gate * m2v, min=0.05)
        good = good & (ad <= tau)

    cum = torch.cumsum(good.to(torch.int32), dim=0)
    keep = good & (cum <= win.max_num_matches)

    badq = torch.zeros_like(good) if it == 0 else \
        _certificates(glob, kth, cnt, pvld, frozen, win)[0]
    return (ux, uy, uz, dpl), keep, badq, frozen, kth


def _certificates(glob, kth, cnt, pvld, frozen, win: Window):
    """The staleness certificates at an iterate: (stale (N,) bool, margin_a,
    margin_b, kth_d), the margins ``d_wmax − delta − kth_d`` and ``h −
    max(leave, 0) − kth_d`` by which cert_a and cert_b hold (> 0) or fail,
    and the k-th distance they are compared with."""
    gx, gy, gz = glob
    (g0x, g0y, g0z), b0, lo, d_wmax = frozen
    ddx, ddy, ddz = gx - g0x, gy - g0y, gz - g0z
    delta = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
    kth_d = torch.sqrt(kth)
    cert_a = (cnt < win.W - 0.5) | (kth_d < d_wmax - delta)
    b0same = torch.ones_like(pvld > 0)
    leave = torch.zeros_like(gx)
    for g, b, l0 in zip(glob, b0, lo):
        b0same = b0same & (torch.floor((floor_div(g, win.voxel_size) - 1.0) * 0.5) == b)
        leave = torch.maximum(leave, torch.maximum(l0 - g, g - (l0 + 2.0 * win.voxel_size)))
    cert_b = kth_d < win.voxel_size - torch.clamp(leave, min=0.0)
    stale = (pvld > 0) & ~(cert_a & (b0same | cert_b))
    return (stale, (d_wmax - delta) - kth_d,
            (win.voxel_size - torch.clamp(leave, min=0.0)) - kth_d, kth_d)


def window_stale(X, x_prop: st.NavState, x: st.NavState, *, window: Window):
    """The plain version's per-query certificate failures at the iterate
    ``x`` (the window frozen at ``x_prop``, as in ``update_loop_plain``):
    (stale (N,) bool, margin_a, margin_b, kth_d) — see ``_certificates``.
    Held against K6's stale count at K6's own iterates by the card tests."""
    W = window.W
    Np = X.shape[0] // (5 + 3 * W)
    ch = [X[i * Np:(i + 1) * Np] for i in range(5 + 3 * W)]
    chans = (*ch[0:5], ch[5::3], ch[6::3], ch[7::3])

    def glob_at(y):
        return glob_math(ch[0], ch[1], ch[2], torch.cat([y.rot, y.pos, y.rot_LI, y.t_LI]))

    frozen = _window_match(chans, glob_at(x_prop), 0, None, window)[3]
    glob = glob_at(x)
    kth = _window_match(chans, glob, 1, frozen, window)[4]
    return _certificates(glob, kth, ch[4], ch[3], frozen, window)


def update_loop_plain(X, P, x_prop: st.NavState, R, D, limit, *, max_iters: int,
                      estimate_extrinsics: bool, window: Window):
    """The kernel's iterations in plain torch.  Like the kernel it reads
    nothing on the host: all ``max_iters + 1`` iterations run, those after
    the stop rule fired are masked out (``torch.where``), as the kernel's
    loop would not have run them."""
    W = window.W
    Np = X.shape[0] // (5 + 3 * W)
    ch = [X[i * Np:(i + 1) * Np] for i in range(5 + 3 * W)]
    chans = (*ch[0:5], ch[5::3], ch[6::3], ch[7::3])
    px, py, pz = ch[0], ch[1], ch[2]
    f32, dev = X.dtype, X.device
    inv_R = torch.tensor(1.0 / R, dtype=f32, device=dev)
    x = x_prop
    dx = torch.zeros(NS, dtype=f32, device=dev)
    P_out = P
    zero = torch.zeros((), dtype=f32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    t, nit, bad_total = zero, zero, zero
    gersh_min = min_eig = torch.full((), float("inf"), dtype=f32, device=dev)
    frozen = None
    for it in range(max_iters + 1):
        run = ~done
        s = torch.cat([x.rot, x.pos, x.rot_LI, x.t_LI])
        glob = glob_math(px, py, pz, s)
        (ux, uy, uz, dpl), keep, badq, frozen, _ = _window_match(
            chans, glob, it, frozen, window)
        nbad = torch.where(run, torch.sum(badq).to(f32), zero)
        ok = ok & (nbad == 0.0)
        bad_total = bad_total + nbad
        cols, hneg = h_rows((px, py, pz, ux, uy, uz, dpl, keep.to(px.dtype)), s,
                            estimate_extrinsics=estimate_extrinsics, glob=glob)
        HTH, HTh = stats_from_rows(cols, hneg)
        xn, Pf, dx_, gersh, me = iter_core(HTH, HTh, P, dx, x, x_prop.grav,
                                           inv_R, D)
        t = torch.where(run, t + (torch.max(torch.abs(dx_)) <= limit).to(f32), t)
        done_now = run & ((t > 1.0) | (it == max_iters))
        x = st.where(run, xn, x)
        dx = torch.where(run, st.boxminus(xn, x_prop), dx)
        nit = torch.where(run, zero + (it + 1), nit)
        gersh_min = torch.where(run, torch.fmin(gersh_min, gersh), gersh_min)   # fminf
        min_eig = torch.where(run, torch.fmin(min_eig, me), min_eig)
        P_out = torch.where(done_now, Pf, P_out)
        done = done | done_now
    aux = torch.stack([nit, ok.to(f32), gersh_min, min_eig, bad_total, zero, zero, zero])
    return x, P_out, aux


def _launch(X, P, x_prop: st.NavState, R, D, limit, *, max_iters: int,
            estimate_extrinsics: bool, window: Window):
    W = window.W
    Np = X.shape[0] // (5 + 3 * W)
    dev = X.device
    dispatch.require(X, "X", shape=((5 + 3 * W) * Np,))
    dispatch.require(P, "P", shape=(NS, NS))
    lib = dispatch.library()
    xv = st.as_vector(x_prop).to(torch.float32).contiguous()
    scr = torch.empty(lib.fl_update_loop_scratch(Np), dtype=torch.float32, device=dev)
    out = torch.empty(XF + NS * NS + 8, dtype=torch.float32, device=dev)
    xo, Po, aux = out[:XF], out[XF:XF + NS * NS].view(NS, NS), out[XF + NS * NS:]
    thr = float(window.plane_threshold)
    err = lib.fl_update_loop(
        dispatch.ptr(X), Np, dispatch.ptr(P), dispatch.ptr(xv), 1.0 / float(R), float(limit),
        float(D), int(window.k), W, float(window.voxel_size), float(window.max_dist_plane),
        thr, thr * thr, int(window.max_num_matches), float(window.dynamic_gate),
        int(max_iters), int(bool(estimate_extrinsics)), dispatch.ptr(scr),
        dispatch.ptr(xo), dispatch.ptr(Po), dispatch.ptr(aux), dispatch.stream())
    dispatch.check(err, "update_loop")
    update_loop.launches += 1
    return st.from_vector(xo), Po, aux


def update_loop(X, P, x_prop: st.NavState, R, D, limit, *, max_iters: int,
                estimate_extrinsics: bool, window: Window, with_aux: bool = False):
    """Returns ``(x_next, P_fin, n_iters, ok, gersh_min, min_eig)`` as
    tensors (no host sync); ``with_aux`` adds the raw aux row
    ``[n_iters, ok, gersh_min, min_eig, stale_total, 0, 0, 0]``."""
    kw = dict(max_iters=max_iters, estimate_extrinsics=estimate_extrinsics,
              window=window)
    if not dispatch.on_cuda(X):
        x, Pf, aux = update_loop_plain(X, P, x_prop, R, D, limit, **kw)
    else:
        x, Pf, aux = _launch(X.contiguous(), P.contiguous(), x_prop, R, D,
                             limit, **kw)
    out = (x, Pf, aux[0].to(torch.int32), aux[1] > 0, aux[2], aux[3])
    return out + (aux,) if with_aux else out


dispatch.counted(update_loop)
