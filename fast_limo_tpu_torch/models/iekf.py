"""Iterated error-state Kalman filter on the 23-DOF manifold (port of
fast_limo_tpu/models/iekf.py; reference esekfom.hpp:279-384 predict and
1620-1823 update_iterated_dyn_share_modified).

Parity quirks kept from the reference: ``scalar_type(1/2)`` is C++ integer
division (the predict's SO3/S2 "res" rotations are identity); the
degeneracy guard is the spectral projector (see the JAX docstring for the
documented divergence from the reference's sign-dependent row quirk);
convergence is tested on the pre-guard update.

``update_iterated`` runs the whole-loop kernel K6 when the measurement
model exposes a window pack, then the exact per-iteration loop (the K2/K3
re-match, the K4 statistics and the K5 body) on fixed shapes with
``need = ~ok`` as its kernels' active flag, and selects K6's result or the
loop's with ``torch.where`` — the value ``lax.cond(ok, …)`` gives in the
JAX package, with no host read: where K6's certificates hold, the loop's
kernels return at their first instruction and its glue is discarded.

``split_body=True`` is the JAX package's program with its fused body off
(there an environment lever, here an argument): every scan runs the
per-iteration loop with ``_body_jnp`` as its body — chart projection in
plain torch, the gain through ``gain.gain`` (K8 on CUDA tensors), then the
eigh guard, boxplus and Joseph covariance in plain torch — and neither K5
nor K6 launches.  It is an independent per-scan witness of the fused
kernels; its guard costs one host read per evaluation and a 6×6
``torch.linalg.eigh`` where the Gershgorin bound does not certify.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.models import process
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import s2, so3

N = st.ERR_DIM  # 23
M_OBS = 12


class SyncCounter:
    """Host reads of device values on the scan path (each one a sync: only
    the split body's guard makes them), and the scans whose whole-loop
    kernel failed a certificate."""

    def __init__(self):
        self.host_syncs = 0
        self.guard_eighs = 0      # split body: 6×6 eigh calls of the guard
        self._fallbacks = {}      # device → () int32 count, added to on the device

    def read(self, t) -> float:
        self.host_syncs += 1
        return float(t)

    def add_fallbacks(self, need) -> None:
        """Count ``need`` (() bool) on its device, without a host read."""
        n = self._fallbacks.get(need.device)
        self._fallbacks[need.device] = need.to(torch.int32) if n is None else n + need

    @property
    def loop_fallbacks(self) -> int:
        """The count so far, read from the device when a caller asks (a
        host sync; never in the step).  Assigning 0 resets it."""
        return sum(int(n) for n in self._fallbacks.values())

    @loop_fallbacks.setter
    def loop_fallbacks(self, value: int) -> None:
        if value != 0:
            raise ValueError("loop_fallbacks can only be reset to 0")
        self._fallbacks = {}


counters = SyncCounter()


def init_P(dtype=torch.float32, device=None):
    """Initial covariance (Localizer.cpp:685-693)."""
    d = torch.ones(N, dtype=dtype, device=device)
    d[6:9] = 1e-6
    d[9:12] = 1e-6
    d[15:18] = 1e-5
    d[18:21] = 1e-4
    d[21:23] = 1e-6
    return torch.diag(d)


# ---------------------------------------------------------------- predict

def _predict_mats(x: st.NavState, acc, gyro, dt, Q):
    """Batched (x_new, F (…,23,23), Gw·Q·Gwᵀ (…,23,23)) of one step."""
    lead = x.pos.shape[:-1]
    f_ = process.f(x, acc, gyro)
    fx = process.df_dx(x, acc, gyro)
    fw = process.df_dw(x, acc, gyro)
    x_new = st.oplus_flat(x, f_, dt)
    dt_ = dt[..., None, None]

    f_x_final = torch.zeros(lead + (N, N), dtype=x.dtype, device=x.device)
    f_w_final = torch.zeros(lead + (N, st.NOISE_DIM), dtype=x.dtype, device=x.device)
    f_x_final[..., 0:21, :] = fx[..., 0:21, :]
    f_w_final[..., 0:21, :] = fw[..., 0:21, :]
    F_x1 = torch.eye(N, dtype=x.dtype, device=x.device).expand(lead + (N, N)).clone()
    for idx in st.SO3_IDXS:
        A = so3.A_matrix(-f_[..., idx:idx + 3] * dt[..., None])
        f_x_final[..., idx:idx + 3, :] = A @ fx[..., idx:idx + 3, :]
        f_w_final[..., idx:idx + 3, :] = A @ fw[..., idx:idx + 3, :]
    g = st.GRAV
    seg = f_[..., g:g + 3] * dt[..., None]
    Nx = s2.Nx_yy(x_new.grav)
    Mx = s2.Mx(x.grav, torch.zeros(lead + (2,), dtype=x.dtype, device=x.device))
    F_x1[..., g:g + 2, g:g + 2] = Nx @ Mx
    res2 = -Nx @ so3.hat(x.grav) @ so3.A_matrix(seg).transpose(-1, -2)
    f_x_final[..., g:g + 2, :] = res2 @ fx[..., g:g + 3, :]
    f_w_final[..., g:g + 2, :] = res2 @ fw[..., g:g + 3, :]

    F = F_x1 + f_x_final * dt_
    Gw = dt_ * f_w_final
    return x_new, F, Gw @ Q @ Gw.transpose(-1, -2)


def predict_scan(x: st.NavState, P, imu_stack, Q):
    """Prediction over a padded IMU window with a validity mask → final
    (x, P) plus the stacked propagated states (deskew frames).

    The mean chain is the JAX package's preintegration (orientation prefix
    product, velocity/position cumsums) with the quaternion product taken
    sequentially; all K Jacobians are one batch; the covariance folds the
    K affine maps P ↦ F·P·Fᵀ + GQG in time order.  Algebraically identical
    to the JAX associative scan (f32 rounding differs in association)."""
    valid = imu_stack["valid"]
    K = valid.shape[0]
    dt_m = torch.where(valid, imu_stack["dt"], torch.zeros_like(imu_stack["dt"])).to(x.dtype)
    omega = (imu_stack["gyro"] - x.bg[None]) * dt_m[:, None]
    steps = so3.exp_quat(omega)
    qs = [x.rot]
    for i in range(K):
        qs.append(so3.quat_mul(qs[-1], steps[i]))
    q_incl = torch.stack(qs)                                      # (K+1,4)
    a_world = so3.quat_rotate(q_incl[:-1], imu_stack["acc"] - x.ba[None]) + x.grav[None]
    v_after = x.vel[None] + torch.cumsum(a_world * dt_m[:, None], dim=0)
    v_before = torch.cat([x.vel[None], v_after[:-1]], dim=0)
    p_after = x.pos[None] + torch.cumsum(v_before * dt_m[:, None], dim=0)

    def const(a):
        return a[None].expand((K,) + a.shape)

    xs = st.NavState(pos=p_after, rot=q_incl[1:], rot_LI=const(x.rot_LI),
                     t_LI=const(x.t_LI), vel=v_after, bg=const(x.bg),
                     ba=const(x.ba), grav=const(x.grav))
    x_f = st.NavState(*[a[-1] for a in xs])

    x_prev = st.NavState(*[torch.cat([a[None], b[:-1]], dim=0) for a, b in zip(x, xs)])
    _, F_k, GQG_k = _predict_mats(x_prev, imu_stack["acc"], imu_stack["gyro"],
                                  imu_stack["dt"].to(x.dtype), Q)
    eye = torch.eye(N, dtype=x.dtype, device=x.device)
    vm = valid[:, None, None]
    F_k = torch.where(vm, F_k, eye)
    GQG_k = torch.where(vm, GQG_k, torch.zeros_like(GQG_k))
    for i in range(K):
        P = F_k[i] @ P @ F_k[i].T + GQG_k[i]
    return x_f, 0.5 * (P + P.T), xs


# ----------------------------------------------------------- update helpers

def _chart_project_P(dx, x: st.NavState, x_prop: st.NavState, P, dx_new):
    """Project dx_new and P through the manifold charts (esekfom.hpp:1657-1697)."""
    dx_new = dx_new.clone()
    P = P.clone()
    for idx in st.SO3_IDXS:
        res = so3.A_matrix(dx[idx:idx + 3]).T
        dx_new[idx:idx + 3] = res @ dx_new[idx:idx + 3]
        P[idx:idx + 3, :] = res @ P[idx:idx + 3, :]
        P[:, idx:idx + 3] = P[:, idx:idx + 3] @ res.T
    g = st.GRAV
    res2 = s2.Nx_yy(x.grav) @ s2.Mx(x_prop.grav, dx[g:g + 2])
    dx_new[g:g + 2] = res2 @ dx_new[g:g + 2]
    P[g:g + 2, :] = res2 @ P[g:g + 2, :]
    P[:, g:g + 2] = P[:, g:g + 2] @ res2.T
    return dx_new, P


def _gersh_min(HTH):
    """Minimum Gershgorin lower bound on the eigenvalues of HᵀH[:6, :6]."""
    H6 = HTH[0:6, 0:6]
    hd = torch.diagonal(H6)
    return torch.min(hd - (torch.sum(torch.abs(H6), dim=1) - torch.abs(hd)))


def _degeneracy_guard(HTH, dx_, D):
    """Zero degenerate pose-update directions (esekfom.hpp:1736-1744 intent,
    spectral projector).  Returns (guarded dx (23,), min_eig ())."""
    H6 = HTH[0:6, 0:6]
    if counters.read(_gersh_min(HTH)) >= D:
        return dx_, torch.tensor(float("inf"), dtype=dx_.dtype, device=dx_.device)
    counters.guard_eighs += 1
    w, V = torch.linalg.eigh(H6)
    m = (w >= D).to(dx_.dtype)
    dx6 = dx_[0:6]
    proj = (V * m[None, :]) @ V.T @ dx6
    head = torch.where(torch.prod(w) < 1e-20, m * dx6, proj)
    out = dx_.clone()
    out[0:6] = head
    return out, torch.min(w)


def _final_P(x: st.NavState, x_prop: st.NavState, dx_, P, K_x, K, R):
    """Terminal covariance in Joseph form, then chart projection."""
    A = torch.eye(N, dtype=P.dtype, device=P.device)
    A[:, 0:M_OBS] -= K_x
    M0 = A @ P @ A.T + R * (K @ K.T)
    for idx in st.SO3_IDXS:
        res = so3.A_matrix(dx_[idx:idx + 3]).T
        M0[idx:idx + 3, :] = res @ M0[idx:idx + 3, :]
        M0[:, idx:idx + 3] = M0[:, idx:idx + 3] @ res.T
    g = st.GRAV
    res2 = s2.Nx_yy(x.grav) @ s2.Mx(x_prop.grav, dx_[g:g + 2])
    M0[g:g + 2, :] = res2 @ M0[g:g + 2, :]
    M0[:, g:g + 2] = M0[:, g:g + 2] @ res2.T
    return 0.5 * (M0 + M0.T)


def _body_jnp(x: st.NavState, x_prop: st.NavState, P_prop, HTH, HTh, R, D):
    """One update-iteration body in plain torch around the gain
    (``gain.gain``: K8 on CUDA tensors, its plain version on CPU tensors),
    with the eigh guard — the counterpart of the JAX package's
    ``_body_jnp``.  Returns (x_next, P_fin, dx_, min_eig)."""
    from fast_limo_tpu_torch.ops import gain as gain_op

    dx = st.boxminus(x, x_prop)
    dx_new, P_it = _chart_project_P(dx, x, x_prop, P_prop, dx)
    K_x12, K_h, K = gain_op.gain(HTH, HTh, P_it, R)
    K_x = torch.zeros((N, N), dtype=P_prop.dtype, device=P_prop.device)
    K_x[:, 0:M_OBS] = K_x12
    dx_ = K_h + (K_x - torch.eye(N, dtype=K_x.dtype, device=K_x.device)) @ dx_new
    dx_guarded, min_eig = _degeneracy_guard(HTH, dx_, D)
    x_next = st.boxplus(x, dx_guarded)
    P_fin = _final_P(x_next, x_prop, dx_, P_it, K_x12, K, R)
    return x_next, P_fin, dx_, min_eig


# ----------------------------------------------------------------- update

def update_iterated(x: st.NavState, P, h_model, R: float, D: float,
                    max_iters: int, limit: float, split_body: bool = False,
                    with_diag: bool = False):
    """Iterated dynamic-share update (esekfom.hpp:1620-1823): ``update_core``
    with K6's fallback flag counted in ``counters``.  Returns (x', P',
    n_iters), with ``with_diag`` also the diagnostics (see ``update_core``)."""
    x_u, P_u, n_it, need, diag = update_core(x, P, h_model, R, D, max_iters, limit,
                                             split_body, with_diag)
    if need is not None:
        counters.add_fallbacks(need)
    return (x_u, P_u, n_it, diag) if with_diag else (x_u, P_u, n_it)


def update_core(x: st.NavState, P, h_model, R: float, D: float,
                max_iters: int, limit: float, split_body: bool = False,
                with_diag: bool = False):
    """The iterated update of ``update_iterated`` without counting K6's
    fallbacks: on the fused body a function of tensors, which a CUDA graph
    can capture (the split body's guard reads the device).

    ``h_model.stats(x, active) -> (HᵀH, Hᵀh)`` re-matches at the iterate.
    With a window pack (``h_model.loop_pack``) the whole loop is ONE K6
    launch; the exact per-iteration loop (K2/K3 re-match + K4 statistics +
    K5 body per iteration) then runs on the same fixed shapes with
    ``need = ~ok`` as its kernels' active flag, and each result field is
    ``torch.where(ok, K6's, the loop's)``: nothing is read on the host.
    With ``split_body`` the per-iteration loop runs for every scan with
    ``_body_jnp`` (K8) as its body and K5/K6 never launch.  Returns (x',
    P', n_iters, need, diag): ``need`` is K6's fallback flag (() bool; None
    without a window pack), ``diag`` None unless ``with_diag``, then
    ``{"gersh_min", "min_eig", "guard_fired", "loop_fallback"}``: the
    minimum Gershgorin bound on HᵀH's pose block and its exact minimum
    eigenvalue over the iterations (+inf where the split body's bound
    certified it ≥ D), whether the degeneracy guard zeroed directions, and
    whether K6's certificates failed (``need`` itself).
    """
    from fast_limo_tpu_torch.ops import update_body, update_loop

    def diag(g, me, fb):
        return {"gersh_min": g, "min_eig": me, "guard_fired": me < D, "loop_fallback": fb}

    x_prop, P_prop = x, P
    dev = P.device
    loop_pack = None if split_body else getattr(h_model, "loop_pack", None)
    need = None
    if loop_pack is not None:
        xk, Pk, nit_k, ok, g_k, me_k = update_loop.update_loop(
            loop_pack, P_prop, x_prop, R, D, limit, max_iters=max_iters,
            estimate_extrinsics=h_model.estimate_extrinsics,
            window=h_model.loop_window)
        need = ~ok

    # exact per-iteration loop: i = −1 … max_iters−1 (max_iters+1 bodies),
    # finished iterations are masked exactly like the JAX unrolled loop
    xc, Pc = x, P
    t = torch.zeros((), dtype=torch.int32, device=dev)
    i = torch.full((), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    inf = torch.full((), float("inf"), dtype=P.dtype, device=dev)
    g_min, me_min = inf, inf
    for _ in range(max_iters + 1):
        HTH, HTh = h_model.stats(xc) if need is None else h_model.stats(xc, active=need)
        if split_body:
            x_next, P_fin, dx_, me = _body_jnp(xc, x_prop, P_prop, HTH, HTh, R, D)
            gm = _gersh_min(HTH) if with_diag else None
        else:
            x_next, P_fin, dx_, gm, me = update_body.update_body(
                HTH, HTh, P_prop, xc, x_prop, R, D, active=need)
        t_next = t + torch.all(torch.abs(dx_) <= limit).to(torch.int32)
        done_now = (t_next > 1) | (i == max_iters - 1)
        keep = done
        xc = st.where(keep, xc, x_next)
        Pc = torch.where(keep | ~done_now, Pc, P_fin)
        t = torch.where(keep, t, t_next)
        i = torch.where(keep, i, i + 1)
        if with_diag:
            g_min = torch.where(keep, g_min, torch.minimum(g_min, gm))
            me_min = torch.where(keep, me_min, torch.minimum(me_min, me))
        done = done | done_now
    n_it = i + 1
    if need is None:
        out = (xc, Pc, n_it)
        fb = torch.zeros((), dtype=torch.bool, device=dev)
    else:   # lax.cond(ok, K6, loop), field by field
        out = (st.where(ok, xk, xc), torch.where(ok, Pk, Pc), torch.where(ok, nit_k, n_it))
        if with_diag:
            g_min, me_min = torch.where(ok, g_k, g_min), torch.where(ok, me_k, me_min)
        fb = need
    return (*out, need, diag(g_min, me_min, fb) if with_diag else None)
