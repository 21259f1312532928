"""K5 — one fused iterated-EKF update iteration (port of
fast_limo_tpu/ops/update_body.py).

From ``(HᵀH, Hᵀh, P_prop, x, x_prop)`` — the body of
``iekf.update_iterated`` (reference esekfom.hpp:1650-1819):

    dx      = x ⊟ x_prop
    J₁      chart projection: dx_new = J₁·dx ; P_it = J₁·P·J₁ᵀ
    K_x,K_h = gain_math(HᵀH, Hᵀh, P_it[:, :12], 1/R)
    dx_     = K_h + K_x·dx_new[:12] − dx_new            (pre-guard)
    x_next  = x ⊞ guard(dx_)   (spectral-projector degeneracy guard on the
              6-dim pose head, esekfom.hpp:1736-1744 intent)
    P_fin   = J₂·(A·P_it·Aᵀ + R·K·Kᵀ)·J₂ᵀ, A = I − [K_x|0]   (Joseph form)

``update_body`` launches ``csrc/update_body.cu`` on CUDA tensors;
``update_body_plain`` is the same algebra in plain torch (the eigen-
decomposition of the guard by ``torch.linalg.eigh``; the kernel runs a 6×6
Jacobi).  Returns ``(x_next (NavState), P_fin (23,23), dx_ (23,),
gersh_min (), min_eig ())``.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import dispatch, s2, so3
from fast_limo_tpu_torch.ops.gain import gain_math

M = 12
NS = 23
XF = 26


def _block_J(A_rot, A_ext, res2):
    J = torch.eye(NS, dtype=A_rot.dtype, device=A_rot.device)
    J[3:6, 3:6] = A_rot
    J[6:9, 6:9] = A_ext
    J[21:23, 21:23] = res2
    return J


def guard_head(H6, dx6, D):
    """Spectral-projector degeneracy guard (update_body.jacobi_guard_head
    semantics, ascending eigenvalues): ``(guarded dx6, min_eig)``."""
    w, V = torch.linalg.eigh(H6)
    m = (w >= D).to(H6.dtype)
    g = (V * m[None, :]) @ (V.T @ dx6)
    w_prod = w[0] * w[1] * w[2] * w[3] * w[4] * w[5]
    g = torch.where(w_prod < 1e-20, m * dx6, g)
    min_eig = torch.min(w)
    return torch.where(min_eig >= D, dx6, g), min_eig


def iter_core(HTH, HTh, P, dx, x: st.NavState, gp, inv_R, D):
    """One iteration's algebra on plain tensors; ``dx = x ⊟ x_prop``,
    ``gp = x_prop.grav``, ``P`` is P_prop."""
    J1 = _block_J(so3.A_matrix(dx[3:6]).T, so3.A_matrix(dx[6:9]).T,
                  s2.Nx_yy(x.grav) @ s2.Mx(gp, dx[21:23]))
    dx_new = J1 @ dx
    P_it = (J1 @ P) @ J1.T

    K_x, K_h, K = gain_math(HTH, HTh, P_it[:, 0:M], inv_R)
    dx_ = K_h + K_x @ dx_new[0:M] - dx_new

    H6 = HTH[0:6, 0:6]
    diag6 = torch.diagonal(H6)
    gersh = torch.min(diag6 - (torch.sum(torch.abs(H6), dim=1) - torch.abs(diag6)))
    head, min_eig = guard_head(H6, dx_[0:6], D)

    dr, de, dg = dx_[3:6], dx_[6:9], dx_[21:23]
    grav_n = s2.boxplus(x.grav, dg)
    xn = st.NavState(
        pos=x.pos + head[0:3],
        rot=so3.quat_mul(x.rot, so3.exp_quat(head[3:6])),
        rot_LI=so3.quat_mul(x.rot_LI, so3.exp_quat(de)),
        t_LI=x.t_LI + dx_[9:12], vel=x.vel + dx_[12:15],
        bg=x.bg + dx_[15:18], ba=x.ba + dx_[18:21], grav=grav_n)

    A = torch.eye(NS, dtype=P.dtype, device=P.device)
    A[:, 0:M] -= K_x
    M0 = (A @ P_it) @ A.T + (1.0 / inv_R) * (K @ K.T)
    J2 = _block_J(so3.A_matrix(dr).T, so3.A_matrix(de).T,
                  s2.Nx_yy(grav_n) @ s2.Mx(gp, dg))
    Pf = (J2 @ M0) @ J2.T
    return xn, 0.5 * (Pf + Pf.T), dx_, gersh, min_eig


def update_body_plain(HTH, HTh, P, x: st.NavState, x_prop: st.NavState, R, D):
    dx = st.boxminus(x, x_prop)
    inv_R = torch.tensor(1.0 / R, dtype=P.dtype, device=P.device)
    return iter_core(HTH, HTh, P, dx, x, x_prop.grav, inv_R, D)


def _launch(HTH, HTh, P, x: st.NavState, x_prop: st.NavState, R, D):
    dev = P.device
    dispatch.require(HTH, "HTH", shape=(M, M))
    dispatch.require(HTh, "HTh", shape=(M,))
    dispatch.require(P, "P", shape=(NS, NS))
    xv = st.as_vector(x).to(torch.float32).contiguous()
    xpv = st.as_vector(x_prop).to(torch.float32).contiguous()
    xn = torch.empty(XF, dtype=torch.float32, device=dev)
    Pf = torch.empty((NS, NS), dtype=torch.float32, device=dev)
    dxo = torch.empty(NS, dtype=torch.float32, device=dev)
    gm = torch.empty(2, dtype=torch.float32, device=dev)
    err = dispatch.library().fl_update_body(
        dispatch.ptr(HTH), dispatch.ptr(HTh), dispatch.ptr(P), dispatch.ptr(xv),
        dispatch.ptr(xpv), 1.0 / float(R), float(D), dispatch.ptr(xn), dispatch.ptr(Pf),
        dispatch.ptr(dxo), dispatch.ptr(gm), dispatch.stream())
    dispatch.check(err, "update_body")
    update_body.launches += 1
    return st.from_vector(xn), Pf, dxo, gm[0], gm[1]


def update_body(HTH, HTh, P, x: st.NavState, x_prop: st.NavState, R, D):
    if not dispatch.on_cuda(P):
        return update_body_plain(HTH, HTh, P, x, x_prop, R, D)
    return _launch(HTH.contiguous(), HTh.contiguous(), P.contiguous(), x,
                   x_prop, R, D)


update_body.launches = 0
