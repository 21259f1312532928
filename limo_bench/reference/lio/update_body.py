"""K5's plain version (the port's ``ops/update_body``): one iteration of the
iterated EKF update, in PyTorch."""

from __future__ import annotations

import torch

from reference.lio import state as st
from reference.lio import s2, so3
from reference.lio.gain import gain_math

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


def update_body(HTH, HTh, P, x: st.NavState, x_prop: st.NavState, R, D, active=None):
    """One iteration body (see the module docstring); unspecified outputs
    where ``active`` (() bool) is clear on the card."""
    return update_body_plain(HTH, HTh, P, x, x_prop, R, D)


