"""IMU process model f / df_dx / df_dw (port of fast_limo_tpu/models/process.py;
reference use-ikfom.cpp:43-84).  All functions batch over leading dims."""

from __future__ import annotations

import torch

from reference.lio import state as st
from reference.lio import s2, so3


def _eye3(x):
    return torch.eye(3, dtype=x.dtype, device=x.device)


def f(x: st.NavState, acc, gyro):
    """Flattened dynamics (…,24): d(pos)=vel, d(rot)=ω−bg, d(vel)=R(a−ba)+g."""
    lead = x.pos.shape[:-1]
    out = torch.zeros(lead + (st.FLAT_DIM,), dtype=x.dtype, device=x.device)
    out[..., 0:3] = x.vel
    out[..., 3:6] = gyro - x.bg
    out[..., 12:15] = so3.quat_rotate(x.rot, acc - x.ba) + x.grav
    return out


def df_dx(x: st.NavState, acc, gyro):
    """(…,24,23) Jacobian of f w.r.t. the error state (use-ikfom.cpp:57-73)."""
    lead = x.pos.shape[:-1]
    J = torch.zeros(lead + (st.FLAT_DIM, st.ERR_DIM), dtype=x.dtype,
                    device=x.device)
    R = so3.quat_to_mat(x.rot)
    I3 = _eye3(x)
    J[..., 0:3, st.VEL:st.VEL + 3] = I3
    J[..., 12:15, st.ROT:st.ROT + 3] = -R @ so3.hat(acc - x.ba)
    J[..., 12:15, st.BA:st.BA + 3] = -R
    J[..., 12:15, st.GRAV:st.GRAV + 2] = s2.Mx(
        x.grav, torch.zeros(lead + (2,), dtype=x.dtype, device=x.device))
    J[..., 3:6, st.BG:st.BG + 3] = -I3
    return J


def df_dw(x: st.NavState, acc, gyro):
    """(…,24,12) Jacobian of f w.r.t. noise [ng, na, nbg, nba]."""
    lead = x.pos.shape[:-1]
    J = torch.zeros(lead + (st.FLAT_DIM, st.NOISE_DIM), dtype=x.dtype,
                    device=x.device)
    I3 = _eye3(x)
    J[..., 12:15, 3:6] = -so3.quat_to_mat(x.rot)
    J[..., 3:6, 0:3] = -I3
    J[..., 15:18, 6:9] = I3
    J[..., 18:21, 9:12] = I3
    return J


def process_noise_Q(cov_gyro, cov_acc, cov_bias_gyro, cov_bias_acc,
                    dtype=torch.float32, device=None):
    """12×12 diagonal Q (Localizer.cpp:588-592)."""
    d = torch.tensor([cov_gyro] * 3 + [cov_acc] * 3 + [cov_bias_gyro] * 3
                     + [cov_bias_acc] * 3, dtype=dtype, device=device)
    return torch.diag(d)
