"""Rigid-transform helpers (port of fast_limo_tpu/ops/geometry.py;
counterpart of State::get_RT*, Objects/State.cpp:136-172)."""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import so3


def rt_matrix(q, p):
    """4x4 homogeneous transform from quaternion (wxyz) + translation."""
    R = so3.quat_to_mat(q)
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = p
    T[..., 3, 3] = 1.0
    return T


def rt_inverse(q, p):
    """(q,p) of the inverse transform."""
    qi = so3.quat_conj(q)
    return qi, -so3.quat_rotate(qi, p)


def transform_points(q, p, pts):
    """Apply R(q) @ pts + p to a (..., N, 3) point array."""
    R = so3.quat_to_mat(q)
    return pts @ R.transpose(-1, -2) + p[..., None, :]


def compose(q1, p1, q2, p2):
    """(q1,p1) ∘ (q2,p2): first apply 2 then 1."""
    return so3.quat_mul(q1, q2), so3.quat_rotate(q1, p2) + p1
