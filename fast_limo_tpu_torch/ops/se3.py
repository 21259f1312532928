"""SE(3) exp/log for pose-graph optimization (twists as [ρ(3), φ(3)]);
port of fast_limo_tpu/ops/se3.py."""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import so3


def _V(phi):
    """Left Jacobian of SO(3): V(φ) = I + (1−cosθ)/θ² φ̂ + (θ−sinθ)/θ³ φ̂²."""
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(th2)
    small = th < 1e-5
    one = torch.ones_like(th2)
    safe2 = torch.where(small, one, th2)
    K = so3.hat(phi)
    K2 = K @ K
    c1 = torch.where(small, 0.5 * one, (1 - torch.cos(th)) / safe2)
    c2 = torch.where(small, one / 6.0, (th - torch.sin(th)) / (safe2 * torch.sqrt(safe2)))
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return I + c1[..., None, None] * K + c2[..., None, None] * K2


def _V_inv(phi):
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(th2)
    small = th < 1e-5
    one = torch.ones_like(th2)
    safe = torch.where(small, one, th)
    K = so3.hat(phi)
    K2 = K @ K
    half = torch.where(
        small, one / 12.0,
        (1.0 - th * torch.cos(safe / 2) / (2.0 * torch.sin(safe / 2))) / torch.where(small, one, th2))
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return I - 0.5 * K + half[..., None, None] * K2


def exp(xi):
    """(…,6) twist → (quat (…,4), trans (…,3))."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    q = so3.exp_quat(phi)
    t = torch.einsum("...ij,...j->...i", _V(phi), rho)
    return q, t


def log(q, t):
    """(quat, trans) → (…,6) twist."""
    phi = so3.log_quat(q)
    rho = torch.einsum("...ij,...j->...i", _V_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def compose(q1, t1, q2, t2):
    return so3.quat_mul(q1, q2), so3.quat_rotate(q1, t2) + t1


def inverse(q, t):
    qi = so3.quat_conj(q)
    return qi, -so3.quat_rotate(qi, t)
