"""S2 sphere-manifold operations for the gravity state (port of
fast_limo_tpu/ops/s2.py; reference mtk/types/S2.hpp:97-316, S2_typ=1)."""

from __future__ import annotations

import torch

from reference.lio import so3

# S2<double, 98090, 10000, 1> → length = den/num (use-ikfom.hpp:8)
S2_LENGTH = 98090.0 / 10000.0


def _tol(dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1e-11


def project(v, length: float = S2_LENGTH):
    """Normalize a 3-vector onto the sphere of radius ``length``."""
    return v / torch.linalg.norm(v, dim=-1, keepdim=True) * length


def Bx(vec, length: float = S2_LENGTH):
    """Chart basis S2_Bx for S2_typ==1 (S2.hpp:215-231), (…,3,2)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    denom_raw = length + x
    singular = denom_raw <= _tol(vec.dtype)
    denom = torch.where(singular, torch.ones_like(denom_raw), denom_raw)
    r0 = torch.stack([-y, -z], dim=-1)
    r1 = torch.stack([length - y * y / denom, -z * y / denom], dim=-1)
    r2 = torch.stack([-z * y / denom, length - z * z / denom], dim=-1)
    B = torch.stack([r0, r1, r2], dim=-2) / length
    Bs = torch.zeros_like(B)
    Bs[..., 1, 1] = -1.0
    Bs[..., 2, 0] = 1.0
    return torch.where(singular[..., None, None], Bs, B)


def boxplus(vec, delta, length: float = S2_LENGTH):
    """vec' = exp(Bx @ delta) * vec (S2.hpp:136-142)."""
    Bu = (Bx(vec, length) @ delta[..., None])[..., 0]
    R = so3.exp_mat(Bu)
    return (R @ vec[..., None])[..., 0]


def boxminus(vec, other, length: float = S2_LENGTH):
    """2-DOF chart difference vec ⊟ other (S2.hpp:144-167)."""
    v_sin = torch.linalg.norm(so3.cross(vec, other), dim=-1)
    v_cos = torch.sum(vec * other, dim=-1)
    theta = torch.atan2(v_sin, v_cos)
    tol = _tol(vec.dtype)
    hv = so3.cross(other, vec)
    safe_sin = torch.where(v_sin > tol, v_sin, torch.ones_like(v_sin))
    res_big = (theta / safe_sin)[..., None] * (
        Bx(other, length).transpose(-1, -2) @ hv[..., None])[..., 0]
    res_pi = torch.stack([torch.full_like(theta, 3.1415926),
                          torch.zeros_like(theta)], dim=-1)
    res_small = torch.where((torch.abs(theta) > tol)[..., None], res_pi,
                            torch.zeros_like(res_pi))
    return torch.where((v_sin < tol)[..., None], res_small, res_big)


def Nx_yy(vec, length: float = S2_LENGTH):
    """S2_Nx_yy = 1/L² · Bx(vec)ᵀ · hat(vec) (S2.hpp:259-264), (…,2,3)."""
    return Bx(vec, length).transpose(-1, -2) @ so3.hat(vec) / (length * length)


def Mx(vec, delta, length: float = S2_LENGTH):
    """S2_Mx (S2.hpp:266-280), (…,3,2).

    Parity quirk kept: the reference's ``exp_delta`` uses
    ``MTK::exp(…, scalar(1/2))`` — C++ integer division, scale 0 — so it is
    always the identity rotation and is dropped here."""
    B = Bx(vec, length)
    Bu = (B @ delta[..., None])[..., 0]
    small = torch.linalg.norm(delta, dim=-1) < _tol(vec.dtype)
    hv = so3.hat(vec)
    M_small = -(hv @ B)
    M_big = -(hv @ so3.A_matrix(Bu).transpose(-1, -2) @ B)
    return torch.where(small[..., None, None], M_small, M_big)


def oplus(vec, delta3, scale=1.0):
    """Full 3-dim oplus: rotate vec by exp(scale*delta3) (S2.hpp:129-134)."""
    return (so3.exp_mat(delta3 * scale) @ vec[..., None])[..., 0]
