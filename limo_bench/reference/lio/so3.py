"""SO(3) quaternion/rotation primitives (port of fast_limo_tpu/ops/so3.py).

Quaternions are ``(w, x, y, z)`` tensors of shape (…,4).  Semantics mirror
the MTK manifold toolkit of the reference, branch-free (``torch.where``)
so every function batches over leading dimensions.
"""

from __future__ import annotations

import torch


def _tol(dtype) -> float:
    # mirrors MTK::tolerance (mtkmath.hpp:121-122)
    return 1e-5 if dtype == torch.float32 else 1e-11


def cross(a, b):
    """Cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(v):
    """Skew-symmetric matrix of a 3-vector, (…,3) → (…,3,3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q, p):
    """Hamilton product q*p, both (…,4) wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    ], dim=-1)


# quat_conj's sign vector, uploaded once per (dtype, device): an upload from
# a host list on every call would block the host
_CONJ = {}


def quat_conj(q):
    key = (q.dtype, q.device)
    sign = _CONJ.get(key)
    if sign is None:
        sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
        _CONJ[key] = sign
    return q * sign


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by quaternion(s) q (R(q) @ v)."""
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + q[..., :1] * t + cross(qv, t)


def quat_to_mat(q):
    """Rotation matrix from quaternion, (…,4) → (…,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def mat_to_quat(R):
    """Quaternion (wxyz) from rotation matrix — branch-free Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(a):
        return torch.sqrt(torch.clamp(a, min=0.0)) / 2

    qw0 = sq(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0 + 1e-30),
                      (m02 - m20) / (4 * qw0 + 1e-30),
                      (m10 - m01) / (4 * qw0 + 1e-30)], dim=-1)
    qx1 = sq(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1 + 1e-30), qx1,
                      (m01 + m10) / (4 * qx1 + 1e-30),
                      (m02 + m20) / (4 * qx1 + 1e-30)], dim=-1)
    qy2 = sq(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2 + 1e-30),
                      (m01 + m10) / (4 * qy2 + 1e-30), qy2,
                      (m12 + m21) / (4 * qy2 + 1e-30)], dim=-1)
    qz3 = sq(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3 + 1e-30),
                      (m02 + m20) / (4 * qz3 + 1e-30),
                      (m12 + m21) / (4 * qz3 + 1e-30), qz3], dim=-1)
    c0 = (tr > 0.0)[..., None]
    c1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    c2 = (m11 >= m22)[..., None]
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    return quat_normalize(q)


def _cos_sinc_sqrt(x2):
    """(cos(sqrt(x2)), sinc(sqrt(x2))) with a Taylor branch near zero
    (MTK::cos_sinc_sqrt, mtkmath.hpp:143-174), branch-free."""
    eps = torch.finfo(x2.dtype).eps
    taylor_bound = eps ** 0.25
    x2s = torch.clamp(x2, min=0.0)
    x = torch.sqrt(x2s)
    use_big = x2s >= taylor_bound
    safe_x = torch.where(use_big, x, torch.ones_like(x))
    cos_big = torch.cos(safe_x)
    sinc_big = torch.sin(safe_x) / safe_x
    inv = [1 / 3.0, 1 / 4.0, 1 / 5.0, 1 / 6.0, 1 / 7.0, 1 / 8.0]
    cosi = torch.ones_like(x2s)
    sinc = torch.ones_like(x2s)
    term = -0.5 * x2s
    for i in range(3):
        cosi = cosi + term
        term = term * inv[2 * i]
        sinc = sinc + term
        term = term * (-inv[2 * i + 1]) * x2s
    return torch.where(use_big, cos_big, cosi), torch.where(use_big, sinc_big, sinc)


def exp_quat(v, scale=0.5):
    """MTK::exp — quaternion of rotation by ``2*scale*|v|`` about v."""
    norm2 = torch.sum(v * v, dim=-1)
    c, sinc = _cos_sinc_sqrt(scale * scale * norm2)
    return torch.cat([c[..., None], (sinc * scale)[..., None] * v], dim=-1)


def log_quat(q):
    """Rotation vector of a quaternion (inverse of exp_quat, |out| ≤ π)."""
    w = q[..., 0]
    vec = q[..., 1:]
    n = torch.linalg.norm(vec, dim=-1)
    angle = 2.0 * torch.atan2(n, torch.abs(w))
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    small = n <= _tol(q.dtype)
    safe_w = torch.where(torch.abs(w) > 1e-30, w, torch.ones_like(w))
    out_small = 2.0 * vec / safe_w[..., None]
    out_big = (sgn * angle / torch.clamp(n, min=1e-30))[..., None] * vec
    return torch.where(small[..., None], out_small, out_big)


def exp_mat(v):
    """Rotation matrix exp via Rodrigues."""
    return quat_to_mat(exp_quat(v))


def A_matrix(v):
    """MTK::A_matrix (mtkmath.hpp:236-247); identity for tiny |v|."""
    n2 = torch.sum(v * v, dim=-1)
    n = torch.sqrt(n2)
    tol = _tol(v.dtype)
    one = torch.ones_like(n2)
    safe_n2 = torch.where(n2 > tol * tol, n2, one)
    K = hat(v)
    K2 = K @ K
    c1 = torch.where(n >= tol, (1.0 - torch.cos(n)) / safe_n2, 0.5 * one)
    c2 = torch.where(
        n >= tol, (1.0 - torch.sin(n) / torch.where(n > 0, n, one)) / safe_n2,
        one / 6.0)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    out = eye + c1[..., None, None] * K + c2[..., None, None] * K2
    return torch.where((n < tol)[..., None, None], eye, out)


def boxplus(q, delta, scale=1.0):
    """SO3 boxplus: q * exp(scale*delta)."""
    return quat_mul(q, exp_quat(delta * scale))


def boxminus(q, p):
    """SO3 boxminus: log(p⁻¹ * q)."""
    return log_quat(quat_mul(quat_conj(p), q))
