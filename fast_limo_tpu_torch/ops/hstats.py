"""K4 — measurement sufficient statistics HᵀH (12×12), Hᵀh (12,) (port of
fast_limo_tpu/ops/hstats.py).

Per point: ``glob = R·p + t``, ``dist = n·glob + d``, ``C = Rᵀn``,
``A = p × C``, ``B = (R_LIᵀ(p − t_LI)) × (R_LIᵀC)``, row ``[n | A | B | C]``
keep-masked, ``h = −dist`` (reference Localizer.cpp:537-577).  Inputs are
the x-independent channel pack ``pack_inputs`` (8 planes
[px py pz nx ny nz nd keep] of Np = 128·⌈N/128⌉ floats — the JAX layout)
and the 14 pose scalars ``pack_scalars(x)``.

``hstats`` launches ``csrc/hstats.cu`` (one thread-block cluster, one
kernel, one (156,) output whose views it returns) on CUDA tensors,
``hstats_plain`` runs on CPU tensors.  An optional active flag (a () bool
device tensor) lets the exact update loop launch the kernel on every scan:
a clear flag makes every block return at once, and the caller discards the
output.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import dispatch

M = 12


def rot_mat(w, a, b, c):
    """3×3 rotation entries (scalars or tensors) of quaternion (w,a,b,c)."""
    return (1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b),
            2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a),
            2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b))


def glob_math(px, py, pz, s):
    """World-frame coordinates ``R·p + t`` from the 14 pose scalars."""
    R = rot_mat(s[0], s[1], s[2], s[3])
    return (R[0] * px + R[1] * py + R[2] * pz + s[4],
            R[3] * px + R[4] * py + R[5] * pz + s[5],
            R[6] * px + R[7] * py + R[8] * pz + s[6])


def h_rows(chans, s, *, estimate_extrinsics: bool, glob=None):
    """(cols (12 tensors, keep-masked), hneg) of the per-point rows."""
    px, py, pz, nx, ny, nz, nd, keep = chans
    R = rot_mat(s[0], s[1], s[2], s[3])
    E = rot_mat(s[7], s[8], s[9], s[10])
    gx, gy, gz = glob if glob is not None else glob_math(px, py, pz, s)
    dist = nx * gx + ny * gy + nz * gz + nd
    cx = R[0] * nx + R[3] * ny + R[6] * nz
    cy = R[1] * nx + R[4] * ny + R[7] * nz
    cz = R[2] * nx + R[5] * ny + R[8] * nz
    ax, ay, az = py * cz - pz * cy, pz * cx - px * cz, px * cy - py * cx
    if estimate_extrinsics:
        ux, uy, uz = px - s[11], py - s[12], pz - s[13]
        plx = E[0] * ux + E[3] * uy + E[6] * uz
        ply = E[1] * ux + E[4] * uy + E[7] * uz
        plz = E[2] * ux + E[5] * uy + E[8] * uz
        clx = E[0] * cx + E[3] * cy + E[6] * cz
        cly = E[1] * cx + E[4] * cy + E[7] * cz
        clz = E[2] * cx + E[5] * cy + E[8] * cz
        cols = [nx, ny, nz, ax, ay, az, ply * clz - plz * cly,
                plz * clx - plx * clz, plx * cly - ply * clx, cx, cy, cz]
        cols = [c * keep for c in cols]
    else:
        z = torch.zeros_like(px)
        cols = [c * keep for c in (nx, ny, nz, ax, ay, az)] + [z] * 6
    return cols, -dist * keep


def stats_from_rows(cols, hneg):
    """(HᵀH (12,12), Hᵀh (12,)) from per-point row columns."""
    H = torch.stack(cols, dim=-1)            # (Np, 12)
    return H.T @ H, H.T @ hneg


def hstats_plain(X, sc, *, estimate_extrinsics: bool):
    Np = X.shape[0] // 8
    chans = tuple(X[i * Np:(i + 1) * Np] for i in range(8))
    cols, hneg = h_rows(chans, sc, estimate_extrinsics=estimate_extrinsics)
    return stats_from_rows(cols, hneg)


def pack_inputs(pc, n_abcd, keep):
    """(8·Np,) channel pack [px py pz nx ny nz nd keep], zero-padded to a
    multiple of 128 points (the JAX (8·Nr, 128) layout, flattened)."""
    N = pc.shape[0]
    pad = (-N) % 128
    f32 = torch.float32
    chans = [pc[:, 0], pc[:, 1], pc[:, 2], n_abcd[:, 0], n_abcd[:, 1],
             n_abcd[:, 2], n_abcd[:, 3], keep.to(f32)]
    X = torch.zeros((8, N + pad), dtype=f32, device=pc.device)
    X[:, :N] = torch.stack([c.to(f32) for c in chans])
    return X.reshape(-1)


def pack_scalars(x: st.NavState):
    """14 pose scalars [rot(wxyz), pos, rot_LI(wxyz), t_LI]."""
    return torch.cat([x.rot, x.pos, x.rot_LI, x.t_LI]).to(torch.float32)


def _launch(X, sc, active, *, estimate_extrinsics: bool):
    Np = X.shape[0] // 8
    dispatch.require(X, "X", shape=(8 * Np,))
    dispatch.require(sc, "scalars", shape=(14,))
    out = torch.empty(M * M + M, dtype=torch.float32, device=X.device)
    err = dispatch.library().fl_hstats(dispatch.ptr(X), Np, dispatch.ptr(sc),
                                       int(bool(estimate_extrinsics)), dispatch.flag(active),
                                       dispatch.ptr(out), dispatch.stream())
    dispatch.check(err, "hstats")
    hstats.launches += 1
    return out[:M * M].view(M, M), out[M * M:]


def hstats(X, sc, *, estimate_extrinsics: bool, active=None):
    """Statistics from ``pack_inputs`` channels and ``pack_scalars`` →
    (HᵀH (12,12), Hᵀh (12,)); unspecified where ``active`` (() bool) is
    clear on the card."""
    if not dispatch.on_cuda(X):
        return hstats_plain(X, sc, estimate_extrinsics=estimate_extrinsics)
    return _launch(X.contiguous(), sc.contiguous(), active,
                   estimate_extrinsics=estimate_extrinsics)


dispatch.counted(hstats)
