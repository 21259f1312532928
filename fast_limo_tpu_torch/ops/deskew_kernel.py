"""K1 — fused deskew (port of fast_limo_tpu/ops/deskew_kernel.py).

``deskew`` launches the Hopper kernel ``csrc/deskew.cu`` on CUDA tensors
and runs ``deskew_plain`` (the same function in plain PyTorch) on CPU
tensors.  Contract of models/deskew.deskew: ``(pts_xt2 (N,3),
pts_world (N,3))``, invalid points zeroed.

The frames come as one ``Frames`` of K stacked rows, or as a sequence of
them whose rows follow each other (the scan step passes its carry-in row
and its propagated IMU window).  On the card the kernel reads those
tensors as they are (each field with its row stride, 0 where a field is
broadcast over the rows) and builds the frame table itself — per frame
``[T, pos3, rot4, vel3, a0_world3, w_eff3]`` with ``T`` the running max of
the valid frame times (+inf from an invalid frame on), so a regressed IMU
stamp becomes an empty interval — and the two constant rotations: one
launch, nothing concatenated or uploaded.  The plain path builds the same
table with ``frame_table`` and the constants with ``_scalars``.
"""

from __future__ import annotations

import ctypes

import torch

from fast_limo_tpu_torch.ops import dispatch, so3
from fast_limo_tpu_torch.ops.hstats import rot_mat

FW = 17
KMAX = 512   # frames the kernel takes (its table in shared memory)
_FIELDS = ("time", "pos", "rot", "vel", "bg", "ba", "grav", "w", "a")
_WIDTH = (1, 3, 4, 3, 3, 3, 3, 3, 3)


def stack_frames(frames):
    """One ``Frames`` of stacked rows from ``frames`` (itself, or the
    concatenation of a sequence of them)."""
    if hasattr(frames, "time"):
        return frames
    return type(frames[0])(*[torch.cat(f, dim=0) for f in zip(*frames)])


def frame_table(frames):
    """(K,17) f32 frame table from a deskew.Frames."""
    T = torch.where(frames.valid, frames.time,
                    torch.full_like(frames.time, float("inf")))
    T = torch.cummax(T, dim=0).values
    w_eff = frames.w - frames.bg
    a0w = so3.quat_rotate(frames.rot, frames.a - frames.ba) + frames.grav
    return torch.cat([T[:, None], frames.pos, frames.rot, frames.vel, a0w,
                      w_eff], dim=1).to(torch.float32).contiguous()


def _scalars(q_ext, t_ext, x_last_rot, x_last_pos):
    return torch.cat([q_ext, t_ext, so3.quat_conj(x_last_rot),
                      x_last_pos]).to(torch.float32).contiguous()


def deskew_plain(points, t_pts, valid, F, sc):
    """The kernel's arithmetic in plain torch (same formulas, same order)."""
    T = F[:, 0].contiguous()
    idx = torch.clamp(torch.searchsorted(T, t_pts.contiguous(), right=True) - 1,
                      min=0)
    f = F[idx]                                           # (N,17)
    dt = t_pts - f[:, 0]
    gx, gy, gz = f[:, 14] * dt, f[:, 15] * dt, f[:, 16] * dt
    c, sinc = so3._cos_sinc_sqrt(0.25 * (gx * gx + gy * gy + gz * gz))
    sw, sx, sy, sz = c, 0.5 * sinc * gx, 0.5 * sinc * gy, 0.5 * sinc * gz
    qw, qx, qy, qz = f[:, 4], f[:, 5], f[:, 6], f[:, 7]
    rw = qw * sw - qx * sx - qy * sy - qz * sz
    rx = qw * sx + qx * sw + qy * sz - qz * sy
    ry = qw * sy - qx * sz + qy * sw + qz * sx
    rz = qw * sz + qx * sy - qy * sx + qz * sw
    h2 = 0.5 * dt * dt
    pix = f[:, 1] + f[:, 8] * dt + f[:, 11] * h2
    piy = f[:, 2] + f[:, 9] * dt + f[:, 12] * h2
    piz = f[:, 3] + f[:, 10] * dt + f[:, 13] * h2

    E = rot_mat(*sc[0:4])
    I = rot_mat(*sc[7:11])
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    bx = E[0] * px + E[1] * py + E[2] * pz + sc[4]
    by = E[3] * px + E[4] * py + E[5] * pz + sc[5]
    bz = E[6] * px + E[7] * py + E[8] * pz + sc[6]
    cx1, cy1, cz1 = ry * bz - rz * by, rz * bx - rx * bz, rx * by - ry * bx
    cx2, cy2, cz2 = ry * cz1 - rz * cy1, rz * cx1 - rx * cz1, rx * cy1 - ry * cx1
    wxp = bx + 2.0 * (rw * cx1 + cx2) + pix
    wyp = by + 2.0 * (rw * cy1 + cy2) + piy
    wzp = bz + 2.0 * (rw * cz1 + cz2) + piz
    dx0, dy0, dz0 = wxp - sc[11], wyp - sc[12], wzp - sc[13]
    x2 = I[0] * dx0 + I[1] * dy0 + I[2] * dz0
    y2 = I[3] * dx0 + I[4] * dy0 + I[5] * dz0
    z2 = I[6] * dx0 + I[7] * dy0 + I[8] * dz0
    keep = valid[:, None]
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    return (torch.where(keep, torch.stack([x2, y2, z2], 1), zero),
            torch.where(keep, torch.stack([wxp, wyp, wzp], 1), zero))


class _Src(ctypes.Structure):     # FlFrameSrc of csrc/deskew.cu
    _fields_ = [("f", ctypes.c_void_p * 9), ("stride", ctypes.c_int * 9),
                ("valid", ctypes.c_void_p), ("vstride", ctypes.c_int), ("rows", ctypes.c_int)]


class _Args(ctypes.Structure):    # FlDeskewArgs of csrc/deskew.cu
    _fields_ = [("src", _Src * 2), ("nsrc", ctypes.c_int), ("pts", ctypes.c_void_p),
                ("t", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("N", ctypes.c_int),
                ("q_ext", ctypes.c_void_p), ("t_ext", ctypes.c_void_p),
                ("xl_rot", ctypes.c_void_p), ("xl_pos", ctypes.c_void_p),
                ("out_xt2", ctypes.c_void_p), ("out_w", ctypes.c_void_p)]


def _source(src, out):
    """Fill one FlFrameSrc from a Frames-like row source (its fields in
    the order of ``_FIELDS``, then ``valid``); returns its row count.  Each
    field must be a CUDA tensor of float32 (``valid``: bool) rows whose
    values are contiguous; a row stride of 0 (a broadcast field) is read
    as one row for all."""
    *fs, v = src
    rows = v.shape[0]
    for t, name, w in zip(fs, _FIELDS, _WIDTH):
        shape = (rows,) if w == 1 else (rows, w)
        if not t.is_cuda or t.dtype != torch.float32 or t.shape != shape or (
                w > 1 and t.stride(1) != 1):
            raise ValueError(f"frame field {name} must be a CUDA float32 tensor of shape {shape} "
                             f"with contiguous rows, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not v.is_cuda or v.dtype != torch.bool or v.shape != (rows,):
        raise ValueError(f"frame field valid must be a CUDA bool tensor of shape ({rows},)")
    out.f[:] = [t.data_ptr() for t in fs]
    out.stride[:] = [t.stride(0) for t in fs]
    out.valid, out.vstride, out.rows = v.data_ptr(), v.stride(0), rows
    return rows


def _launch(points, t_pts, valid, srcs, x_last_rot, x_last_pos, q_ext, t_ext):
    N = points.shape[0]
    dispatch.require(points, "points", shape=(N, 3))
    dispatch.require(t_pts, "t_pts", shape=(N,))
    dispatch.require(valid, "valid", dtype=torch.bool, shape=(N,))
    for t, name, n in ((x_last_rot, "x_last_rot", 4), (x_last_pos, "x_last_pos", 3),
                       (q_ext, "q_ext", 4), (t_ext, "t_ext", 3)):
        dispatch.require(t, name, shape=(n,))
    if not 1 <= len(srcs) <= 2:
        raise ValueError(f"the deskew kernel takes one or two frame sources, got {len(srcs)}")
    a = _Args()
    K = sum(_source(src, out) for src, out in zip(srcs, a.src))
    if not 1 <= K <= KMAX:
        raise ValueError(f"the deskew kernel takes 1 to {KMAX} frames, got {K}")
    xt2 = torch.empty((N, 3), dtype=torch.float32, device=points.device)
    wld = torch.empty((N, 3), dtype=torch.float32, device=points.device)
    a.nsrc, a.N = len(srcs), N
    a.pts, a.t, a.valid = points.data_ptr(), t_pts.data_ptr(), valid.data_ptr()
    a.q_ext, a.t_ext = q_ext.data_ptr(), t_ext.data_ptr()
    a.xl_rot, a.xl_pos = x_last_rot.data_ptr(), x_last_pos.data_ptr()
    a.out_xt2, a.out_w = xt2.data_ptr(), wld.data_ptr()
    err = dispatch.library().fl_deskew(ctypes.byref(a), dispatch.stream())
    dispatch.check(err, "deskew")
    deskew.launches += 1
    return xt2, wld


def deskew(points, t_pts, valid, frames, x_last_rot, x_last_pos, q_ext, t_ext):
    """Fused deskew: ``(pts_xt2 (N,3), pts_world (N,3))``.  ``frames``: a
    ``Frames`` of K rows, or a sequence of them (rows in order)."""
    if not dispatch.on_cuda(points):
        return deskew_plain(points, t_pts, valid, frame_table(stack_frames(frames)),
                            _scalars(q_ext, t_ext, x_last_rot, x_last_pos))
    srcs = (frames,) if hasattr(frames, "time") else tuple(frames)
    return _launch(points.contiguous(), t_pts.contiguous(), valid.contiguous(), srcs,
                   x_last_rot.contiguous(), x_last_pos.contiguous(), q_ext.contiguous(),
                   t_ext.contiguous())


dispatch.counted(deskew)
