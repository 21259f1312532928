"""K1's plain version (the port's ``ops/deskew_kernel``): per-point deskew into the
scan-end frame through the frame table, in PyTorch."""

from __future__ import annotations


import torch

from reference.lio import so3
from reference.lio.hstats import rot_mat

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


def deskew(points, t_pts, valid, frames, x_last_rot, x_last_pos, q_ext, t_ext):
    """Fused deskew: ``(pts_xt2 (N,3), pts_world (N,3))``.  ``frames``: a
    ``Frames`` of K rows, or a sequence of them (rows in order)."""
    return deskew_plain(points, t_pts, valid, frame_table(stack_frames(frames)),
                        _scalars(q_ext, t_ext, x_last_rot, x_last_pos))


