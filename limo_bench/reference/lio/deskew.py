"""Motion-compensated scan deskewing (port of fast_limo_tpu/models/deskew.py;
reference Localizer.cpp:733-853, Objects/State.cpp:76-119).

Per point: the latest propagated frame at-or-before its time, integrated
forward to the point time, LiDAR → baselink → world → Xt2.  The whole
chain, the frame table included, is the K1 kernel (ops/deskew_kernel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.lio import state as st
from reference.lio import deskew_kernel


class Frames(NamedTuple):
    """Stacked propagated states (the propagated_buffer slice of a scan)."""

    time: torch.Tensor   # (K,)
    pos: torch.Tensor    # (K,3)
    rot: torch.Tensor    # (K,4)
    vel: torch.Tensor    # (K,3)
    bg: torch.Tensor     # (K,3)
    ba: torch.Tensor     # (K,3)
    grav: torch.Tensor   # (K,3)
    w: torch.Tensor      # (K,3) bias-corrected gyro input at that tick
    a: torch.Tensor      # (K,3) bias-corrected accel input
    valid: torch.Tensor  # (K,)


def deskew(points, t_pts, valid, frames, x_last: st.NavState, q_ext, t_ext):
    """Deskew a scan → (pts_xt2 (N,3), pts_world (N,3)); ``frames`` is a
    ``Frames`` or the row sources of ``frames_from_scan``; ``(q_ext,
    t_ext)`` are the ESTIMATED baselink←lidar extrinsics (Localizer.cpp:356)."""
    return deskew_kernel.deskew(points, t_pts, valid, frames, x_last.rot,
                                x_last.pos, q_ext, t_ext)


# the carry-in row's validity flag, built once per device
_ONE = {}


def frames_from_scan(x0: st.NavState, t0, w0, a0, xs: st.NavState, imu):
    """Carry-in state + per-IMU propagated states (Localizer.cpp:900-912),
    as two row sources: ``(carry-in Frames of one row, window Frames)``.
    Every field is a view of the step's tensors (nothing is copied); the
    K1 kernel reads both, ``deskew_kernel.stack_frames`` joins them."""
    dev = imu["valid"].device
    one = _ONE.get(dev)
    if one is None:
        one = _ONE[dev] = torch.ones(1, dtype=torch.bool, device=dev)
    head = Frames(
        time=torch.as_tensor(t0, dtype=imu["stamp"].dtype, device=imu["stamp"].device)[None],
        pos=x0.pos[None], rot=x0.rot[None], vel=x0.vel[None], bg=x0.bg[None],
        ba=x0.ba[None], grav=x0.grav[None], w=w0[None], a=a0[None], valid=one)
    tail = Frames(time=imu["stamp"], pos=xs.pos, rot=xs.rot, vel=xs.vel, bg=xs.bg, ba=xs.ba,
                  grav=xs.grav, w=imu["gyro"], a=imu["acc"], valid=imu["valid"])
    return head, tail
