"""The 23-DOF navigation state manifold (port of fast_limo_tpu/models/state.py).

``pos(3) ⊕ rot(SO3) ⊕ offset_R_L_I(SO3) ⊕ offset_T_L_I(3) ⊕ vel(3) ⊕ bg(3) ⊕
ba(3) ⊕ grav(S2)`` — 26 flat values, 23 error-state DOF, with the error and
flattened-dynamics index maps of the JAX package (mtk/build_manifold.hpp).
Fields may carry leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.lio import s2, so3

ERR_DIM = 23      # error-state dimension (n)
FLAT_DIM = 24     # flattened dynamics dimension (m)
NOISE_DIM = 12    # process noise dimension (ng, na, nbg, nba)
XF = 26           # flat value count of as_vector

POS, ROT, EXT_R, EXT_T, VEL, BG, BA, GRAV = 0, 3, 6, 9, 12, 15, 18, 21
SO3_IDXS = (ROT, EXT_R)
S2_IDX = GRAV


class NavState(NamedTuple):
    """Navigation state. Quaternions are (w,x,y,z)."""

    pos: torch.Tensor      # (3,)
    rot: torch.Tensor      # (4,) world←baselink
    rot_LI: torch.Tensor   # (4,) baselink←lidar (offset_R_L_I)
    t_LI: torch.Tensor     # (3,) baselink←lidar translation
    vel: torch.Tensor      # (3,)
    bg: torch.Tensor       # (3,)
    ba: torch.Tensor       # (3,)
    grav: torch.Tensor     # (3,) |grav| == s2.S2_LENGTH

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def device(self):
        return self.pos.device


def identity(dtype=torch.float32, gravity: float = 9.81, device=None) -> NavState:
    z3 = lambda: torch.zeros(3, dtype=dtype, device=device)  # noqa: E731
    return NavState(
        pos=z3(), rot=so3.quat_identity(dtype, device),
        rot_LI=so3.quat_identity(dtype, device), t_LI=z3(), vel=z3(),
        bg=z3(), ba=z3(),
        grav=s2.project(torch.tensor([0.0, 0.0, -gravity], dtype=dtype,
                                     device=device)))


def boxplus(x: NavState, dx) -> NavState:
    """x ⊞ dx with dx a 23-vector (MTK compound boxplus)."""
    return NavState(
        pos=x.pos + dx[..., POS:POS + 3],
        rot=so3.boxplus(x.rot, dx[..., ROT:ROT + 3]),
        rot_LI=so3.boxplus(x.rot_LI, dx[..., EXT_R:EXT_R + 3]),
        t_LI=x.t_LI + dx[..., EXT_T:EXT_T + 3],
        vel=x.vel + dx[..., VEL:VEL + 3],
        bg=x.bg + dx[..., BG:BG + 3],
        ba=x.ba + dx[..., BA:BA + 3],
        grav=s2.boxplus(x.grav, dx[..., GRAV:GRAV + 2]),
    )


def boxminus(x: NavState, x0: NavState):
    """23-vector chart difference x ⊟ x0."""
    return torch.cat([
        x.pos - x0.pos,
        so3.boxminus(x.rot, x0.rot),
        so3.boxminus(x.rot_LI, x0.rot_LI),
        x.t_LI - x0.t_LI,
        x.vel - x0.vel,
        x.bg - x0.bg,
        x.ba - x0.ba,
        s2.boxminus(x.grav, x0.grav),
    ], dim=-1)


def oplus_flat(x: NavState, f, dt) -> NavState:
    """x.oplus(f, dt) with f the 24-dim flattened dynamics (esekfom.hpp:287)."""
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)[..., None]
    return NavState(
        pos=x.pos + f[..., 0:3] * dt,
        rot=so3.boxplus(x.rot, f[..., 3:6] * dt),
        rot_LI=so3.boxplus(x.rot_LI, f[..., 6:9] * dt),
        t_LI=x.t_LI + f[..., 9:12] * dt,
        vel=x.vel + f[..., 12:15] * dt,
        bg=x.bg + f[..., 15:18] * dt,
        ba=x.ba + f[..., 18:21] * dt,
        grav=s2.oplus(x.grav, f[..., 21:24] * dt),
    )


def as_vector(x: NavState):
    """pos(3) rot(4) rotLI(4) tLI(3) vel(3) bg(3) ba(3) grav(3) — the
    order of the kernels' flat state (ops/update_body.XF)."""
    return torch.cat([x.pos, x.rot, x.rot_LI, x.t_LI, x.vel, x.bg, x.ba,
                      x.grav], dim=-1)


def from_vector(v, cls=NavState) -> NavState:
    return cls(pos=v[..., 0:3], rot=v[..., 3:7], rot_LI=v[..., 7:11],
               t_LI=v[..., 11:14], vel=v[..., 14:17], bg=v[..., 17:20],
               ba=v[..., 20:23], grav=v[..., 23:26])


def where(cond, a: NavState, b: NavState) -> NavState:
    """Field-wise select (the port's ``tree_map(jnp.where)``)."""
    return NavState(*[torch.where(cond, x, y) for x, y in zip(a, b)])
