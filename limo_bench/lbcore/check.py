"""What decides ``correct``: the program's outputs against the plain
reference, dispatch by dispatch.

For each dispatch drawn from the seed (and the run's first, which starts
from the reference's own initial state) the reference runs the same scans
from the program's state before that dispatch.  Compared: each scan's pose,
the state after the dispatch (the navigation state and its covariance, the
carry to the next scan) and what the dispatch's insert stored in the map:
the points the two inserts stored differently, over the points the
reference's insert stored.  The map held before the dispatch is left out
of both sides.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from reference import host
from reference.lio import mapper
from reference.lio import state as st

NAMES = ("pos_gap_m", "rot_gap_rad", "state_gap", "cov_gap", "map_gap")
POINT_TOL = 1e-3      # m: a stored point this far from the reference's is another point


def _voxels(m):
    """The map's filled voxels, sorted by voxel: (keys (V,) int64, counts
    (V,), stored points (V, B, 3) float64)."""
    c, n, p = mapper.voxels(m.table.detach().cpu())
    c = c + 2 ** 20
    key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    order = torch.argsort(key)
    return key[order], n[order], p[order].double()


def _stored(vox, pre):
    """The points a step stored beyond the map ``pre`` held (None: an empty
    map): the voxels that hold some, each with the mask of its new slots
    (the slots past ``pre``'s count of that voxel) and its points."""
    key, n, p = vox
    base = torch.zeros_like(n)
    if pre is not None and len(pre[0]):
        i = torch.searchsorted(pre[0], key).clamp(max=len(pre[0]) - 1)
        base = torch.where(pre[0][i] == key, pre[1][i], base)
    slot = torch.arange(p.shape[1])[None, :]
    new = (slot >= base[:, None]) & (slot < n[:, None])
    keep = new.any(1)
    return key[keep], new[keep], p[keep]


def map_differ(pre, post, ref_post):
    """(points the program's insert and the reference's stored differently,
    points the reference's insert stored): a point counts where the other
    side's new points of that voxel hold none within ``POINT_TOL``."""
    pv = None if pre is None else _voxels(pre.map)
    ka, na, pa = _stored(_voxels(post.map), pv)
    kr, nr, pr = _stored(_voxels(ref_post.map), pv)
    keys = torch.unique(torch.cat([ka, kr]))
    B = max(na.shape[1], nr.shape[1])

    def on_keys(k, n, p):
        mask = torch.zeros((len(keys), B), dtype=torch.bool)
        pts = torch.zeros((len(keys), B, 3), dtype=torch.float64)
        i = torch.searchsorted(keys, k)
        mask[i, :n.shape[1]], pts[i, :p.shape[1]] = n, p
        return mask, pts

    (ma, qa), (mr, qr) = on_keys(ka, na, pa), on_keys(kr, nr, pr)
    near = (qa[:, :, None, :] - qr[:, None, :, :]).abs().amax(-1) < POINT_TOL
    found_a = (near & mr[:, None, :]).any(2)
    found_r = (near & ma[:, :, None]).any(1)
    return int((ma & ~found_a).sum() + (mr & ~found_r).sum()), int(mr.sum())


def gaps(pre, post, outs, ref_post, ref_outs) -> Dict[str, float]:
    """The numbers compared for one dispatch.  ``pre``/``post``: the
    program's states around it (``pre`` None: the initial state); ``outs``:
    its (pos, quat, vel) with a leading scan axis or none; ``ref_*`` the
    reference's."""
    pos, quat = (o.reshape(len(ref_outs), -1).double().cpu() for o in outs[:2])
    g = {"pos_gap_m": 0.0, "rot_gap_rad": 0.0}
    for j, r in enumerate(ref_outs):
        g["pos_gap_m"] = max(g["pos_gap_m"],
                             float(torch.linalg.norm(pos[j] - r.pos.double().cpu())))
        g["rot_gap_rad"] = max(g["rot_gap_rad"], host.quat_angle(quat[j], r.quat.cpu()))
    xa = torch.cat([getattr(post.x, f).reshape(-1).double().cpu() for f in st.NavState._fields])
    xb = st.as_vector(ref_post.x).double().cpu()
    g["state_gap"] = float((xa - xb).abs().max())
    Pb = ref_post.P.double().cpu()
    g["cov_gap"] = float((post.P.double().cpu() - Pb).abs().max() / Pb.abs().max())
    differ, stored = map_differ(pre, post, ref_post)
    g["map_gap"] = differ / max(1, stored)
    return g


def compare(stream, samples, device, step_fn=None) -> Dict[str, float]:
    """The largest of each number over the drawn dispatches: the reference
    (``step_fn``, the frozen plain step by default) from each sample's
    program state, against the program's outputs and states."""
    worst = {k: 0.0 for k in NAMES}
    for s in samples:
        ref_post, ref_outs = host.step(stream, s.scans, s.pre, device, step_fn)
        g = gaps(s.pre, s.post, s.out, ref_post, ref_outs)
        for k in NAMES:
            v = g[k]
            worst[k] = v if v != v else max(worst[k], v)     # NaN stays
        del ref_post, ref_outs
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> (bool, List[str]):
    """``correct`` and one line a number: its value beside its limit."""
    ok, lines = True, []
    for k in NAMES:
        v, lim = numbers[k], float(limits[k])
        good = v == v and v <= lim
        ok &= good
        lines.append(f"{k} {v:.6g} limit {lim:.6g}{'' if good else ' FAILED'}")
    return ok, lines
