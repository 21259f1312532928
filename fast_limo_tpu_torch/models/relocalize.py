"""Map-based relocalization (port of fast_limo_tpu/models/relocalize.py).

Given a previously saved session (keyframe database + map), localize a new
scan with NO pose prior:

1. place retrieval: ScanContext distance against every stored keyframe
   descriptor (all sector shifts of a block of keyframes at once),
2. coarse pose: the retrieved keyframe's pose ∘ yaw from the best sector
   shift,
3. refinement: coarse-to-fine ICP of the query cloud against the keyframe
   cloud, then a point-to-plane pass.

Returns the world pose + confidence; feed it into a Localizer via
``apply_to_localizer`` to continue odometry inside the old map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fast_limo_tpu_torch.models import icp, scancontext
from fast_limo_tpu_torch.ops import dispatch, so3

_DB_BLOCK = 64     # keyframes per batched distance evaluation


@dataclass
class RelocResult:
    success: bool
    pos: np.ndarray
    quat: np.ndarray
    keyframe_index: int
    sc_dist: float
    icp_rmse: float
    n_inliers: int


def relocalize(query_cloud, query_valid, keyframes: List, *,
               sc_thresh: float = 0.3, icp_max_rmse: float = 1.0,
               icp_min_inliers: int = 150, top_k: int = 3,
               sc_params: Optional[dict] = None, device="cuda") -> RelocResult:
    """Localize a body-frame query scan against a keyframe database.

    ``sc_params`` must match the ScanContext geometry the keyframe
    descriptors were built with (Config.sc; SLAM.relocalize_scan fills it)."""
    device = dispatch.resolve_device(device)
    fail = RelocResult(False, np.zeros(3), np.array([1.0, 0, 0, 0]), -1,
                       np.inf, np.inf, 0)
    if not keyframes:
        return fail

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    q_cloud, q_valid = t(query_cloud), t(query_valid, torch.bool)
    qdesc = scancontext.descriptor(q_cloud, q_valid, **(sc_params or {}))
    descs = t(np.stack([np.asarray(k.desc) for k in keyframes]))
    parts = [scancontext.distance(qdesc, descs[i:i + _DB_BLOCK])
             for i in range(0, len(keyframes), _DB_BLOCK)]
    dists = torch.cat([p[0] for p in parts]).cpu().numpy()
    shifts = torch.cat([p[1] for p in parts]).cpu().numpy()
    order = np.argsort(dists, kind="stable")[:top_k]

    best: Optional[RelocResult] = None
    for ci in order:
        if dists[ci] > sc_thresh:
            break
        kf = keyframes[int(ci)]
        yaw = scancontext.shift_to_yaw(int(shifts[int(ci)]), n_sector=qdesc.shape[1])
        q0 = so3.exp_quat(t([0.0, 0.0, yaw]))
        kf_cloud, kf_valid = t(kf.cloud), t(kf.cloud_valid, torch.bool)
        res = icp.icp(q_cloud, q_valid, kf_cloud, kf_valid,
                      init_quat=q0, max_corr_dist=1.0, iters=20)
        if (float(res.rmse) <= icp_max_rmse
                and int(res.n_inliers) >= icp_min_inliers):
            # point-to-plane refinement: point-to-point Kabsch plateaus at
            # the 1024-point sampling distance, which then persists as a
            # world-frame offset of the whole resumed run.  Accepted only
            # if it stays NEAR the gated coarse pose (one-sided normal
            # fields let it slide along their null directions with high
            # inlier counts), and candidate arbitration keeps the COARSE
            # point-metric rmse so refined and unrefined candidates stay
            # comparable.
            if getattr(kf, "rebuild_cloud", None) is not None:
                dst_c, dst_v = t(kf.rebuild_cloud), t(kf.rebuild_valid, torch.bool)
            else:
                dst_c, dst_v = kf_cloud, kf_valid
            nrm, nok = icp.estimate_normals(dst_c, dst_v)
            ref = icp.icp_point_to_plane(
                q_cloud, q_valid, dst_c, dst_v, nrm, nok,
                init_quat=res.quat, init_trans=res.trans,
                max_corr_dist=1.0, iters=8)
            dt_ref = float(torch.linalg.norm(ref.trans - res.trans))
            dr_ref = float(torch.linalg.norm(so3.log_quat(so3.quat_mul(
                so3.quat_conj(ref.quat), res.quat))))
            pose = res
            if (int(ref.n_inliers) >= icp_min_inliers
                    and dt_ref <= 1.0 and dr_ref <= 0.2):
                pose = ref
            # world pose: T_world←query = T_world←kf ∘ T_kf←query(ICP)
            kq = t(kf.quat)
            qw = so3.quat_mul(kq, pose.quat)
            pw = so3.quat_rotate(kq, pose.trans) + t(kf.pos)
            cand = RelocResult(True, pw.cpu().numpy(), qw.cpu().numpy(), int(ci),
                               float(dists[ci]), float(res.rmse),
                               int(res.n_inliers))
            if best is None or cand.icp_rmse < best.icp_rmse:
                best = cand
    return best if best is not None else fail


def relocalize_pair(cloud_a, valid_a, cloud_b, valid_b, dt: float,
                    keyframes: List, **kw):
    """Relocalize two consecutive scans and derive the world velocity.

    Resuming mid-motion with zero velocity makes the filter re-converge
    through a multi-meter transient; two relocalized poses ``dt`` apart give
    v ≈ Δp/dt. Returns (result_b, velocity (3,)) — result_b.success requires
    BOTH scans to localize consistently (|Δp| plausible for dt).
    """
    ra = relocalize(cloud_a, valid_a, keyframes, **kw)
    rb = relocalize(cloud_b, valid_b, keyframes, **kw)
    if not (ra.success and rb.success):
        return RelocResult(False, np.zeros(3), np.array([1.0, 0, 0, 0]), -1,
                           np.inf, np.inf, 0), np.zeros(3)
    vel = (rb.pos - ra.pos) / max(dt, 1e-6)
    if np.linalg.norm(vel) > 50.0:     # inconsistent pair
        return RelocResult(False, rb.pos, rb.quat, rb.keyframe_index,
                           rb.sc_dist, rb.icp_rmse, rb.n_inliers), np.zeros(3)
    return rb, vel


def apply_to_localizer(localizer, result: RelocResult, velocity=None) -> None:
    """Teleport the filter to the relocalized pose (keeps biases/extrinsics)."""
    if not result.success:
        raise ValueError("cannot apply failed relocalization")
    s = localizer.state
    x = s.x

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=x.pos.dtype, device=x.pos.device)

    vel = torch.zeros_like(x.vel) if velocity is None else t(velocity)
    localizer.state = s._replace(x=x._replace(pos=t(result.pos), rot=t(result.quat), vel=vel))
