"""Full SLAM: odometry + keyframes + ScanContext loop closure + pose graph
(port of fast_limo_tpu/models/slam.py).

* keyframes capture each scan's OWN device-side outputs (pose + body-frame
  cloud), lagged one scan behind dispatch so reads never sync the step in
  flight; the ScanContext descriptor is computed on demand at keyframe
  ACCEPTANCE (sparse — it is deliberately NOT a per-scan pipeline output);
  the host keeps the keyframe database (poses, descriptors, ring keys,
  subsampled ICP clouds + denser rebuild clouds),
* loop candidates: ring-key L1 retrieval → full shifted-correlation
  distance → ICP verification seeded with the ScanContext yaw,
* verified loops become edges of the Gauss-Newton pose graph; the
  correction is pushed back into the device filter state and the
  voxel-hash map is REBUILT from keyframe clouds at the optimized poses
  (the map is a pure function of the keyframe set — no incremental surgery
  needed).

The small pose algebra of the host decisions (keyframe gates, odometry
edges, the correction at the newest keyframe) runs in numpy on the host:
on the card each would be a few tiny launches and a read.  The clouds'
work (descriptor, ICP, normals, graph solve, map rebuild) runs on the
engine's device.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fast_limo_tpu_torch.models import icp, mapper, posegraph, scancontext
from fast_limo_tpu_torch.models import relocalize as rl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.ops import dispatch, so3
from fast_limo_tpu_torch.utils.config import Config

_CONJ = np.array([1.0, -1.0, -1.0, -1.0])


def _quat_mul(q, p):
    """Hamilton product of (…,4) wxyz numpy quaternions."""
    qw, qx, qy, qz = np.moveaxis(np.asarray(q, np.float64), -1, 0)
    pw, px, py, pz = np.moveaxis(np.asarray(p, np.float64), -1, 0)
    return np.stack([qw * pw - qx * px - qy * py - qz * pz,
                     qw * px + qx * pw + qy * pz - qz * py,
                     qw * py - qx * pz + qy * pw + qz * px,
                     qw * pz + qx * py - qy * px + qz * pw], axis=-1)


def _quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    t = 2.0 * np.cross(q[..., 1:], v)
    return v + q[..., :1] * t + np.cross(q[..., 1:], t)


def _rot_angle(q):
    """Rotation angle |log(q)| of a unit quaternion, in [0, π]."""
    q = np.asarray(q, np.float64)
    return 2.0 * np.arctan2(np.linalg.norm(q[1:]), abs(q[0]))


@dataclass
class LoopConfig:
    kf_dist: float = 2.0            # m between keyframes
    kf_angle: float = 0.35          # rad between keyframes
    exclude_recent: int = 30        # don't match the latest K keyframes
    search_radius: float = 10.0     # only revisit candidates within this range
    sc_dist_thresh: float = 0.22    # ScanContext acceptance
    icp_max_rmse: float = 0.8
    icp_min_inliers: int = 200
    icp_points: int = 1024          # subsampled ICP cloud kept per keyframe
    rebuild_points: int = 8192      # per-keyframe cloud used for the post-
                                    # loop map REBUILD — kept at near-insert
                                    # density, decoupled from icp_points (a
                                    # 1024-pt rebuild collapsed map density
                                    # ~10× after the first loop closure)
    capture_lag: int = 1            # scans the keyframe capture lags behind
                                    # dispatch: reading scan i's outputs while
                                    # scan i+lag is in flight is a pure
                                    # transfer, never a device sync
    consistency_trans: float = 2.0  # m: |ICP edge − odometry-predicted edge|
    consistency_rot: float = 0.25   # rad
    retrieve_top_k: int = 10        # ring-key candidates checked with the full
                                    # SC distance (ScanContext paper uses ~10;
                                    # top-1 silently loses loops to occlusion)
    max_keyframes: int = 1024       # ENFORCED: past the cap, old unprotected
                                    # keyframes are spatially subsampled with
                                    # a density floor (loop-edge endpoints,
                                    # GPS anchors and the recent window
                                    # always survive)
    max_edges: int = 4096           # graph edge capacity; oldest loop edges
                                    # are dropped when the budget is exceeded
    rebuild_batch: int = 8          # keyframes per insert during the map
                                    # rebuild (one sort + scatter a batch)
    optimize_iters: int = 8
    optimize_iters_large: int = 3   # GN iterations past 256 keyframes: the
                                    # online graph is warm-started from the
                                    # previous optimum, so cost plateaus by
                                    # iter 2-3
    loop_weight: float = 5.0
    loop_cooldown: float = 0.0      # s: skip loop DETECTION within this
                                    # window of the last accepted closure.
                                    # On a continuous revisit every new
                                    # keyframe re-closes (each paying a
                                    # graph optimize + map rebuild) for
                                    # near-zero added correction; 0 = off
    rebuild_eps: float = 0.01       # m: skip the post-optimize map rebuild
                                    # when NO keyframe moved farther than
                                    # this (a GPS micro-adjust moves poses
                                    # by mm — rebuilding the whole map for
                                    # that stalls the pipeline for nothing);
                                    # also the tolerance for reusing the
                                    # cached stable-prefix map
    rebuild_cache: bool = True      # keep one mid-rebuild map snapshot so
                                    # the next rebuild re-inserts only the
                                    # keyframes after the stable prefix
                                    # (costs one map copy of memory)
    robust_delta: float = 0.0       # m: Huber width for graph EDGES (IRLS,
                                    # posegraph.optimize robust_delta) — a
                                    # corrupted odometry/loop edge saturates
                                    # instead of dragging the chain; 0 = off
                                    # (pure quadratic)
    robust_delta_priors: float = 0.0  # m: Huber width for GPS position
                                    # priors — a glitched fix saturates
                                    # instead of yanking its nodes; 0 = off
    gps_weight: float = 5.0         # information weight of GPS position priors
    gps_time_tol: float = 0.25      # s: max |gps stamp − keyframe stamp| to attach
    gps_optimize_every: int = 10    # re-optimize (graph GN + map rebuild +
                                    # live-state correction) after this many
                                    # new GPS factors.  10 ≈ every 2-10 s at
                                    # typical 1-5 Hz GNSS — frequent enough
                                    # to pin degenerate-corridor drift
                                    # without rebuilding the map every fix.
                                    # 0 disables auto-optimize (factors then
                                    # only apply at the next loop closure).


@dataclass
class Keyframe:
    index: int
    stamp: float
    pos: np.ndarray
    quat: np.ndarray
    desc: np.ndarray
    ring_key: np.ndarray
    cloud: np.ndarray           # (P,3) body frame, subsampled for ICP
    cloud_valid: np.ndarray
    # (R,3) body frame at near-insert density, used ONLY for the post-loop
    # map rebuild; None falls back to the ICP cloud (legacy sessions)
    rebuild_cloud: Optional[np.ndarray] = None
    rebuild_valid: Optional[np.ndarray] = None
    scan_index: int = -1        # which scan this keyframe captured


class SLAM:
    """Host orchestrator: Localizer + loop closure + pose graph."""

    def __init__(self, cfg: Config, loop_cfg: Optional[LoopConfig] = None,
                 enable_loop_closure: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.loop_cfg = loop_cfg or LoopConfig()
        if enable_loop_closure and cfg.tpu.scan_chunk > 1:
            # keyframe capture reads per-scan clouds off last_output; the
            # chunked replay path stacks outputs and is odometry-only
            raise ValueError("tpu.scan_chunk > 1 is an odometry-replay knob; "
                             "use scan_chunk=1 with loop closure")
        self.loc = Localizer(cfg, self.device)
        self.enable_loop = enable_loop_closure
        self.keyframes: List[Keyframe] = []
        self._rebuild_snapshot = None       # (P, map, stamps[:P], poses[:P])
        self.n_rebuilds = 0                 # observability (tests/telemetry)
        self._sweep_buf: List[tuple] = []   # packet outputs of the open sweep
        self._sweep_epoch = None
        self.loop_edges: List[tuple] = []   # (i, j, quat, trans)
        self.n_loops_closed = 0
        self._last_loop_stamp = -np.inf
        self._last_scan_count = 0
        # GPS factors: positions must already be in the odometry world frame
        # (ENU with a shared origin)
        self._gps_buffer: List[tuple] = []   # (stamp, pos, weight) pending
        self.gps_factors: List[tuple] = []   # (kf_index, pos, weight, alpha)
        self._gps_since_opt = 0
        # host-side per-scan pose log (stamp, pos) — already fetched by the
        # capture path; gives GPS attachment a scan-resolution trajectory
        # shape (the keyframe chord is off by the curvature sagitta: 0.28 m
        # at 15 m/s over a 0.5 s keyframe gap)
        self._pose_log_t: List[float] = []
        self._pose_log_p: List[np.ndarray] = []

    # ------------------------------------------------------------- feeding
    def update_imu(self, stamp, acc, gyro):
        self.loc.update_imu(stamp, acc, gyro)
        self._after_dispatch()

    def update_pointcloud(self, points, t_raw, stamp):
        self.loc.update_pointcloud(points, t_raw, stamp)
        self._after_dispatch()

    def flush(self):
        """End-of-stream: dispatch any covered partial chunk (chunked replay),
        capture keyframes for the last ``capture_lag`` scans, and apply any
        GPS factors attached since the last optimize (final smoothing — the
        tail of the trajectory otherwise drifts past the last auto-optimize
        cadence mark)."""
        self.loc.flush()
        self._after_dispatch(lag=0)
        self._attach_gps()
        if self._gps_since_opt > 0 and len(self.keyframes) > 1:
            self._gps_since_opt = 0
            self._optimize_and_correct()

    def update_gps(self, stamp, pos, weight: Optional[float] = None):
        """Feed a GPS fix (world-frame position, seconds).  Attached as a
        unary pose-graph prior to the keyframe nearest in time."""
        self._gps_buffer.append(
            (float(stamp), np.asarray(pos, np.float64),
             float(weight) if weight is not None else self.loop_cfg.gps_weight))
        self._attach_gps()
        lc = self.loop_cfg
        if (lc.gps_optimize_every and len(self.keyframes) > 1
                and self._gps_since_opt >= lc.gps_optimize_every):
            self._gps_since_opt = 0
            self._optimize_and_correct()

    def _attach_gps(self):
        """Bind buffered fixes to keyframes as INTERPOLATED position priors.

        A fix measured at ``ts`` between the keyframes (a, b) bracketing it
        becomes a two-node factor ``r = (1−α)·t_a + α·t_b − pos`` with
        ``α = (ts − t_a)/(t_b − t_a)`` (`posegraph.prior_alpha`): the
        measurement constrains the trajectory WHERE it was taken.  An
        odometry transfer of the fix to the nearest anchor (``pos + (kf.pos
        − est(ts))``) has the right timing, but when the odometry segment
        itself carries a transient error the transfer bakes that error into
        the prior target and the prior then CONFIRMS the bad pose.  The
        interpolated factor pins the bracketing nodes to the raw
        measurement instead.  Fixes newer than the newest keyframe wait in
        the buffer until bracketed."""
        if not self.keyframes:
            return
        tol = self.loop_cfg.gps_time_tol
        latest = self.keyframes[-1].stamp
        keep = []
        for (ts, pos, w) in self._gps_buffer:
            if ts > latest:
                keep.append((ts, pos, w))   # its bracket may not exist yet
                continue
            # bracketing keyframes ka.stamp <= ts <= kb.stamp
            ka = kb = None
            for kf in reversed(self.keyframes):
                if kf.stamp >= ts:
                    kb = kf
                else:
                    ka = kf
                    break
            if ka is None:
                # older than every keyframe: no bracket; attach raw (unary)
                # only when the residual v·Δt error is bounded
                if kb is not None and kb.stamp - ts <= tol:
                    self.gps_factors.append((kb.index, pos, w, 0.0))
                    self._gps_since_opt += 1
                continue                     # else: stale pre-map fix, drop
            span = kb.stamp - ka.stamp
            alpha = (ts - ka.stamp) / span if span > 1e-9 else 0.0
            if kb.index != ka.index + 1:     # thinning broke adjacency
                alpha = 0.0 if alpha < 0.5 else 1.0
            # curvature correction: the factor's linear-chord model
            # (1−α)t_a + α·t_b is off by the trajectory's chord sagitta; the
            # engine's own scan-rate pose log knows the local shape, so the
            # target absorbs c = est_scan(ts) − chord(ts).  Errors enter c
            # only as SECOND differences of the odometry error over the
            # bracket — filter transients and smooth loop corrections cancel
            # (a first-difference odometry transfer bakes them in whole).
            target = np.asarray(pos, np.float64)
            c = self._chord_correction(ts, ka, kb, alpha)
            if c is not None:
                target = target - c
            if alpha >= 1.0 - 1e-6:          # lands on kb: plain unary
                self.gps_factors.append((kb.index, target, w, 0.0))
            else:
                self.gps_factors.append((ka.index, target, w, float(alpha)))
            self._gps_since_opt += 1
        self._gps_buffer = keep

    def _chord_correction(self, ts, ka, kb, alpha):
        """``est_scan(ts) − ((1−α)·ka.pos + α·kb.pos)`` from the per-scan
        pose log, or None when the log cannot bracket ``ts``.  Uses the
        log's CAPTURE-time poses against the keyframes' capture-time poses
        — consistent as long as later graph corrections vary smoothly over
        the bracket (their second difference cancels)."""
        t_log = self._pose_log_t
        n = len(t_log)
        if n < 2 or ts < t_log[0] or ts > t_log[-1]:
            return None
        j = bisect.bisect_right(t_log, ts)
        j = min(max(j, 1), n - 1)
        t0, t1 = t_log[j - 1], t_log[j]
        f = (ts - t0) / (t1 - t0) if t1 > t0 else 0.0
        est = (1.0 - f) * self._pose_log_p[j - 1] + f * self._pose_log_p[j]
        # keyframe capture-time positions: the log entries at their stamps
        ia = bisect.bisect_left(t_log, ka.stamp)
        ib = bisect.bisect_left(t_log, kb.stamp)
        if (ia >= n or ib >= n or abs(t_log[ia] - ka.stamp) > 1e-6
                or abs(t_log[ib] - kb.stamp) > 1e-6):
            return None
        pa, pb = self._pose_log_p[ia], self._pose_log_p[ib]
        return est - ((1.0 - alpha) * pa + alpha * pb)

    # ------------------------------------------------------------- internals
    def _after_dispatch(self, lag: Optional[int] = None):
        """Capture keyframes from the per-scan device outputs.

        Reads each scan's OWN ``ScanOutput`` (kept device-side in
        ``Localizer._raw_outputs``), so a drain that dispatches ≥2 covered
        scans at once can never pair one scan's pose with another's cloud.
        Capture lags ``capture_lag`` scans behind dispatch: the read of
        scan i while scan i+lag is in flight is a transfer of long-computed
        results, never a wait for the step just dispatched (the hot-path
        stall `_bound_retention`/`_maybe_evict` are built to avoid)."""
        if not self.enable_loop:
            return
        if lag is None:
            lag = max(0, int(self.loop_cfg.capture_lag))
        raw = self.loc._raw_outputs
        upto = len(raw) - lag
        if self._last_scan_count >= upto:
            return
        pend = range(self._last_scan_count, upto)
        # ONE batched fetch of the tiny per-scan pose scalars
        live = [raw[i][1] for i in pend if raw[i][1] is not None]
        heads = (torch.stack([torch.cat([o.scan_stamp.reshape(1), o.pos, o.quat])
                              for o in live]).cpu().numpy().astype(np.float64)
                 if live else None)
        hi = 0
        for i in pend:
            epoch, out = raw[i]
            self._last_scan_count = i + 1
            if out is None:      # released by a trajectory materialization
                continue
            sstamp, pos, quat = heads[hi, 0], heads[hi, 1:4], heads[hi, 4:8]
            hi += 1
            entry = (i, float(epoch + float(sstamp)), pos, quat,
                     out.scan_body, out.final_valid)
            self._pose_log_t.append(entry[1])
            self._pose_log_p.append(entry[2])
            # ---- sweep stitching (per-packet sensor mode) ----
            # Packets of one sweep arrive as separate dispatches sharing the
            # sweep HEADER stamp (= the epoch).
            # Keyframing needs sweep-complete clouds, so packet outputs
            # buffer per epoch and flush as ONE stitched keyframe candidate
            # when the next sweep begins.  Full-sweep mode: every dispatch
            # has a fresh epoch → each buffer holds exactly one entry.
            if self._sweep_buf and self._sweep_epoch == epoch:
                self._sweep_buf.append(entry)
                continue
            self._flush_sweep()
            self._sweep_epoch = epoch
            self._sweep_buf = [entry]
        if lag == 0:
            # end-of-stream / materialization: consider the pending sweep
            # now (in packet mode it may still be partial — the kf gates
            # and a later re-consideration handle that)
            self._flush_sweep()

    def _t(self, a, dtype=torch.float32):
        """A host array as a tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _flush_sweep(self):
        """Emit the buffered sweep as one keyframe candidate."""
        buf, self._sweep_buf = self._sweep_buf, []
        if not buf:
            return
        scan_idx, stamp, pos, quat, body, valid = buf[-1]
        if len(buf) > 1:
            # stitch packet clouds into the LAST packet's body frame:
            # body_L = R_Lᵀ(R_i·c_i + p_i − p_L)
            clouds = torch.stack([e[4] for e in buf])
            quats = self._t(np.stack([e[3] for e in buf]))
            poss = self._t(np.stack([e[2] for e in buf]))
            world = so3.quat_rotate(quats[:, None, :], clouds) + poss[:, None, :]
            body = so3.quat_rotate(so3.quat_conj(self._t(quat)),
                                   world.reshape(-1, 3) - self._t(pos))
            valid = torch.stack([e[5] for e in buf]).reshape(-1)
        self._consider_keyframe(scan_idx, stamp, pos, quat, body, valid)

    def _consider_keyframe(self, scan_idx: int, stamp: float,
                           pos: np.ndarray, quat: np.ndarray,
                           body_dev, valid_dev):
        if self.keyframes:
            last = self.keyframes[-1]
            dp = np.linalg.norm(pos - last.pos)
            dyaw = _rot_angle(_quat_mul(last.quat * _CONJ, quat))
            if dp < self.loop_cfg.kf_dist and dyaw < self.loop_cfg.kf_angle:
                return

        # accepted: compute the ScanContext descriptor on demand (it is NOT
        # in the per-scan pipeline — keyframes are sparse) and fetch the
        # scan's own cloud
        sc = self.cfg.sc
        desc_dev = scancontext.descriptor(
            body_dev, valid_dev, n_ring=sc.n_ring, n_sector=sc.n_sector,
            max_radius=sc.max_radius, height_shift=sc.height_shift)
        key_dev = scancontext.ring_key(desc_dev)
        body, valid = body_dev.cpu().numpy(), valid_dev.cpu().numpy()
        desc, key = desc_dev.cpu().numpy(), key_dev.cpu().numpy()
        sel = np.nonzero(valid)[0]

        def subsample(cap):
            s = sel
            if len(s) > cap:
                s = s[np.linspace(0, len(s) - 1, cap).astype(int)]
            cloud = np.zeros((cap, 3), np.float32)
            cvalid = np.zeros(cap, bool)
            cloud[: len(s)] = body[s]
            cvalid[: len(s)] = True
            return cloud, cvalid

        cloud, cvalid = subsample(self.loop_cfg.icp_points)
        rcloud, rvalid = subsample(self.loop_cfg.rebuild_points)

        kf = Keyframe(
            index=len(self.keyframes), stamp=stamp,
            pos=pos.copy(), quat=quat.copy(),
            desc=desc, ring_key=key,
            cloud=cloud, cloud_valid=cvalid,
            rebuild_cloud=rcloud, rebuild_valid=rvalid,
            scan_index=scan_idx)
        self.keyframes.append(kf)
        self._enforce_keyframe_cap()
        self._attach_gps()
        self._detect_loop(self.keyframes[-1])

    def _enforce_keyframe_cap(self):
        """Bound the keyframe database (LoopConfig.max_keyframes).

        The dense GN solves 6K×6K, so K must stay bounded on hours-long
        runs.  Past the cap, OLD keyframes are SPATIALLY subsampled: one
        survivor per grid cell of side ``cell`` (starting at 2·kf_dist and
        doubling only until the budget fits) — a uniform density floor over
        everywhere the run has been, so a revisit anywhere finds a keyframe
        within ~cell·√3.  Loop-edge endpoints, GPS anchors, keyframe 0 and
        the recent exclude window always survive."""
        lc = self.loop_cfg
        if len(self.keyframes) <= lc.max_keyframes:
            return
        protected = {i for e in self.loop_edges for i in e[:2]}
        # interp GPS factors (alpha>0) need BOTH bracketing nodes — and
        # them staying list-adjacent, which "both survive" guarantees
        # (nothing sits between positions i and i+1)
        protected |= {i for (i, _p, _w, _a) in self.gps_factors}
        protected |= {i + 1 for (i, _p, _w, a) in self.gps_factors if a > 0}
        recent_from = len(self.keyframes) - lc.exclude_recent - 1
        always = {k for k in range(len(self.keyframes))
                  if k == 0 or k >= recent_from or k in protected}
        old = [k for k in range(len(self.keyframes)) if k not in always]

        cell = max(2.0 * lc.kf_dist, 1e-6)
        budget = max(lc.max_keyframes - len(always), 0)
        keep_old = old
        while len(keep_old) > budget and cell < 1e7:
            seen = set()
            keep_old = []
            for k in old:                     # earliest survivor per cell
                key = tuple(np.floor(self.keyframes[k].pos / cell)
                            .astype(np.int64))
                if key not in seen:
                    seen.add(key)
                    keep_old.append(k)
            if len(keep_old) <= budget:
                break
            cell *= 2.0
        keep = sorted(always | set(keep_old))
        remap = {old_i: new for new, old_i in enumerate(keep)}
        self.keyframes = [self.keyframes[k] for k in keep]
        for new, kf in enumerate(self.keyframes):
            kf.index = new
        self.loop_edges = [
            (remap[e[0]], remap[e[1]], *e[2:]) for e in self.loop_edges]
        self.gps_factors = [
            (remap[i], p, w, a) for (i, p, w, a) in self.gps_factors
            if i in remap]

    def _detect_loop(self, kf: Keyframe):
        lc = self.loop_cfg
        n = len(self.keyframes)
        if n <= lc.exclude_recent + 1:
            return
        if (lc.loop_cooldown > 0
                and kf.stamp - self._last_loop_stamp < lc.loop_cooldown):
            # throttle: on a continuous revisit EVERY keyframe would close
            # a loop, each paying a graph optimize + map rebuild — after a
            # correction just landed, the next closure adds ~nothing
            return
        cands = self.keyframes[: n - 1 - lc.exclude_recent]
        # odometry-proximity gate: drift is bounded, so genuine revisits are
        # near the current estimate — kills the rotational-symmetry aliases
        near = [c for c in cands
                if np.linalg.norm(c.pos - kf.pos) < lc.search_radius]
        if not near:
            return
        # top-K ring-key candidates, arbitrated by the full shifted-cosine
        # distance (ScanContext's published retrieval; top-1 loses the loop
        # whenever occlusion/dynamic objects perturb one ring histogram)
        keys = np.stack([c.ring_key for c in near])
        d = np.sum(np.abs(keys - kf.ring_key[None]), axis=1)
        order = np.argsort(d)[: lc.retrieve_top_k]
        cand, shift, best_dist = None, None, np.inf
        dists, shifts = scancontext.distance(
            self._t(kf.desc), self._t(np.stack([near[int(ci)].desc for ci in order])))
        dists, shifts = dists.cpu().numpy(), shifts.cpu().numpy()
        for n_i, ci in enumerate(order):
            if float(dists[n_i]) < best_dist:
                best_dist, cand, shift = float(dists[n_i]), near[int(ci)], int(shifts[n_i])
        if cand is None or best_dist > lc.sc_dist_thresh:
            return

        # ICP: align kf cloud onto candidate cloud.  Two seeds are tried —
        # the SC-shift yaw (works at unbounded drift) and the
        # odometry-predicted relative pose (works whenever drift is inside
        # the convergence basin).  In rotationally self-similar scenes the
        # SC yaw can be one bin off and ICP then locks onto an alias; the
        # odometry seed recovers exactly those cases, and the consistency
        # gate below arbitrates either way.
        qc_i = cand.quat * _CONJ
        q_pred = self._t(_quat_mul(qc_i, kf.quat))
        t_pred = self._t(_quat_rotate(qc_i, kf.pos - cand.pos))
        yaw = scancontext.shift_to_yaw(shift, n_sector=kf.desc.shape[1])
        q_sc = so3.exp_quat(self._t([0.0, 0.0, yaw]))
        seeds = [(q_pred, t_pred), (q_sc, None)]

        def gate_errors(r):
            """(|Δt|, |Δrot|) of a measured edge against the odometry one."""
            return (float(torch.linalg.norm(r.trans - t_pred)),
                    float(torch.linalg.norm(so3.log_quat(
                        so3.quat_mul(so3.quat_conj(r.quat), q_pred)))))

        kf_cloud, kf_valid = self._t(kf.cloud), self._t(kf.cloud_valid, torch.bool)
        cand_cloud, cand_valid = self._t(cand.cloud), self._t(cand.cloud_valid, torch.bool)

        # ICP maps kf-body → cand-body coords, i.e. T_icp ≈ T_cand⁻¹·T_kf —
        # exactly the (i=cand → j=kf) edge measurement T_i⁻¹T_j.
        # Consistency gate: the measured edge must agree with the
        # odometry-predicted relative pose to within the drift budget —
        # rejects perceptual aliases and poor ICP fits before they can
        # corrupt the graph.
        res = None
        for q0, t0 in seeds:
            r = icp.icp(kf_cloud, kf_valid, cand_cloud, cand_valid,
                        init_quat=q0, init_trans=t0,
                        max_corr_dist=1.0, iters=15)
            if (float(r.rmse) > lc.icp_max_rmse
                    or int(r.n_inliers) < lc.icp_min_inliers):
                continue
            dt_err, dr_err = gate_errors(r)
            if dt_err > lc.consistency_trans or dr_err > lc.consistency_rot:
                continue
            if res is None or float(r.rmse) < float(res.rmse):
                res = r
        if res is None:
            return

        # Point-to-plane refinement (the GICP-class step): point-to-point
        # Kabsch plateaus at the subcloud sampling distance, which would
        # be the SLAM layer's accuracy floor.  Refine the accepted transform against the candidate's
        # rebuild-density cloud with surface normals; keep the refinement
        # only if it stays inside the same consistency gates (one-sided
        # normal fields can slide along their null directions).
        if cand.rebuild_cloud is not None:
            dst_c, dst_v = self._t(cand.rebuild_cloud), self._t(cand.rebuild_valid, torch.bool)
        else:
            dst_c, dst_v = cand_cloud, cand_valid
        nrm, nok = icp.estimate_normals(dst_c, dst_v)
        ref = icp.icp_point_to_plane(
            kf_cloud, kf_valid, dst_c, dst_v, nrm, nok,
            init_quat=res.quat, init_trans=res.trans,
            max_corr_dist=1.0, iters=8)
        dt_r, dr_r = gate_errors(ref)
        if (int(ref.n_inliers) >= lc.icp_min_inliers
                and dt_r <= lc.consistency_trans
                and dr_r <= lc.consistency_rot):
            res = ref

        self.loop_edges.append((cand.index, kf.index,
                                res.quat.cpu().numpy(), res.trans.cpu().numpy()))
        self.n_loops_closed += 1
        self._last_loop_stamp = kf.stamp
        self._optimize_and_correct()

    def _optimize_and_correct(self):
        lc = self.loop_cfg
        K = len(self.keyframes)
        # edge budget: K-1 odometry edges + loop edges must fit max_edges
        # (add_edge past capacity silently clobbers the last slot); oldest
        # loop edges are the least informative after their correction landed
        max_loops = max(0, lc.max_edges - (K - 1))
        if len(self.loop_edges) > max_loops:
            self.loop_edges = self.loop_edges[-max_loops:]
        max_nodes = 1 << max(3, (K - 1).bit_length())
        if len(self.gps_factors) > max_nodes:   # prior capacity == max_nodes
            self.gps_factors = self.gps_factors[-max_nodes:]

        # ---- batched graph build: host arrays, ONE staging pass ----
        quats = np.stack([kf.quat for kf in self.keyframes])
        poss = np.stack([kf.pos for kf in self.keyframes])
        qa_inv = quats[:-1] * _CONJ
        q_rel = _quat_mul(qa_inv, quats[1:])
        t_rel = _quat_rotate(qa_inv, poss[1:] - poss[:-1])
        ei = list(range(K - 1))
        ej = list(range(1, K))
        eq = [q_rel[k] for k in range(K - 1)]
        et = [t_rel[k] for k in range(K - 1)]
        ew = [1.0] * (K - 1)
        for (i, j, q, t) in [e[:4] for e in self.loop_edges]:
            # edge measurement: pose of j in i's frame; ICP gave T_i←j
            ei.append(i); ej.append(j); eq.append(np.asarray(q))
            et.append(np.asarray(t)); ew.append(lc.loop_weight)
        pi = [i for (i, _p, _w, _a) in self.gps_factors]
        pp = [p for (_i, p, _w, _a) in self.gps_factors]
        pw = [w for (_i, _p, w, _a) in self.gps_factors]
        pa = [a for (_i, _p, _w, a) in self.gps_factors]
        # capacities: the next power of two of the ACTUAL counts — the
        # Jacobians and the solve run over the padded capacity
        E = len(ei)
        cap_e = 1 << max(3, (E - 1).bit_length())
        cap_p = 1 << max(3, (len(pi) - 1).bit_length() if pi else 3)
        g = posegraph.from_arrays(
            quats, poss, ei, ej, eq, et, ew, pi or None, pp or None,
            pw or None, pa or None, max_nodes=max_nodes, max_edges=cap_e,
            max_priors=cap_p, device=self.device)

        iters = (lc.optimize_iters if K <= 256 else
                 min(lc.optimize_iters, lc.optimize_iters_large))
        g2, _ = posegraph.optimize(
            g, iters=iters, robust_delta=lc.robust_delta,
            robust_delta_priors=lc.robust_delta_priors)

        new_quat = g2.quat[:K].cpu().numpy()
        new_pos = g2.trans[:K].cpu().numpy()

        # pose delta at the newest keyframe → push into the filter state
        q_old, p_old = self.keyframes[-1].quat, self.keyframes[-1].pos
        q_new, p_new = new_quat[K - 1], new_pos[K - 1]
        dq = self._t(_quat_mul(q_new, q_old * _CONJ))

        # how far did the optimization actually move things?
        max_shift = float(np.max(np.linalg.norm(new_pos - poss, axis=1))) \
            if K else 0.0

        # update stored keyframes to optimized poses
        for k, kf in enumerate(self.keyframes):
            kf.quat = new_quat[k]
            kf.pos = new_pos[k]

        # correct the live filter state: x ← Δ ∘ x (world-frame correction)
        s = self.loc.state
        x = s.x
        x_rot = so3.quat_normalize(so3.quat_mul(dq, x.rot))
        x_pos = so3.quat_rotate(dq, x.pos - self._t(p_old)) + self._t(p_new)
        x_vel = so3.quat_rotate(dq, x.vel)
        self.loc.state = s._replace(x=x._replace(rot=x_rot, pos=x_pos, vel=x_vel))

        # ε-gated rebuild: a micro-adjust (every pose moved < rebuild_eps)
        # leaves the map within one downsample-noise of correct — rebuilding
        # ~10⁶ points for millimetres stalls the "real-time" pipeline
        if max_shift > lc.rebuild_eps:
            self._rebuild_map()

    def _rebuild_map(self):
        """Re-insert keyframe REBUILD clouds at optimized poses into a
        fresh map.

        Uses the near-insert-density ``rebuild_cloud`` (rebuild_points per
        keyframe), NOT the 1024-pt ICP cloud — rebuilding from ICP clouds
        decimates the matching map ~10× after the first loop closure.
        Batched: ``rebuild_batch`` keyframes are transformed and inserted
        per ``mapper.insert`` call (one sort and scatter a batch; the tail
        batch is zero-padded).

        Incremental (``rebuild_cache``): rebuilds insert in keyframe order,
        so one mid-rebuild snapshot (the map after the first P keyframes,
        with the poses it was built from) lets the NEXT rebuild skip the
        stable prefix — only keyframes after P re-insert when the first P
        poses moved less than ``rebuild_eps`` (typical for loop closures,
        which bend the recent segment and barely touch the old one)."""
        cfg = self.cfg
        lc = self.loop_cfg
        vox = cfg.map_voxel_size
        B = max(1, lc.rebuild_batch)
        K = len(self.keyframes)
        self.n_rebuilds += 1

        def rcloud(kf):
            if kf.rebuild_cloud is not None:
                return kf.rebuild_cloud, kf.rebuild_valid
            return kf.cloud, kf.cloud_valid

        P = max((rcloud(kf)[0].shape[0] for kf in self.keyframes), default=0)
        stamps = np.array([kf.stamp for kf in self.keyframes])
        poses = np.concatenate(
            [np.stack([kf.pos for kf in self.keyframes]),
             np.stack([kf.quat for kf in self.keyframes])], axis=1) \
            if K else np.zeros((0, 7))

        # resume from the cached stable prefix when its keyframes (matched
        # by stamp) still sit within rebuild_eps of the poses it was built at
        start = 0
        m = None
        snap = self._rebuild_snapshot if lc.rebuild_cache else None
        if snap is not None:
            Pn, m_snap, s_stamps, s_poses = snap
            if (Pn <= K and np.array_equal(stamps[:Pn], s_stamps)
                    and np.all(np.linalg.norm(
                        poses[:Pn, :3] - s_poses[:, :3], axis=1) <= lc.rebuild_eps)
                    and np.all(np.linalg.norm(
                        poses[:Pn, 3:] - s_poses[:, 3:], axis=1) <= 0.02)):
                start = Pn
                m = m_snap
        if m is None:
            m = mapper.create(cfg.tpu.map_capacity, cfg.map_points_per_voxel,
                              self.device)

        # snapshot point: the last batch boundary ≤ 3/4 of the keyframes
        # (recent keyframes are the ones future optimizations move)
        snap_at = (max(0, int(K * 0.75)) // B) * B if lc.rebuild_cache else -1

        for i0 in range(start, K, B):
            if i0 == snap_at and i0 > 0:
                self._rebuild_snapshot = (
                    i0, m, stamps[:i0].copy(), poses[:i0].copy())
            batch = self.keyframes[i0:i0 + B]
            clouds = np.zeros((B, P, 3), np.float32)
            valids = np.zeros((B, P), bool)
            quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (B, 1))
            poss = np.zeros((B, 3), np.float32)
            for i, kf in enumerate(batch):
                c, v = rcloud(kf)
                clouds[i, : len(c)], valids[i, : len(v)] = c, v
                quats[i], poss[i] = kf.quat, kf.pos
            world = (so3.quat_rotate(self._t(quats)[:, None, :], self._t(clouds))
                     + self._t(poss)[:, None, :])
            m = mapper.insert(m, world.reshape(-1, 3),
                              self._t(valids, torch.bool).reshape(-1), voxel_size=vox)
        self.loc.state = self.loc.state._replace(map=m)

    # ------------------------------------------------------------- sessions
    def save_session(self, prefix: str) -> None:
        """Persist filter+map checkpoint and the keyframe database.

        Enables the multi-session workflow: a later run (of either
        package: the files are the JAX package's) loads the session,
        relocalizes, and keeps mapping.
        """
        self.loc.save_checkpoint(prefix + ".state.npz")

        def rebuild_stack(attr_cloud, attr_valid, fb_cloud, fb_valid, dim):
            # rebuild clouds can be ragged across keyframes (a legacy-session
            # load falls back to icp_points-sized clouds) — pad to the max
            rows = [(getattr(k, attr_cloud) if getattr(k, attr_cloud) is not None
                     else getattr(k, fb_cloud)) for k in self.keyframes]
            vals = [(getattr(k, attr_valid) if getattr(k, attr_cloud) is not None
                     else getattr(k, fb_valid)) for k in self.keyframes]
            if not rows:
                return (np.zeros((0, 1, 3)), np.zeros((0, 1), bool))
            P = max(r.shape[0] for r in rows)
            out_c = np.zeros((len(rows), P) + ((dim,) if dim else ()), np.float32)
            out_v = np.zeros((len(rows), P), bool)
            for i, (r, v) in enumerate(zip(rows, vals)):
                out_c[i, : len(r)] = r
                out_v[i, : len(v)] = v
            return out_c, out_v

        rb_cloud, rb_valid = rebuild_stack(
            "rebuild_cloud", "rebuild_valid", "cloud", "cloud_valid", 3)
        np.savez_compressed(
            prefix + ".keyframes.npz",
            n=len(self.keyframes),
            stamps=np.asarray([k.stamp for k in self.keyframes]),
            pos=np.stack([k.pos for k in self.keyframes]) if self.keyframes else np.zeros((0, 3)),
            quat=np.stack([k.quat for k in self.keyframes]) if self.keyframes else np.zeros((0, 4)),
            desc=np.stack([k.desc for k in self.keyframes]) if self.keyframes else np.zeros((0, 1, 1)),
            ring_key=np.stack([k.ring_key for k in self.keyframes]) if self.keyframes else np.zeros((0, 1)),
            cloud=np.stack([k.cloud for k in self.keyframes]) if self.keyframes else np.zeros((0, 1, 3)),
            cloud_valid=np.stack([k.cloud_valid for k in self.keyframes]) if self.keyframes else np.zeros((0, 1), bool),
            rebuild_cloud=rb_cloud,
            rebuild_valid=rb_valid,
            scan_index=np.asarray([k.scan_index for k in self.keyframes], np.int64),
            loop_edges_i=np.asarray([e[0] for e in self.loop_edges], np.int32),
            loop_edges_j=np.asarray([e[1] for e in self.loop_edges], np.int32),
            loop_edges_q=np.stack([e[2] for e in self.loop_edges]) if self.loop_edges else np.zeros((0, 4)),
            loop_edges_t=np.stack([e[3] for e in self.loop_edges]) if self.loop_edges else np.zeros((0, 3)),
        )

    def load_session(self, prefix: str, reset_clock: bool = True) -> None:
        self.loc.load_checkpoint(prefix + ".state.npz", reset_clock=reset_clock)
        # clear per-run carries whose time base belongs to the PREVIOUS run
        # (mirrors localizer.reset_clock): a stale pose log would feed wrong
        # _chord_correction targets to GPS priors, and stale GPS/loop
        # bookkeeping would reference the old run's keyframe indices
        self._pose_log_t = []
        self._pose_log_p = []
        self._last_loop_stamp = -np.inf
        self._last_scan_count = 0
        self._gps_buffer = []
        self.gps_factors = []
        self._gps_since_opt = 0
        self._sweep_buf = []
        self._sweep_epoch = None
        self._rebuild_snapshot = None
        d = np.load(prefix + ".keyframes.npz")
        self.keyframes = []
        has_rebuild = "rebuild_cloud" in d.files   # legacy sessions lack it
        for k in range(int(d["n"])):
            self.keyframes.append(Keyframe(
                index=k, stamp=float(d["stamps"][k]),
                pos=d["pos"][k], quat=d["quat"][k], desc=d["desc"][k],
                ring_key=d["ring_key"][k], cloud=d["cloud"][k],
                cloud_valid=d["cloud_valid"][k],
                rebuild_cloud=(d["rebuild_cloud"][k] if has_rebuild
                               else d["cloud"][k]),
                rebuild_valid=(d["rebuild_valid"][k] if has_rebuild
                               else d["cloud_valid"][k]),
                scan_index=(int(d["scan_index"][k])
                            if "scan_index" in d.files else -1)))
        self.loop_edges = [
            (int(d["loop_edges_i"][k]), int(d["loop_edges_j"][k]),
             d["loop_edges_q"][k], d["loop_edges_t"][k])
            for k in range(len(d["loop_edges_i"]))]

    def relocalize_bootstrap(self, cloud_a, valid_a, stamp_a,
                             cloud_b, valid_b, stamp_b, **kw):
        """The multi-session flow in one call: localize two consecutive
        scans of a NEW run against this (loaded) session's keyframes,
        derive the velocity from the pose pair, and — on success — push
        pose+velocity into the filter so tracking/mapping continue in the
        old map's world frame.  Returns ``(RelocResult, velocity)``; the
        filter is untouched on failure."""
        kw.setdefault("sc_params", dict(
            n_ring=self.cfg.sc.n_ring, n_sector=self.cfg.sc.n_sector,
            max_radius=self.cfg.sc.max_radius,
            height_shift=self.cfg.sc.height_shift))
        kw.setdefault("device", self.device)
        res, vel = rl.relocalize_pair(
            cloud_a, valid_a, cloud_b, valid_b, stamp_b - stamp_a,
            self.keyframes, **kw)
        if res.success:
            rl.apply_to_localizer(self.loc, res, velocity=vel)
        return res, vel

    def relocalize_scan(self, query_cloud, query_valid, **kw):
        """Global relocalization of a body-frame scan against this session's
        keyframe database (see models/relocalize.py)."""
        kw.setdefault("sc_params", dict(
            n_ring=self.cfg.sc.n_ring, n_sector=self.cfg.sc.n_sector,
            max_radius=self.cfg.sc.max_radius,
            height_shift=self.cfg.sc.height_shift))
        kw.setdefault("device", self.device)
        return rl.relocalize(query_cloud, query_valid, self.keyframes, **kw)

    # ------------------------------------------------------------- queries
    @property
    def trajectory(self):
        # materializing the trajectory releases the device-side raw outputs,
        # so capture any lagged keyframes first
        self._after_dispatch(lag=0)
        return self.loc.trajectory

    def positions(self):
        return np.array([t["pos"] for t in self.trajectory])

    def stamps(self):
        return np.array([t["stamp"] for t in self.trajectory])

    # state queries forward to the Localizer so a SLAM engine satisfies the
    # same query surface (e.g. AsyncIngest.get_world_state over a SLAM)
    def get_world_state(self):
        return self.loc.get_world_state()

    def get_body_state(self):
        return self.loc.get_body_state()

    def get_pose_covariance(self):
        return self.loc.get_pose_covariance()

    def get_twist_covariance(self):
        return self.loc.get_twist_covariance()
