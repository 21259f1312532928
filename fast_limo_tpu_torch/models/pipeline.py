"""The per-scan LIO step (port of fast_limo_tpu/models/pipeline.py:
LIOState, ScanBatch, ScanOutput, init_state, build_scan_step, the
streaming entry points on the packed layout — fuse_packs,
build_scan_step_packed, build_scan_step_split (one scan a call, the
Localizer's default) and build_scan_chunk_step (C scans a call) — and
build_prop_step, which the Localizer needs to fold an IMU backlog longer
than the batch into the state and for its IMU-rate state queries).

    (LIOState, ScanBatch) → (LIOState', ScanOutput)

IMU predict → scan filters → deskew (K1) → voxel downsample → certified
window re-match (K2) + iterated EKF update (K6; fallback K2-K5) → map
insert.  Plain tensor code between the kernels, on the device the state
lives on.  Times in the batch are relative to the scan's epoch; the host
keeps the absolute float64 epoch (see the JAX ScanBatch docstring).

Given a ``spans`` recorder (``utils/telemetry.Spans``: the Localizer's),
the step marks its stages as spans while the recorder is live:
``step.predict``, ``step.preprocess``, ``step.deskew``, ``step.voxel``,
``step.update`` and ``step.insert``, one set per chunk element.

The update stage (the window resolve, K6 and the exact loop behind its
flag, the null-iteration select) is one function of tensors, run through
``graphs.StageGraph``: on CUDA tensors with the fused body, no shard or
query axis and no ``cfg.debug``, it replays as one captured CUDA graph;
the recorder's ``update_graph`` counts how it ran.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fast_limo_tpu_torch.models import deskew as dsk
from fast_limo_tpu_torch.models import graphs, iekf, mapper, measurement, preprocess
from fast_limo_tpu_torch.models import process as proc
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import dispatch, so3, voxel
from fast_limo_tpu_torch.utils.config import Config
from fast_limo_tpu_torch.utils.telemetry import Spans


class LIOState(NamedTuple):
    """Full device-resident state (same fields and layouts as the JAX one)."""

    x: st.NavState
    P: torch.Tensor
    map: mapper.VoxelHashMap
    prev_scan_stamp: torch.Tensor
    last_prop_time: torch.Tensor
    last_w_raw_bl: torch.Tensor
    last_w: torch.Tensor
    last_a: torch.Tensor
    bias_gyro_corr: torch.Tensor
    bias_accel_corr: torch.Tensor
    pinned_grav: torch.Tensor


class ScanBatch(NamedTuple):
    """Padded per-scan inputs; times relative to this scan's epoch."""

    points: torch.Tensor     # (N,3)
    t_raw: torch.Tensor      # (N,)
    valid: torch.Tensor      # (N,) bool
    stamp: torch.Tensor      # ()
    epoch_shift: torch.Tensor  # () this epoch − previous epoch
    imu_acc: torch.Tensor    # (K,3)
    imu_gyro: torch.Tensor   # (K,3)
    imu_stamp: torch.Tensor  # (K,)
    imu_valid: torch.Tensor  # (K,) bool


class DebugOutput(NamedTuple):
    """``cfg.debug``-gated intermediates (the JAX package's, field for
    field; reference debug publishers src/main.cpp:198-203)."""

    orig_points: torch.Tensor      # (N,3) filtered scan, sensor frame, pre-deskew
    orig_valid: torch.Tensor       # (N,)
    deskewed: torch.Tensor         # (N,3) deskewed full-res cloud, Xt2 frame
    deskewed_valid: torch.Tensor   # (N,)
    match_planes: torch.Tensor     # (Q,4) fitted plane [n, d] per pc2match point
    match_keep: torch.Tensor       # (Q,) final gate mask (these formed H)
    match_dist: torch.Tensor       # (Q,) signed point-to-plane distance at x⁺
    gersh_min: torch.Tensor        # () min Gershgorin bound on eig(HᵀH[:6,:6])
    min_eig: torch.Tensor          # () exact min eig of HᵀH[:6,:6] over iterations
    guard_fired: torch.Tensor      # () bool: the degeneracy guard zeroed directions
    n_stale: torch.Tensor          # () int32: window certificates failing at x⁺
    loop_fallback: torch.Tensor    # () bool: K6's certificates failed this scan


class ScanOutput(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    vel: torch.Tensor
    final_scan: torch.Tensor
    final_valid: torch.Tensor
    scan_body: torch.Tensor
    n_iters: torch.Tensor
    n_deskewed: torch.Tensor
    n_pc2match: torch.Tensor
    scan_stamp: torch.Tensor
    debug: object = None           # DebugOutput when cfg.debug, else None


def _take(arr, i):
    """arr[i] for a 0-dim device index, without a host sync."""
    return arr.index_select(0, i.reshape(1))[0]


def _mat(flat, device):
    return torch.tensor(np.array(flat, np.float64).reshape(3, 3),
                        dtype=torch.float32, device=device)


def init_state(cfg: Config, device="cuda") -> LIOState:
    device = dispatch.resolve_device(device)
    f32 = torch.float32
    x = st.identity(f32, gravity=cfg.gravity, device=device)
    R_l2b = _mat(cfg.extrinsics.lidar2baselink_R, device).T   # stored transposed
    x = x._replace(
        rot_LI=so3.mat_to_quat(R_l2b),
        t_LI=torch.tensor(cfg.extrinsics.lidar2baselink_t, dtype=f32, device=device),
        bg=torch.tensor(cfg.intrinsics.gyro_bias, dtype=f32, device=device),
        ba=torch.tensor(cfg.intrinsics.accel_bias, dtype=f32, device=device))
    zero = torch.zeros((), dtype=f32, device=device)
    return LIOState(
        x=x, P=iekf.init_P(f32, device),
        map=mapper.create(cfg.tpu.map_capacity, cfg.map_points_per_voxel, device),
        prev_scan_stamp=zero.clone(), last_prop_time=zero.clone(),
        last_w_raw_bl=torch.zeros(3, dtype=f32, device=device),
        last_w=torch.zeros(3, dtype=f32, device=device),
        last_a=torch.zeros(3, dtype=f32, device=device),
        bias_gyro_corr=x.bg.clone(), bias_accel_corr=x.ba.clone(),
        pinned_grav=x.grav.clone())


def build_scan_step(cfg: Config, device="cuda", split_body: bool = False,
                    spans: Spans = None, *, shard_axis: str = None, num_shards: int = 1,
                    query_axis: str = None, num_query_shards: int = 1, comm=None):
    """The per-scan step for a static config, on ``device``.  With
    ``split_body`` the update runs the per-iteration loop around the gain
    kernel K8 every scan (``iekf.update_iterated``) instead of K6/K5.  With
    ``cfg.debug`` the output carries a ``DebugOutput`` (one more re-match
    at the posterior and its host read); without it nothing of that runs.

    With ``shard_axis`` the step is one rank's of a sharded step
    (parallel/sharded.py; ``comm`` is the rank's handle): ``s.map`` is this
    rank's shard of ``num_shards`` (the blocks it owns, ``G`` of the
    ``G·num_shards`` global groups), the kNN merges over the axis, the
    insert keeps the owned points, and ``num_points`` stays the replicated
    global count (the psum of the shards' deltas).  ``query_axis``
    additionally splits the matching work over ``num_query_shards`` ranks
    (see models/measurement.py); everything else is replicated.  ``spans``:
    the recorder the stages are marked in and the update stage's graph
    counted in (module docstring; without one, a recorder of its own that
    is never switched on)."""
    device = dispatch.resolve_device(device)
    sp = Spans() if spans is None else spans
    mp_cfg = cfg.ikfom.mapping
    voxel_size = cfg.map_voxel_size
    k = mp_cfg.NUM_MATCH_POINTS
    n_pc2match = mp_cfg.MAX_NUM_PC2MATCH
    f32 = torch.float32
    R_imu2bl = _mat(cfg.extrinsics.imu2baselink_R, device).T
    t_imu2bl = torch.tensor(cfg.extrinsics.imu2baselink_t, dtype=f32, device=device)
    sm = _mat(cfg.intrinsics.imu_sm, device)
    Q = proc.process_noise_Q(cfg.ikfom.cov_gyro, cfg.ikfom.cov_acc,
                             cfg.ikfom.cov_bias_gyro, cfg.ikfom.cov_bias_acc,
                             f32, device)

    def update(m: mapper.VoxelHashMap, pc2match, pc2_valid, x_t2: st.NavState, P_t2):
        """The update stage as a function of tensors: (x_u, P_u, n_iters,
        need, do_update, debug); ``need`` is K6's fallback flag (None
        without a window pack), ``debug`` None unless ``cfg.debug``, then
        (the update's diagnostics, ``h_model.debug(x_u)``)."""
        h_model = measurement.make_h_model(
            m, pc2match, pc2_valid, voxel_size=voxel_size, k=k,
            max_dist_plane=mp_cfg.MAX_DIST_PLANE,
            plane_threshold=mp_cfg.PLANE_THRESHOLD,
            max_num_matches=mp_cfg.MAX_NUM_MATCHES,
            estimate_extrinsics=cfg.ikfom.estimate_extrinsics, x0=x_t2,
            dynamic_gate=mp_cfg.DYNAMIC_GATE, shard_axis=shard_axis, num_shards=num_shards,
            query_axis=query_axis, num_query_shards=num_query_shards, comm=comm)
        x_u, P_u, n_iters, need, udiag = iekf.update_core(
            x_t2, P_t2, h_model, R=cfg.ikfom.lidar_noise,
            D=cfg.ikfom.degeneracy_thresh, max_iters=cfg.ikfom.MAX_NUM_ITERS,
            limit=cfg.ikfom.LIMITS, split_body=split_body, with_diag=cfg.debug)

        # NULL ITERATION (Localizer.cpp:323,379-380): a select, not a branch
        do_update = torch.sum(pc2_valid) > 1
        x_u = st.where(do_update, x_u, x_t2)
        P_u = torch.where(do_update, P_u, P_t2)
        debug = (udiag, h_model.debug(x_u)) if cfg.debug else None
        return x_u, P_u, n_iters, need, do_update, debug

    def eager_reason():
        """Why the update cannot be captured, from what the step runs."""
        if split_body:
            return "split_body"       # the guard reads the device
        if shard_axis is not None or query_axis is not None or comm is not None:
            return "sharded"          # collectives between the kernels
        if cfg.debug:
            return "debug"            # h_model is read after the update
        return None

    run_update = graphs.StageGraph(update, sp.update_graph, eager_reason)

    def scan_step(s: LIOState, b: ScanBatch) -> Tuple[LIOState, ScanOutput]:
        if sp.live:
            sp.stage("step.predict")
        # ---- rebase carried times onto this scan's epoch ----
        s = s._replace(prev_scan_stamp=s.prev_scan_stamp - b.epoch_shift,
                       last_prop_time=s.last_prop_time - b.epoch_shift)

        # ---- IMU path ----
        acc_bl, gyro_bl, dt = preprocess.imu_to_baselink(
            b.imu_acc, b.imu_gyro, b.imu_stamp, s.last_prop_time, s.last_w_raw_bl,
            R_imu2bl=R_imu2bl, t_imu2bl=t_imu2bl)
        acc_c, gyro_c = preprocess.apply_intrinsics(
            acc_bl, gyro_bl, sm, s.bias_accel_corr, s.bias_gyro_corr)
        imu = {"acc": acc_c, "gyro": gyro_c, "dt": dt.to(f32),
               "stamp": b.imu_stamp, "valid": b.imu_valid}
        x_t2, P_t2, xs = iekf.predict_scan(s.x, s.P, imu, Q)

        n_imu = torch.sum(b.imu_valid)
        last_i = torch.clamp(n_imu - 1, min=0)
        has_imu = n_imu > 0

        if sp.live:
            sp.stage("step.preprocess")
        # ---- scan path: filters, optional time sort, offset ----
        imu_stamp_now = torch.where(has_imu, _take(b.imu_stamp, last_i), s.last_prop_time)
        pts, t_abs, pvalid, scan_end = preprocess.preprocess_scan(
            b.points, b.t_raw, b.valid, b.stamp, imu_stamp_now,
            sensor_type=cfg.sensor_type, end_of_sweep=cfg.end_of_sweep,
            crop_active=cfg.filters.crop_active,
            crop_min=cfg.filters.cropBoxMin, crop_max=cfg.filters.cropBoxMax,
            dist_active=cfg.filters.dist_active, min_dist=cfg.filters.min_dist,
            rate_active=cfg.filters.rate_active, rate_value=cfg.filters.rate_value,
            fov_active=cfg.filters.fov_active, fov_angle=cfg.filters.fov_angle,
            time_offset=cfg.time_offset, time_sort=cfg.tpu.time_sort)

        if sp.live:
            sp.stage("step.deskew")
        # ---- deskew into the Xt2 frame (K1) ----
        frames = dsk.frames_from_scan(s.x, s.last_prop_time, s.last_w, s.last_a, xs, imu)
        p_xt2, _p_world = dsk.deskew(pts, t_abs, pvalid, frames, x_t2,
                                     x_t2.rot_LI, x_t2.t_LI)

        if sp.live:
            sp.stage("step.voxel")
        # ---- voxel-grid downsample ----
        if cfg.filters.voxel_active:
            pc_ds, ds_valid = voxel.voxel_downsample(p_xt2, pvalid,
                                                     float(cfg.filters.leafSize[0]))
        else:
            pc_ds, ds_valid = p_xt2, pvalid
        if cfg.tpu.insert_population == "full" and cfg.tpu.max_insert_points:
            pc_ds = pc_ds[:cfg.tpu.max_insert_points]
            ds_valid = ds_valid[:cfg.tpu.max_insert_points]
        pc2match = pc_ds[:n_pc2match]
        pc2_valid = ds_valid[:n_pc2match]

        if sp.live:
            sp.stage("step.update")
        # ---- iterated manifold update (certified window re-match) ----
        x_u, P_u, n_iters, need, do_update, debug = run_update(
            s.map, pc2match, pc2_valid, x_t2, P_t2)
        if need is not None:
            iekf.counters.add_fallbacks(need)

        if sp.live:
            sp.stage("step.insert")
        # ---- register scan & grow the map (Mapper::add) ----
        if cfg.tpu.insert_population == "full":
            ins_pts, ins_valid = pc_ds, ds_valid
        else:
            ins_pts, ins_valid = pc2match, pc2_valid
        w_scan = so3.quat_rotate(x_u.rot, ins_pts) + x_u.pos
        new_map = mapper.insert(s.map, w_scan, ins_valid & do_update,
                                voxel_size=voxel_size, num_shards=num_shards,
                                shard_index=comm.axis_index(shard_axis) if shard_axis else 0)
        if shard_axis is not None:
            # keep num_points a replicated GLOBAL count (psum of shard deltas)
            delta = new_map.num_points - s.map.num_points
            new_map = new_map._replace(num_points=s.map.num_points + comm.psum(
                delta, shard_axis, "num_points_psum_bytes"))
        new_map = new_map._replace(last_time=scan_end.to(f32))

        bg_corr = s.bias_gyro_corr if cfg.calibrate_gyro else x_u.bg
        ba_corr = s.bias_accel_corr if cfg.calibrate_accel else x_u.ba

        def last_valid(arr, prev):
            return torch.where(has_imu, _take(arr, last_i), prev)

        s_next = LIOState(
            x=x_u, P=P_u, map=new_map, prev_scan_stamp=scan_end,
            last_prop_time=last_valid(b.imu_stamp, s.last_prop_time),
            last_w_raw_bl=last_valid(gyro_bl, s.last_w_raw_bl),
            last_w=last_valid(gyro_c, s.last_w),
            last_a=last_valid(acc_c, s.last_a),
            bias_gyro_corr=bg_corr, bias_accel_corr=ba_corr,
            pinned_grav=s.pinned_grav)
        out = ScanOutput(
            pos=x_u.pos, quat=x_u.rot, vel=x_u.vel,
            final_scan=w_scan, final_valid=ins_valid & do_update,
            scan_body=ins_pts, n_iters=n_iters, n_deskewed=torch.sum(pvalid),
            n_pc2match=torch.sum(pc2_valid), scan_stamp=scan_end)
        if debug is not None:
            udiag, (n_abcd, keep, dist, n_stale) = debug
            out = out._replace(debug=DebugOutput(
                orig_points=pts, orig_valid=pvalid,
                deskewed=p_xt2, deskewed_valid=pvalid,
                match_planes=n_abcd, match_keep=keep & do_update, match_dist=dist,
                gersh_min=udiag["gersh_min"], min_eig=udiag["min_eig"],
                guard_fired=udiag["guard_fired"] & do_update, n_stale=n_stale,
                loop_fallback=udiag["loop_fallback"] & do_update))
        if sp.live:
            sp.stage(None)
        return s_next, out

    return scan_step


def fuse_packs(scan_pack: np.ndarray, imu_pack: np.ndarray) -> np.ndarray:
    """The per-scan host arrays as ONE flat buffer (``build_scan_step_packed``):
    in int16 mode the f32 IMU rows are bit-cast onto int16 pairs (lossless;
    the step bit-casts them back), in f32 mode it is a plain concatenation."""
    if scan_pack.dtype == np.int16:
        out = np.empty(scan_pack.size + imu_pack.size * 2, np.int16)
        out[: scan_pack.size] = scan_pack.ravel()
        out[scan_pack.size:] = np.ascontiguousarray(imu_pack, np.float32).ravel().view(np.int16)
        return out
    out = np.empty(scan_pack.size + imu_pack.size, np.float32)
    out[: scan_pack.size] = scan_pack.ravel()
    out[scan_pack.size:] = imu_pack.astype(np.float32).ravel()
    return out


def _pack_reader(cfg: Config, device, min_k: int):
    """``read(scan_pack (N,4), imu_pack (K,8)) → ScanBatch``, the unpack of
    the packed layout (see ``build_scan_step_packed``).  A quantized
    payload dequantizes as the JAX step does: one float32 multiply by the
    float32 LSB (``quantize_transfer``) and by the per-scan ``aux[3]``."""
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch
    if K < min_k:
        raise ValueError(f"imu_batch must be >= {min_k} (the aux column carries "
                         f"{min_k} scalars), got {K}")
    quant = float(cfg.tpu.quantize_transfer)
    lsb = torch.tensor(quant, dtype=torch.float32, device=device)
    lanes_n = torch.arange(N, device=device)
    lanes_k = torch.arange(K, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def read(scan_pack, imu_pack) -> ScanBatch:
        scan_pack, imu_pack = scan_pack.reshape(N, 4), imu_pack.reshape(K, 8)
        if quant > 0:
            points = scan_pack[:, :3].to(torch.float32) * lsb
            t_raw = scan_pack[:, 3].to(torch.float32) * imu_pack[3, 7]
        else:
            points, t_raw = scan_pack[:, :3], scan_pack[:, 3]
        return ScanBatch(
            points=points, t_raw=t_raw, valid=lanes_n < imu_pack[0, 7].to(torch.int32),
            stamp=zero, epoch_shift=imu_pack[2, 7], imu_acc=imu_pack[:, 0:3],
            imu_gyro=imu_pack[:, 3:6], imu_stamp=imu_pack[:, 6],
            imu_valid=lanes_k < imu_pack[1, 7].to(torch.int32))

    return read


def build_scan_step_packed(cfg: Config, device="cuda", split_body: bool = False):
    """The step on ONE flat buffer (``fuse_packs``) of two sections:

    * ``scan_pack`` (N,4) — ``[x, y, z, t_raw]`` rows, zero-padded; float32,
      or with ``cfg.tpu.quantize_transfer > 0`` int16: xyz in units of
      ``quantize_transfer`` metres, t_raw in units of ``aux[3]``;
    * ``imu_pack`` (K,8) f32 — ``[acc(3), gyro(3), stamp, aux]`` rows; the
      ``aux`` column carries ``aux[0] = n_pts``, ``aux[1] = n_imu``,
      ``aux[2] = epoch_shift``, ``aux[3] = t_raw scale`` (and ``aux[4] =
      active`` for the chunk step); bit-cast onto int16 pairs in quantized
      mode.

    Same results as ``build_scan_step`` on the unpacked batch."""
    device = dispatch.resolve_device(device)
    inner = build_scan_step(cfg, device, split_body)
    read = _pack_reader(cfg, device, 4)
    n_scan = cfg.tpu.max_points_per_scan * 4
    quantized = float(cfg.tpu.quantize_transfer) > 0

    def packed_step(s: LIOState, pack):
        imu = pack[n_scan:]
        if quantized:
            imu = imu.contiguous().view(torch.float32)
        return inner(s, read(pack[:n_scan], imu))

    return packed_step


def build_scan_step_split(cfg: Config, device="cuda", split_body: bool = False,
                          spans: Spans = None):
    """The streaming step on TWO buffers: the scan payload (N,4) and the
    IMU pack (K,8) of ``build_scan_step_packed``.  The payload does not
    depend on IMU coverage, so the Localizer starts its copy to the device
    when the scan arrives, overlapping the scan in flight; only the small
    IMU pack waits for dispatch.  Same results as the packed step."""
    device = dispatch.resolve_device(device)
    inner = build_scan_step(cfg, device, split_body, spans)
    read = _pack_reader(cfg, device, 4)

    def split_step(s: LIOState, scan_pack, imu_pack):
        return inner(s, read(scan_pack, imu_pack))

    return split_step


def _select(cond, a, b):
    """``torch.where(cond, a, b)`` over matching (nested) NamedTuples."""
    if isinstance(a, tuple):
        return type(a)(*(_select(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond, a, b)


def _stack(outs):
    """Matching (nested) NamedTuples stacked leaf by leaf on a leading axis."""
    if outs[0] is None:
        return None
    if isinstance(outs[0], tuple):
        return type(outs[0])(*(_stack(f) for f in zip(*outs)))
    return torch.stack(outs)


def build_scan_chunk_step(cfg: Config, device="cuda", split_body: bool = False,
                          spans: Spans = None):
    """Chunked replay: C scans per call, ``scan_packs (C,N,4)`` and
    ``imu_packs (C,K,8)`` in the packed layout with ``aux[4] = active``.
    The elements run in order through the per-scan step; an inactive
    element (end-of-stream padding of a partial chunk) leaves the carried
    state exactly as it was (a select, no host sync).  Returns
    ``(LIOState', ScanOutput)`` with every output stacked on a leading
    chunk axis, ``n_pc2match = 0`` and ``final_valid`` False on padding."""
    device = dispatch.resolve_device(device)
    sp = Spans() if spans is None else spans
    inner = build_scan_step(cfg, device, split_body, sp)
    read = _pack_reader(cfg, device, 5)

    def chunk_step(s: LIOState, scan_packs, imu_packs):
        outs = []
        for i, (scan_pack, imu_pack) in enumerate(zip(scan_packs, imu_packs)):
            if sp.live:
                sp.element(i)
            active = imu_pack[4, 7] > 0
            s2, out = inner(s, read(scan_pack, imu_pack))
            s = _select(active, s2, s)
            outs.append(out._replace(
                n_pc2match=torch.where(active, out.n_pc2match, torch.zeros_like(out.n_pc2match)),
                final_valid=out.final_valid & active))
        return s, _stack(outs)

    return chunk_step


def build_prop_step(cfg: Config, device="cuda"):
    """IMU-only propagation of the carried state (the JAX prop step): used
    to fold an IMU backlog longer than ``imu_batch`` into the state and to
    answer the Localizer's IMU-rate state queries."""
    device = dispatch.resolve_device(device)
    f32 = torch.float32
    R_imu2bl = _mat(cfg.extrinsics.imu2baselink_R, device).T
    t_imu2bl = torch.tensor(cfg.extrinsics.imu2baselink_t, dtype=f32, device=device)
    sm = _mat(cfg.intrinsics.imu_sm, device)
    Q = proc.process_noise_Q(cfg.ikfom.cov_gyro, cfg.ikfom.cov_acc,
                             cfg.ikfom.cov_bias_gyro, cfg.ikfom.cov_bias_acc,
                             f32, device)

    def prop_step(x, P, last_prop_time, last_w_raw_bl, ba_corr, bg_corr,
                  acc, gyro, stamp, valid):
        acc_bl, gyro_bl, dt = preprocess.imu_to_baselink(
            acc, gyro, stamp, last_prop_time, last_w_raw_bl,
            R_imu2bl=R_imu2bl, t_imu2bl=t_imu2bl)
        acc_c, gyro_c = preprocess.apply_intrinsics(acc_bl, gyro_bl, sm, ba_corr, bg_corr)
        imu = {"acc": acc_c, "gyro": gyro_c, "dt": dt.to(f32), "stamp": stamp,
               "valid": valid}
        x2, P2, _xs = iekf.predict_scan(x, P, imu, Q)
        n = torch.sum(valid)
        last_i = torch.clamp(n - 1, min=0)
        has = n > 0
        return (x2, P2, torch.where(has, _take(stamp, last_i), last_prop_time),
                torch.where(has, _take(gyro_bl, last_i), last_w_raw_bl),
                _take(gyro_c, last_i), _take(acc_c, last_i))

    return prop_step
