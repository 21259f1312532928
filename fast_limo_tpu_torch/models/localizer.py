"""Host-side streaming orchestrator (port of fast_limo_tpu/models/localizer.py;
reference Modules/Localizer.hpp:138-201).

Buffers IMU samples, runs the stand-still IMU calibration
(Localizer.cpp:411-509), dispatches a scan once IMU coverage reaches its
end time (the reference's condition-variable rule, Localizer.cpp:878-915),
pads everything to static shapes and runs the per-scan step on the
device the Localizer was built for (the card unless the caller asks for
the CPU).  Absolute time stays on the host in float64; the device sees
float32 offsets from the current scan epoch.

Transfer: each scan rides the packed layout of
``pipeline.build_scan_step_packed`` — an (N,4) payload, int16 through the
native packer when ``tpu.quantize_transfer > 0`` (``io/native``), and a
(K,8) IMU pack carrying the per-scan scalars.  With ``tpu.scan_chunk == 1``
the payload is packed into pinned host memory and its copy to the card
started on a side stream the moment the scan arrives (it does not depend
on IMU coverage), so it overlaps the scan in flight; at dispatch the
compute stream waits on that copy's event and only the IMU pack is
copied (``build_scan_step_split``).  With ``scan_chunk = C > 1`` scans
are dispatched C at a time (``build_scan_chunk_step``, an offline replay
knob); ``flush()`` sends the partial chunk at the end of a stream.
``on_dispatch(scan_pack, imu_pack)``, when set, sees the exact host bytes
of every scan copied, on both paths, in dispatch order.  ``pose_ready`` is
the newest dispatch's event on the compute stream after its step: a caller
polls ``pose_ready.query()`` instead of waiting on a copy.

Tracing (``telemetry.trace(True)``, off by default; ``utils/telemetry``):
spans ``localizer.arrive`` (a scan's validation, point times, pack and
copy start) and ``localizer.dispatch`` (roots) with the children
``localizer.pack`` (IMU pack, its copy, ``on_dispatch``), ``step`` (the
step call, whose stages are spans ``step.*``: ``models/pipeline``) and
``localizer.finish`` (eviction, retention, telemetry); each dispatch's
``pose_ready`` and device allocations; ``telemetry.export()`` hands them out.
A sweep larger than the scan slots is stride-downsampled on the host inside
the span that packs its payload (``localizer.arrive``, or ``localizer.pack``
on the chunked path), in a child span ``localizer.downsample``, and counted
always (``telemetry.spans.downsample_scans`` and ``downsample_points_in``).

For long sessions: per-scan outputs are copied to the host in batches and
their device tensors released (``_bound_retention``); the map evicts far
voxels on a 16-scan cadence once ``evict_radius`` is set
(``_maybe_evict``); ``save_checkpoint``/``load_checkpoint`` persist and
resume the whole state in the JAX package's format; the state queries
(``get_world_state`` and friends) are fresh at IMU rate.  ``board()``
renders the telemetry board (``utils/telemetry``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fast_limo_tpu_torch.io import native
from fast_limo_tpu_torch.models import mapper
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import preprocess
from fast_limo_tpu_torch.ops import dispatch, so3
from fast_limo_tpu_torch.utils import checkpoint as ckpt
from fast_limo_tpu_torch.utils import validation
from fast_limo_tpu_torch.utils.config import Config
from fast_limo_tpu_torch.utils.telemetry import Telemetry

_OUT_FIELDS = ("scan_stamp", "pos", "quat", "vel", "n_iters", "n_pc2match")


@dataclass
class _PendingScan:
    stamp: float
    points: np.ndarray
    t_raw: np.ndarray
    last_pt_time: float
    # split transfer (scan_chunk == 1): packed, and its copy to the device
    # started, at arrival
    scan_buf: Optional[torch.Tensor] = None   # (N,4) int16/f32 on the device
    t_scale: float = 1.0
    npts: int = 0
    host_buf: Optional[np.ndarray] = None     # the bytes copied (pinned on CUDA)
    copied: Optional[torch.cuda.Event] = None  # end of the copy (CUDA only)


class Localizer:
    def __init__(self, cfg: Config, device="cuda", split_body: bool = False):
        """``split_body``: run every scan's update as the per-iteration loop
        around the gain kernel K8 (``iekf.update_iterated``) instead of the
        fused kernels K6/K5 — the witness configuration."""
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.telemetry = Telemetry(device=self.device if self.device.type == "cuda" else None)
        self.chunk = max(1, int(cfg.tpu.scan_chunk))
        build = pl.build_scan_chunk_step if self.chunk > 1 else pl.build_scan_step_split
        self.scan_step = build(cfg, self.device, split_body, spans=self.telemetry.spans)
        self.pose_ready = None             # the newest dispatch's pose event
        # Capture hook: called as on_dispatch(scan_pack (N,4), imu_pack (K,8))
        # with the exact host bytes copied for every scan, in dispatch
        # order, on both paths.  Consumers copy what they keep.
        self.on_dispatch = None
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._prop_step = None
        self._prop_cache: Optional[tuple] = None        # (key, (x, P, abs_t))
        self.state: Optional[pl.LIOState] = None
        self.epoch: Optional[float] = None

        self._imu_queue: deque = deque()
        self._scan_queue: deque = deque()
        self._newest_imu_stamp: float = -np.inf
        self._last_consumed_stamp: float = -np.inf     # host mirror of last_prop_time
        self._imu_period_est: float = 1.0 / 200.0

        self.imu_calibrated = not (cfg.gravity_align or cfg.calibrate_accel
                                   or cfg.calibrate_gyro)
        self._first_imu_stamp: Optional[float] = None
        self._calib_gyro_sum = np.zeros(3)
        self._calib_accel_sum = np.zeros(3)
        self._calib_n = 0
        self.init_quat = np.array([1.0, 0, 0, 0])
        self.init_bg = np.asarray(cfg.intrinsics.gyro_bias, float)
        self.init_ba = np.asarray(cfg.intrinsics.accel_bias, float)
        self._R_imu2bl = np.array(cfg.extrinsics.imu2baselink_R, float).reshape(3, 3).T

        # (epoch, ScanOutput on device | None once copied); a chunked
        # dispatch is one entry (tuple of epochs, outputs stacked on a chunk axis)
        self._raw_outputs: List[tuple] = []
        self._materialized: List[dict] = []
        self._materialized_entries = 0
        self.last_output = None            # the last dispatch's ScanOutput (device)
        self.last_output_scans = 0         # active scans in last_output
        self._structure_checked = False

        # rolling-origin eviction for a bounded map: when the map fills past
        # evict_occupancy, voxels beyond evict_radius are freed (0 disables)
        self.evict_radius: float = 0.0
        self.evict_occupancy: float = 0.7
        self._scans_since_evict = 0
        self._evict_probe = None           # lagged copy of the map's point count

    # ------------------------------------------------------------------ IMU
    def update_imu(self, stamp: float, acc, gyro) -> None:
        acc = np.asarray(acc, float)
        gyro = np.asarray(gyro, float)
        self.telemetry.imu_tick(stamp)
        if self._first_imu_stamp is None:
            self._first_imu_stamp = stamp
        if self._newest_imu_stamp > -np.inf:
            dtp = stamp - self._newest_imu_stamp
            if 0 < dtp < 0.1:
                self._imu_period_est = dtp
        self._newest_imu_stamp = stamp
        if not self.imu_calibrated:
            if (stamp - self._first_imu_stamp) < self.cfg.imu_calib_time:
                self._calib_gyro_sum += self._R_imu2bl @ gyro
                self._calib_accel_sum += self._R_imu2bl @ acc
                self._calib_n += 1
                return
            self._finish_calibration()
        self._imu_queue.append((stamp, acc, gyro))
        self._drain()

    def _finish_calibration(self) -> None:
        """Gravity alignment & bias averaging (Localizer.cpp:437-509)."""
        n = max(self._calib_n, 1)
        gyro_avg = self._calib_gyro_sum / n
        accel_avg = self._calib_accel_sum / n
        grav_vec = np.array([0.0, 0.0, self.cfg.gravity])
        if self.cfg.gravity_align:
            gv = accel_avg - self.init_ba
            grav_vec = gv / np.linalg.norm(gv) * abs(self.cfg.gravity)
            a, b = grav_vec, np.array([0.0, 0.0, self.cfg.gravity])
            q = np.concatenate([[np.linalg.norm(a) * np.linalg.norm(b) + a @ b],
                                np.cross(a, b)])
            self.init_quat = q / np.linalg.norm(q)
        if self.cfg.calibrate_accel:
            self.init_ba = accel_avg - grav_vec
        if self.cfg.calibrate_gyro:
            self.init_bg = gyro_avg
        self.imu_calibrated = True

    # ------------------------------------------------------------------ scan
    def update_pointcloud(self, points, t_raw, stamp: float) -> None:
        """Queue a scan; dispatched once IMU coverage reaches its end time."""
        if not self.imu_calibrated:
            return
        sp = self.telemetry.spans
        sp.root("localizer.arrive", len(self._raw_outputs) + len(self._scan_queue) // self.chunk,
                stamp)
        if not self._structure_checked:  # once, like ROSutils.hpp:152 static
            validation.check_pointcloud(points, t_raw, self.cfg.sensor_type, stamp)
            self._structure_checked = True
        points = np.ascontiguousarray(points, np.float32)
        t64 = np.asarray(t_raw, np.float64)
        t_abs = preprocess.extract_point_times(
            t64, stamp, self.cfg.sensor_type, self.cfg.end_of_sweep)
        last_pt = float(np.max(t_abs)) if len(t_abs) else stamp
        # absolute-time sensors are rebased to the epoch in f64 first
        if self.cfg.sensor_type == preprocess.HESAI:
            t64 = t64 - stamp
        elif self.cfg.sensor_type == preprocess.LIVOX:
            t64 = t64 - stamp * 1e9
        scan = _PendingScan(stamp, points, np.ascontiguousarray(t64, np.float32), last_pt)
        if self.chunk == 1:
            self._stage(scan)
        self._scan_queue.append(scan)
        if sp.live:
            sp.close()
        self._drain()

    def _drain(self) -> None:
        while self._scan_queue:
            scan = self._scan_queue[0]
            if self._newest_imu_stamp < scan.last_pt_time:
                return
            if self.chunk > 1:
                # a chunk goes out once all C of its scans are covered;
                # flush() sends the partial one at the end of a stream
                if (len(self._scan_queue) < self.chunk or self._newest_imu_stamp
                        < self._scan_queue[self.chunk - 1].last_pt_time):
                    return
                self._dispatch_chunk([self._scan_queue.popleft() for _ in range(self.chunk)])
                continue
            self._scan_queue.popleft()
            self._dispatch(scan)

    def flush(self) -> None:
        """Dispatch the covered scans still waiting for a full chunk (end of
        stream); a no-op with ``scan_chunk == 1``."""
        while self._scan_queue and self.chunk > 1:
            scans = []
            while (self._scan_queue and len(scans) < self.chunk
                   and self._newest_imu_stamp >= self._scan_queue[0].last_pt_time):
                scans.append(self._scan_queue.popleft())
            if not scans:
                return
            self._dispatch_chunk(scans)

    def _pack_points(self, scan: _PendingScan):
        """The scan payload of the pack (no IMU or epoch dependency):
        ((N,4) rows [x, y, z, t_raw], zero-padded, float32 — or int16 in
        units of ``quantize_transfer`` and of ``t_scale`` —, t_scale, npts)."""
        N = self.cfg.tpu.max_points_per_scan
        npts = len(scan.points)
        if npts > N:   # uniform stride-downsample overflowing scans
            sp = self.telemetry.spans
            sp.downsample_scans += 1
            sp.downsample_points_in += npts
            if sp.live:
                sp.open("localizer.downsample")
            sel = np.linspace(0, npts - 1, N).astype(np.int64)
            pts, traw, npts = scan.points[sel], scan.t_raw[sel], N
            if sp.live:
                sp.close()
        else:
            pts, traw = scan.points, scan.t_raw
        quant = float(self.cfg.tpu.quantize_transfer)
        if quant > 0:
            pts = np.ascontiguousarray(pts, np.float32)
            traw = np.ascontiguousarray(traw, np.float32)
            pack, t_scale, _n = native.pack_scan_i16(pts, traw, N, quant)
            return pack, t_scale, npts
        pack = np.zeros((N, 4), np.float32)
        pack[:npts, :3] = pts
        pack[:npts, 3] = traw
        return pack, 1.0, npts

    def _pack_imu(self, scan: _PendingScan, t_scale: float, npts: int):
        """The IMU half of the pack: the batch up to (incl.) the first
        sample ≥ scan end, as (K,8) rows [acc, gyro, stamp, aux] with aux =
        (npts, n_imu, epoch_shift, t_scale, active).  Consumes the IMU queue
        and advances the epoch, so it runs in dispatch order."""
        batch = []
        while self._imu_queue:
            batch.append(self._imu_queue.popleft())
            if batch[-1][0] >= scan.last_pt_time:
                break
        if batch:
            self._last_consumed_stamp = batch[-1][0]
        K = self.cfg.tpu.imu_batch
        if len(batch) > K:
            # fold the oldest samples into the carried state (predict only)
            overflow, batch = batch[:-K], batch[-K:]
            self._consume_imu_overflow(overflow)
        epoch_shift = 0.0 if self.epoch is None else scan.stamp - self.epoch
        self.epoch = scan.stamp
        pack = np.zeros((K, 8), np.float32)
        for i, (s, a, g) in enumerate(batch):
            pack[i, 0:3] = a
            pack[i, 3:6] = g
            pack[i, 6] = s - scan.stamp
        pack[0:5, 7] = (npts, len(batch), epoch_shift, t_scale, 1.0)
        return pack

    def _pack_scan(self, scan: _PendingScan):
        """(scan_pack (N,4), imu_pack (K,8)) of one scan packed at once (the
        chunked path; the one-scan path packs the payload at arrival and
        the IMU half at dispatch); advances the queues and the epoch."""
        scan_pack, t_scale, npts = self._pack_points(scan)
        return scan_pack, self._pack_imu(scan, t_scale, npts)

    def _stage(self, scan: _PendingScan) -> None:
        """Pack the scan's payload and start its copy to the device (the
        pinned buffer's lifetime: see ``_to_device``)."""
        pack, scan.t_scale, scan.npts = self._pack_points(scan)
        if self._copy_stream is None:
            scan.scan_buf, scan.host_buf = torch.from_numpy(pack).to(self.device), pack
            return
        pinned = torch.from_numpy(pack).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            scan.scan_buf = torch.empty(pinned.shape, dtype=pinned.dtype, device=self.device)
            scan.scan_buf.copy_(pinned, non_blocking=True)
            scan.copied = torch.cuda.Event()
            scan.copied.record(self._copy_stream)
        scan.host_buf = pinned.numpy()

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """Copy a host array to the device on the compute stream, without
        waiting for the work queued there (from pinned memory on CUDA).

        A pinned buffer may be dropped as soon as its copy is queued: PyTorch's
        caching host allocator records an event on the stream of every
        non-blocking copy from a ``pin_memory()`` block and does not reuse the
        block before that event has completed."""
        t = torch.from_numpy(host)
        if self._copy_stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _imu_tensors(self, rows, n):
        r = self._to_device(rows)
        return r[:, 0:3], r[:, 3:6], r[:, 6], torch.arange(rows.shape[0], device=self.device) < n

    def _imu_chunks(self, samples):
        """(acc, gyro, stamp, valid) tensors per imu_batch-sized chunk of
        samples, stamps relative to the current epoch."""
        K = self.cfg.tpu.imu_batch
        for i0 in range(0, len(samples), K):
            chunk = samples[i0:i0 + K]
            rows = np.zeros((K, 7), np.float32)
            for i, (ts, a, g) in enumerate(chunk):
                rows[i, 0:3] = a
                rows[i, 3:6] = g
                rows[i, 6] = ts - self.epoch
            yield self._imu_tensors(rows, len(chunk))

    def _prop(self):
        if self._prop_step is None:
            self._prop_step = pl.build_prop_step(self.cfg, self.device)
        return self._prop_step

    def _consume_imu_overflow(self, samples) -> None:
        if not samples:
            return
        s = self.state
        x, P, t_rel, w_raw = s.x, s.P, s.last_prop_time, s.last_w_raw_bl
        wc, ac = s.last_w, s.last_a
        for acc, gyro, stamp, valid in self._imu_chunks(samples):
            x, P, t_rel, w_raw, wc, ac = self._prop()(
                x, P, t_rel, w_raw, s.bias_accel_corr, s.bias_gyro_corr,
                acc, gyro, stamp, valid)
        self.state = s._replace(x=x, P=P, last_prop_time=t_rel,
                                last_w_raw_bl=w_raw, last_w=wc, last_a=ac)
        self._last_consumed_stamp = samples[-1][0]
        self._prop_cache = None

    def _begin_dispatch(self, first_stamp: float) -> None:
        if self.state is None:
            self._init_device_state(first_stamp)
        elif self.epoch is None:
            self._anchor_epoch(first_stamp)

    def _step(self, sp, *packs):
        """The step call (span ``step``) and the dispatch's ``pose_ready``."""
        if sp.live:
            sp.close()
            sp.open("step")
        self.telemetry.scan_begin()
        self.state, out = self.scan_step(self.state, *packs)
        if sp.live:
            sp.close()
        self.pose_ready = sp.pose_event()
        if sp.live:
            sp.open("localizer.finish")
        return out

    def _finish_dispatch(self, out, scans: List[_PendingScan], epoch) -> None:
        """Eviction, telemetry and the output entry (``epoch``: a tuple of
        epochs for a chunked dispatch); ends the dispatch's spans."""
        self._maybe_evict(out.pos if self.chunk == 1 else out.pos[len(scans) - 1])
        for scan in scans:
            self.telemetry.scan_end(scan.stamp)
        self.last_output, self.last_output_scans = out, len(scans)
        self._raw_outputs.append((epoch, out))
        self._bound_retention()
        sp = self.telemetry.spans
        if sp.live:
            sp.close()          # localizer.finish
            sp.close()          # localizer.dispatch
        if sp.on:
            sp.dispatched(len(self._raw_outputs) - 1, scans[0].stamp, self.pose_ready)

    def _dispatch(self, scan: _PendingScan) -> None:
        """One scan through the split step; its payload has been copying
        since it arrived."""
        sp = self.telemetry.spans
        live = sp.root("localizer.dispatch", len(self._raw_outputs), scan.stamp)
        self._begin_dispatch(scan.stamp)
        if live:
            sp.open("localizer.pack")
        imu_pack = self._pack_imu(scan, scan.t_scale, scan.npts)
        if self.on_dispatch is not None:
            self.on_dispatch(scan.host_buf, imu_pack)
        if scan.copied is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(scan.copied)
            scan.scan_buf.record_stream(compute)
        out = self._step(sp, scan.scan_buf, self._to_device(imu_pack))
        self._finish_dispatch(out, [scan], self.epoch)

    def _dispatch_chunk(self, scans: List[_PendingScan]) -> None:
        """Up to C scans through the chunk step, padded to C with inactive
        elements."""
        sp = self.telemetry.spans
        live = sp.root("localizer.dispatch", len(self._raw_outputs), scans[0].stamp,
                       [scan.stamp for scan in scans])
        self._begin_dispatch(scans[0].stamp)
        if live:
            sp.open("localizer.pack")
        C, N, K = self.chunk, self.cfg.tpu.max_points_per_scan, self.cfg.tpu.imu_batch
        sdtype = np.int16 if self.cfg.tpu.quantize_transfer > 0 else np.float32
        scan_packs = np.zeros((C, N, 4), sdtype)
        imu_packs = np.zeros((C, K, 8), np.float32)
        epochs = []
        for i, scan in enumerate(scans):
            scan_packs[i], imu_packs[i] = self._pack_scan(scan)
            epochs.append(self.epoch)
            if self.on_dispatch is not None:
                self.on_dispatch(scan_packs[i], imu_packs[i])
        out = self._step(sp, self._to_device(scan_packs), self._to_device(imu_packs))
        self._finish_dispatch(out, scans, tuple(epochs))

    def _bound_retention(self) -> None:
        """Bound the outputs held on the device: scans more than 64 back
        are long computed, so copying them to the host does not stall."""
        if len(self._raw_outputs) - self._materialized_entries > 64:
            self._materialize_upto(len(self._raw_outputs) - 32)

    def _count_probe(self):
        """A copy of the map's point count that a later cadence mark reads
        without waiting for the scans queued after it: on the card, an
        asynchronous copy into pinned host memory and the event it ends at."""
        n = self.state.map.num_points
        if not n.is_cuda:
            return n.clone(), None
        host = torch.empty((), dtype=n.dtype, pin_memory=True)
        host.copy_(n, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _maybe_evict(self, pos) -> None:
        """Rolling-origin map eviction for long sequences.

        Every 16 scans, the occupancy probe taken at the previous cadence
        mark is read (long computed, so no stall on the scan just
        dispatched; the decision lags one cadence, ~1.6 s, which
        ``evict_occupancy`` leaves headroom for); past ``evict_occupancy``
        of the capacity, voxels beyond ``evict_radius`` of ``pos`` are freed."""
        if self.evict_radius <= 0:
            return
        self._scans_since_evict += 1
        if self._scans_since_evict < 16:
            return
        self._scans_since_evict = 0
        probe, self._evict_probe = self._evict_probe, self._count_probe()
        if probe is None:
            return
        count, done = probe
        if done is not None:
            done.synchronize()
        cap = self.cfg.tpu.map_capacity * self.cfg.map_points_per_voxel
        if int(count) < self.evict_occupancy * cap:
            return
        self.state = self.state._replace(map=mapper.evict_far(
            self.state.map, pos, self.evict_radius, voxel_size=self.cfg.map_voxel_size))
        self.telemetry.spans.evictions += 1
        # the probe just taken predates the eviction: the next mark probes anew
        self._evict_probe = None

    def _init_device_state(self, first_stamp: float) -> None:
        s = pl.init_state(self.cfg, self.device)
        f32, d = torch.float32, self.device
        x = s.x._replace(rot=torch.tensor(self.init_quat, dtype=f32, device=d),
                         bg=torch.tensor(self.init_bg, dtype=f32, device=d),
                         ba=torch.tensor(self.init_ba, dtype=f32, device=d))
        prev_time = (self._imu_queue[0][0] - first_stamp - self._imu_period_est
                     if self._imu_queue else -self._imu_period_est)
        self.state = s._replace(
            x=x, last_prop_time=torch.tensor(np.float32(prev_time), device=d),
            bias_gyro_corr=x.bg.clone(), bias_accel_corr=x.ba.clone(),
            pinned_grav=x.grav.clone())
        self.epoch = first_stamp

    def _anchor_epoch(self, first_stamp: float) -> None:
        """Re-anchor the epoch for a state loaded with a fresh clock."""
        prev_time = (self._imu_queue[0][0] - first_stamp - self._imu_period_est
                     if self._imu_queue else -self._imu_period_est)
        self.state = self.state._replace(
            last_prop_time=torch.tensor(np.float32(prev_time), device=self.device))
        self.epoch = first_stamp

    # ---------------------------------------------------------------- query
    def _materialize_upto(self, n: int) -> None:
        """Copy outputs [materialized, n) to host dicts in one batched
        transfer a field and release their device tensors (a chunked entry
        gives one dict per active scan)."""
        start = self._materialized_entries
        if start >= n:
            return
        pend = self._raw_outputs[start:n]
        epochs = [e if isinstance(e, tuple) else (e,) for e, _ in pend]
        # one row a scan: pos is (3,), or (C,3) for a chunked entry
        host = [torch.cat([getattr(o, f).to(torch.float64).reshape(o.pos.numel() // 3, -1)[:len(ep)]
                           for ep, (_, o) in zip(epochs, pend)]).cpu().numpy()
                for f in _OUT_FIELDS]
        i = 0
        for ep in epochs:
            for epoch in ep:
                self._materialized.append({
                    "stamp": epoch + float(host[0][i, 0]),
                    "pos": host[1][i], "quat": host[2][i], "vel": host[3][i],
                    "n_iters": int(host[4][i, 0]), "n_pc2match": int(host[5][i, 0])})
                i += 1
        for j in range(start, n):
            self._raw_outputs[j] = (self._raw_outputs[j][0], None)
        self._materialized_entries = n

    @property
    def trajectory(self) -> List[dict]:
        """Per-scan outputs as host dicts (materialized on first access)."""
        self._materialize_upto(len(self._raw_outputs))
        return self._materialized

    def positions(self) -> np.ndarray:
        return np.array([t["pos"] for t in self.trajectory])

    def stamps(self) -> np.ndarray:
        return np.array([t["stamp"] for t in self.trajectory])

    def _propagated(self):
        """(x, P, abs_time) propagated through every IMU sample received
        since the last scan dispatch — the IMU-rate odometry state the
        reference publishes per tick (Localizer.cpp:401-531).  A pure read:
        the queued samples stay queued for the next scan step.  None when
        nothing is fresher than the carried state; cached per new data."""
        if self.state is None or self.epoch is None or not self._imu_queue:
            return None
        key = (len(self._raw_outputs), len(self._imu_queue), self._newest_imu_stamp)
        if self._prop_cache is not None and self._prop_cache[0] == key:
            return self._prop_cache[1]
        pend = [p for p in self._imu_queue if p[0] > self._last_consumed_stamp]
        if not pend:
            return None
        s = self.state
        x, P, t_rel, w_raw = s.x, s.P, s.last_prop_time, s.last_w_raw_bl
        for acc, gyro, stamp, valid in self._imu_chunks(pend):
            x, P, t_rel, w_raw, _wc, _ac = self._prop()(
                x, P, t_rel, w_raw, s.bias_accel_corr, s.bias_gyro_corr,
                acc, gyro, stamp, valid)
        result = (x, P, self.epoch + float(t_rel))
        self._prop_cache = (key, result)
        return result

    def _query_xP(self):
        """(x, P, abs_time) — IMU-rate fresh when post-scan samples exist."""
        prop = self._propagated()
        if prop is not None:
            return prop
        return (self.state.x, self.state.P,
                (self.epoch or 0.0) + float(self.state.last_prop_time))

    @staticmethod
    def _np(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    def get_world_state(self) -> dict:
        """World-frame state (getWorldState, Localizer.cpp:175-189), velocity
        in the body frame like the reference; fresh at IMU rate."""
        if self.state is None:
            return {}
        x, _P, t = self._query_xP()
        v_body = so3.quat_rotate(so3.quat_conj(x.rot), x.vel)
        return {"pos": self._np(x.pos), "quat": self._np(x.rot),
                "vel_body": self._np(v_body), "bg": self._np(x.bg),
                "ba": self._np(x.ba), "grav": self._np(x.grav), "time": t}

    def get_body_state(self) -> dict:
        """Body (LiDAR) frame state (getBodyState, Localizer.cpp:158-173):
        the pose composed with the estimated extrinsics."""
        out = self.get_world_state()
        if not out:
            return out
        x, _P, _t = self._query_xP()
        out["pos"] = self._np(x.pos + x.t_LI)
        out["quat"] = self._np(so3.quat_mul(x.rot, x.rot_LI))
        return out

    def get_pose_covariance(self) -> np.ndarray:
        """6×6 pose covariance, position first like ROS odometry
        (getPoseCovariance, Localizer.cpp:209-224)."""
        if self.state is None:
            return np.zeros((6, 6))
        return self._np(self._query_xP()[1])[0:6, 0:6].astype(np.float64)

    def get_twist_covariance(self) -> np.ndarray:
        """6×6 twist covariance (getTwistCovariance, Localizer.cpp:226-239):
        linear block from the filter, angular block the gyro noise."""
        if self.state is None:
            return np.zeros((6, 6))
        P = self._np(self._query_xP()[1])
        out = np.zeros((6, 6))
        out[0:3, 0:3] = P[12:15, 12:15]
        out[3:6, 3:6] = np.eye(3) * self.cfg.ikfom.cov_gyro
        return out

    def board(self) -> str:
        """The telemetry board with the newest pose, biases and map size."""
        info = {}
        if self.trajectory:
            t = self.trajectory[-1]
            info = {"pos": t["pos"], "quat": t["quat"], "vel": t["vel"],
                    "n_pc2match": t["n_pc2match"]}
        if self.state is not None:
            x = self.state.x
            info.update(bg=self._np(x.bg), ba=self._np(x.ba), grav=self._np(x.grav),
                        map_points=int(self.state.map.num_points))
        return self.telemetry.board(info)

    # ---------------------------------------------------------- persistence
    def save_checkpoint(self, path: str) -> None:
        """Persist the full SLAM state (filter + map + carries)."""
        if self.state is None:
            raise RuntimeError("nothing to checkpoint yet")
        ckpt.save_state(path, self.state, extra={
            "map_layout": mapper.layout_version(self.cfg.map_points_per_voxel),
            "epoch": self.epoch,
            "imu_calibrated": self.imu_calibrated,
            "init_bg": self.init_bg.tolist(),
            "init_ba": self.init_ba.tolist(),
            "init_quat": self.init_quat.tolist(),
        })

    def load_checkpoint(self, path: str, reset_clock: bool = False) -> None:
        """Resume from a checkpoint (of either package).  A map-layout stamp
        that differs from this build's raises; the planar mirror is always
        rebuilt from the entry-major table.  ``reset_clock=True`` for a new
        session whose timestamps are unrelated to the saved ones."""
        template = self.state if self.state is not None else pl.init_state(self.cfg, self.device)
        extra = ckpt.load_extra(path)
        want = mapper.layout_version(self.cfg.map_points_per_voxel)
        got = extra.get("map_layout")
        if got is not None and got != want:
            raise ValueError(
                f"checkpoint map layout {got!r} != current {want!r} — "
                "this checkpoint was written by an incompatible table layout")
        state = ckpt.load_state(path, template)
        m = state.map
        self.state = state._replace(map=m._replace(ptable=mapper._planarize(m.table, m.bucket)))
        self.epoch = extra.get("epoch")
        self.imu_calibrated = bool(extra.get("imu_calibrated", True))
        self.init_bg = np.asarray(extra.get("init_bg", self.init_bg))
        self.init_ba = np.asarray(extra.get("init_ba", self.init_ba))
        self.init_quat = np.asarray(extra.get("init_quat", self.init_quat))
        self._prop_cache = None
        if reset_clock:
            self.reset_clock()

    def reset_clock(self) -> None:
        """Restart the time base (new session): the epoch re-anchors on the
        next scan; device time carries and sensor queues are cleared."""
        self.epoch = None
        self._imu_queue.clear()
        self._scan_queue.clear()
        self._newest_imu_stamp = -np.inf
        self._last_consumed_stamp = -np.inf
        self._prop_cache = None
        self._first_imu_stamp = None
        if self.state is not None:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            self.state = self.state._replace(prev_scan_stamp=zero, last_prop_time=zero.clone())
