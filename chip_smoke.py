#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fast_limo_tpu_torch) once on one NVIDIA GPU.

Phases (each prints its own lines):

1. device   — require a CUDA device; print the card's name and power limit.
2. build    — compile the Hopper kernels (csrc/*.cu, sm_90a) from the
              sources in this checkout into build/fast_limo_tpu_torch/.
3. main     — a Localizer at the bench's own configuration
              (utils/presets.kitti_like_cfg = bench.py:59-105: 32768-point
              scans, 2^17-entry map, 10000 pc2match points, 3 iterations,
              window W = 12, int16 split transfer, one scan a dispatch)
              replays the synthetic bench corridor through update_imu /
              update_pointcloud.  Prints the ATE against ground truth (must
              be < 0.15 m), per-scan wall ms p50/p95 after warm-up, the
              launch count of every kernel (K1, K2, K6 and
              the exact loop's K3/K4/K5, which launch on every scan behind
              their active flag, must be > 0; K3 exactly once an evaluation,
              through fit_planes_select, the re-match's three branches in
              one launch; K2 exactly once a scan for the window resolve and
              once an evaluation through its select entry, the re-match's
              patch or full resolve in one launch; K9 exactly twice a scan: the
              voxel and the insert sort), the loop-fallback count (read
              from the device after the replay) and the host-read count
              (must be 0); every steady scan runs under
              torch.cuda.set_sync_debug_mode("warn") and each synchronizing
              call is named by the innermost port (fast_limo_tpu_torch/)
              frame on its stack: none may be named.
4. fallback — the exact per-iteration update loop (the path selected on
              the device when the whole-loop kernel's certificates fail) on
              one captured scan at main-path shapes with no active flag:
              K2 (k=5) and K3 (once an evaluation each), K4, K5 must launch; its
              x/P are compared with the whole-loop kernel's on that scan.
5. kernels  — every kernel's public wrapper against its plain PyTorch
              version on the card, on inputs captured from phases 3-4 and,
              for K8, from phase 8, which therefore runs before this one
              (K1 on the frame sources the scan step passed, its plain
              version on the table and scalars built in plain torch, ONE
              CUDA kernel a call; K2 on the captured window resolve, its plain version the
              gather of the map rows, then the plain top-k, bit for bit and
              ONE CUDA kernel a call, with the device time of each of its
              schedules; K2's select entry at branch codes 0/1/2 and under a
              clear flag, the taken branch bit for bit, ONE CUDA kernel a
              call; K3's one-set
              entry on the captured scan's window set, and its select
              entry on the window, a real stale patch and a real full
              re-match at each branch code: bit for bit the torch.where
              merge of three one-set launches, ONE CUDA kernel a call;
              K5, K6 and K8 bit for bit to their records in tests/data;
              K9 on the captured voxel sort, N = 32768, and insert sort,
              N = 10000: all three outputs bit-equal, ONE CUDA kernel a
              call (every such count is read from a CUDA graph captured of
              one call, or from torch.profiler where a call does not
              capture), both one-call yardsticks —
              torch.sort of the int32 key with its indices, and of the int64
              key (k1 << 30) | k2 — timed at both shapes; K8 against its
              plain version gain_math, rtol 1e-3 + 1e-3 of the largest
              entry, and against float64 truth within 12× the float32
              library solve's error + 2e-5 of the largest entry, the rule
              of tests/test_gain.py; K4 and K6 must run ONE CUDA kernel a
              call and give the same bits on two launches; the K4, K5, K6
              and K8 wrappers must not synchronize the host, under
              torch.cuda.set_sync_debug_mode("warn")):
              each launches once, agrees elementwise within the stated
              tolerances, and both times are taken (CUDA events through
              the wrapper, median), with the kernel's own device time
              (torch.profiler, matched by kernel name), the bound (bytes
              over HBM rate or operations over the float32 rate,
              whichever is larger) and, where one PyTorch call computes
              the same function, that call's event and device times.
6. map      — the long-session surface at the same configuration:
              (a) radius_search on the main replay's final map, 10 000
                  queries at four settings (K2 with V = 8, V = 27, k = 64;
                  K7's table entry at r = 3 m), 256 of them held to a brute
                  force over the stored points; K2 must launch, and the
                  3 m call must launch K7's table entry exactly once,
                  no dense K7 and no candidate decode (cands_from_rows);
                  that call's wall (p50 of 7, min, max) and device time
                  (the sum of its CUDA ops, K7's part);
                  K2 at the 1.08 m and 2.28 m / 16 calls' inputs in each of
                  its schedules, bit for bit, with their device times;
              (b) K7's table entry on the 3 m call's inputs, the dense K7
                  on its first 381 queries decoded explicitly (gather +
                  cands_from_rows), and K2 at k = 64, against their plain
                  versions (K7: sq, valid and nbrs bit-equal, invalid tail
                  included; K2 likewise, ONE CUDA kernel a call), with
                  times: their kernel rows;
              (c) an eviction replay (40 scans, evict_radius 30 m,
                  evict_occupancy 0.002): an eviction must drop the map's
                  point count, ATE < 0.15 m;
              (d) checkpoint/resume: a replay saved half-way and resumed
                  in a fresh Localizer(cfg) must retrace the rest within
                  1e-5 m.
7. transfer — the same scans through the bench's other streaming entry
              points: (a) chunked replay (scan_chunk = 4, flush()), poses
              within the JAX package's chunk bounds of phase 3's (pos 3e-4,
              quat 3e-5, n_pc2match equal), every chunk after the first
              under the sync census (no port line may be named); (b) the
              float32 split transfer
              (quantize_transfer = 0), ATE < 0.15 m; (c) AsyncIngest over a
              fresh Localizer fed by two producer threads, poses equal to
              phase 3's bit for bit; (d) the native int16 packer is the C
              library and bit-equal to its NumPy twin on every scan, and
              both are timed on the host (ms a scan at N = 32768); (e)
              per-scan wall p50/p95 of (a) beside phase 3's.
8. split    — the scans of phase 3 through Localizer(cfg, split_body=True):
              every scan's update is the per-iteration loop around the gain
              kernel K8 (chart projection, guard and Joseph covariance in
              plain torch).  K8 must launch (max_iters + 1) times a scan, K5
              and K6 never; one host read an evaluation (the guard's
              Gershgorin bound), no other; ATE < 0.15 m; the poses within
              rtol 1e-3 / atol 2e-4 (phase 4's bounds) of phase 3's.  Prints
              per-scan wall p50/p95, host syncs and guard eigh calls beside
              phase 3's.
9. slam     — the SLAM engine at the same configuration: (a) the bench's
              soak (bench.py:227-274: 192 scans of a 9 m closed circuit,
              loop closure, keyframe cap 64, eviction armed): at least one
              loop closed, keyframe RMSE and last-60-scan RMSE < 0.3 m;
              wall ms of one loop detection (ScanContext + ICP +
              refinement), one graph optimisation and one map rebuild;
              (b) the bench's corridor (bench.py:190-224, 48 scans) with and
              without 2 Hz GPS priors: the GPS run's keyframe RMSE below
              the odometry-only one; (c) the soak's session saved, loaded
              into a fresh SLAM and two later scans relocalized: success,
              within 0.5 m of ground truth at mid-sweep; (d) the CLI
              in-process, `synthetic --scans 24 --debug-dump … --out …` at
              the default Config() (cfg.debug on): its JSON line has
              ate_m < 0.15 and the dump every DebugOutput field, and its
              scan dispatches after the warm-up run under the sync census
              (no port line may be named).
10. data    — the new entry points at full width, each path's kernel
              counts zeroed before it and read after it (K1, K2, K3's select
              entry, K4, K5, K6 and K9 must launch on every path):
              (a) for each untouched configs/{kitti,utbm,cat,ona}_tpu.yaml,
                  `make-synthetic` exports 24 scans of 16384 points in the
                  profile's sensor convention (HESAI absolute seconds for
                  ona; a 3 s standstill for cat and ona, which calibrate;
                  GPS fixes every 5 scans for utbm) and `sequence --config
                  <yaml>` runs it through the CLI: 24 finite poses and ATE
                  < 0.5 m against the synthetic truth (the scan count, ATE
                  and per-scan wall p50/p95 printed), every dispatch after
                  the first 4 under the sync census (no port line may be
                  named); ona again with `--async`, its TUM file bit-equal to
                  the synchronous run's;
              (b) a KITTI raw drive written from the synthetic world (24
                  .bin scans of 120000 float32 [x, y, z, intensity] points,
                  OXTS rows with the IMU in columns 14:17 and 20:23, both
                  timestamps.txt in KITTI's text format) through `kitti
                  --config configs/kitti_tpu.yaml`: one finite pose a scan;
                  ATE printed without a bound (KITTI's point times come
                  from azimuth, not from the world);
              (c) phase 3's corridor through SLAM in 4 packets a sweep
                  (io/packets.PacketSlicer): 4 poses a sweep, ATE <
                  max(3 x phase 3's, 0.15 m, 1.25 x the JAX package's ATE
                  on the same 24 sweeps in packets, JAX_PACKET_CORRIDOR_ATE:
                  on this 15 m/s corridor the reference itself misses
                  max(3 x, 0.15 m)); then the soak
                  (192 sweeps) in 3 packets: at least one loop closed, fewer
                  than 1.5 x phase 9's keyframes, ATE < max(3 x phase 9's,
                  0.15 m); no K9 sort longer than a scan or a map rebuild
                  (the stitched sweep is never sorted whole);
              (d) four sessions (the corridor at seeds 7-10, their
                  ScanBatches captured through Localizer.on_dispatch) for
                  12 ticks of parallel/batched's step, session 2 idle on
                  ticks 4-5 (noop_batch, active False): every session's
                  poses bit-equal to its own single-session steps, the idle
                  state bit-equal across its idle ticks, ticks after the
                  first under the sync census; tick ms p50/p95, ms a
                  session-scan, cudaLaunchKernel a tick (profiler, two more
                  ticks), peak memory and K6 = 4 launches a tick;
              (e) the entry() twin: one step on the card, finite outputs.
11. shard   — the multi-device layer (parallel/sharded.py) on the one card
              through the in-process backend (one thread a rank, one CUDA
              stream), at the main path's configuration with each shard at
              map_capacity / n_map (the global capacity is phase 3's), on
              phase 3's 24 scans (their ScanBatches from a second replay of
              phase 3, whose poses must equal phase 3's bit for bit):
              (a) 'map' = 4: the shards concatenated after scan 1 equal
                  phase 3's table and ptable bit for bit; the poses within
                  max(3e-4 m / 3e-5, 1.25 x the JAX package's own
                  sharded-to-single gap, JAX_SHARD_GAP) of phase 3's, ATE
                  < 0.15 m; num_points equal to phase 3's after every scan;
                  the steady scans under the sync census (no port line
                  named); K7's dense entry and K9 launch, K6 4 x 24 times,
                  K2 never; the received bytes of every rank a scan, term
                  by term, against comm_volume (the cap gather and the
                  gate psums a third of it); wall ms p50/p95 a scan,
                  cudaLaunchKernel a scan (profiler, two more scans), peak
                  memory; K7's dense entry counted by call site (window
                  resolve, stale patch, full re-gather) and held bit for
                  bit to its plain version at each site's shape, on one
                  rank's inputs captured in one more step after the
                  measured run, and timed (three kernel rows);
              (b) 'map' 2 x 'data' 2: the same checks against the JAX 2-D
                  gap, num_points within 5 % (tests/test_sharded.py's 2-D
                  bound), K6 never, K3's select entry, K4 and K5 once a rank
                  an evaluation; the three held to their plain versions at
                  a rank's query slice and timed (three kernel rows);
              (c) the pose graph phase 9's last loop closure optimised,
                  its edges over 4 ranks (optimize_distributed) and on one
                  (optimize), cast to float64: trans within 1e-4 m, costs
                  within rtol 1e-4 (tests/test_gps.py's bounds); in
                  float32, the engine's dtype: trans within 1e-4 m, and
                  the four ranks' costs within max(1e-4, 2 x the one
                  rank's, its largest over the given edge order and four
                  permutations of the edge slots) of the float64
                  one-rank costs (near the
                  converged floor float32's own error on this graph
                  exceeds rtol 1e-4; the CPU witness of the rule:
                  tests/test_torch_posegraph_dist.py, run as a script);
                  the wall ms of each;
              (d) (a)'s state after scan 12 saved by
                  distributed.save_checkpoint, loaded into a single-card
                  Localizer, saved, and restored onto D = 4: scan 13 from
                  the live and the restored state bit-equal;
              (e) entry.dryrun_multichip(4): the 1-D and 2-D meshes on the
                  card, the two-process leg on CPU processes over
                  torch.distributed (gloo), which does not run on the card.
              A rank that raises or a collective that times out ends the
              run; no rank falls back to the CPU.
12. wide    — the 128-beam configuration, through K9's grid kernel:
              (a) a Localizer at presets.ouster128_cfg (kitti_like_cfg with
                  262 144-point scans and max_insert_points = 0, so both
                  K9 sorts of a scan take 262 144 elements) replays
                  presets.ouster128_sequence (the bench's corridor seen by
                  an OS1-128: 24 sweeps of 262 144 returns on 128 rings):
                  ATE < 0.15 m and within 1.25 x the JAX package's on the
                  same replay (JAX_WIDE_ATE); K9 exactly twice a scan, every
                  launch through the grid kernel; every main-path kernel
                  launched; 0 synchronizing calls from port lines over the
                  last scans; prints the per-scan wall p50/p95, and from
                  WIDE_PROFILED profiled scans cudaLaunchKernel and device
                  busy a scan, and the peak memory;
              (b) K9 on (a)'s captured voxel and insert sorts, and on seeded
                  sorts at the switch (sort.CLUSTER_MAXN, the cluster
                  kernel) and one above it in both forms, and at 2^17 + 1,
                  2^20 and 2^22 (the grid kernel): all three outputs
                  bit-equal to sort3_plain, one CUDA kernel a call, with
                  both torch.sort yardsticks; full-range triples bit-equal
                  at each N; then both routes timed at K9_CROSSOVER_N in
                  both forms, each held bit-equal, and the crossover table
                  that the switch was set from printed;
              (c) phase 9's soak engine rebuilds its map at rebuild_batch
                  32 (32 keyframe clouds of 8192 points, 262 144 in one
                  insert): its K9 calls through the grid kernel, the first
                  held bit for bit as a row; then the soak runs on to scan
                  216 on the rebuilt map and phase 9's gates hold (>= 1
                  loop, keyframe and last-60-scan RMSE < 0.3 m).
13. result  — the card's name and power limit, the kernels JSON line (K1-K9,
              K2 three times: the main path's window resolve, its select
              entry and the map path's k = 64; K7 five times; K3 select, K4
              and K5 again at phase 11 (b)'s query slice; K9 twice on the
              main path, then phase 12's grid rows: (a)'s voxel and insert
              sorts, the seeded sorts and the rebuild's), then the final
              status line.

Usage: python3 chip_smoke.py [--scans N] [--profile]
       python3 chip_smoke.py --compare [--tree DIR] [--out A.npz] [--against B.npz]
--compare runs phase 3's replay and times phase 6 (a)'s four
radius_search calls (wall p50 of 7 with min and max; device sum, K7's and
K2's parts, device ops and cudaLaunchKernel a call) with the port of the
checkout at --tree (default: this one), checking nothing: run it on a
`git archive` of another commit and on this one, in one call, to compare
the two.
Exits non-zero on any failed check; there is no CPU path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np


def _fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def _time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over reps runs (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_ms(fn, prefix=None, reps: int = 5):
    """Device time of one fn() call from torch.profiler (CUPTI), over reps
    runs after one warm-up: the CUDA kernels whose names start with
    ``prefix``, or every device op of the call if None.  A session must
    record the named kernels a whole number of times a call (a session has
    missed some launches of a cooperative grid kernel, PERF §7); None ("not
    measured") if none of three sessions records a device op, or the named
    kernels a whole number of times a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a session now and then records no device event (PERF §7)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        mine = [e for e in ev if prefix is None or _kname(e.key).startswith(prefix)]
        n = sum(e.count for e in mine)
        if ev and (prefix is None or (n and n % reps == 0)):
            return sum(e.self_device_time_total for e in mine) / 1e3 / reps
    return None


def _query_timing(torch, call, reps: int = 3) -> dict:
    """One map query's wall ms (host clock between synchronises, p50 of 7
    after a warm-up, with min and max) and, from torch.profiler over reps
    calls, a call's device ms (the sum of its CUDA ops), the parts in K7's
    kernels (names holding "masked_topk") and in K2's (names holding
    "knn_rows" or "fl_k2", any tree's), its device ops and its
    cudaLaunchKernel calls (device figures None if the profiler records no
    device op)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    dev = [e for e in stats if e.device_type.name == "CUDA"]
    host = [e for e in stats if e.device_type.name == "CPU"]

    def dsum(es):
        return sum(e.self_device_time_total for e in es) / reps / 1e3 if dev else None

    return {"wall_p50": float(np.median(walls)), "wall_min": min(walls),
            "wall_max": max(walls), "device_ms": dsum(dev),
            "k7_device_ms": dsum([e for e in dev if "masked_topk" in e.key]),
            "k2_device_ms": dsum([e for e in dev if "knn_rows" in e.key or "fl_k2" in e.key]),
            "device_ops": sum(e.count for e in dev) / reps,
            "cudaLaunchKernel": sum(e.count for e in host
                                    if e.key.startswith("cudaLaunchKernel")) / reps}


def _query_line(name, t) -> str:
    return (f"{name}: wall p50 {t['wall_p50']:.3f} ms (min {t['wall_min']:.3f}, max "
            f"{t['wall_max']:.3f}, 7 runs) | device {_fmt(t['device_ms'])}, of it K7 "
            f"{_fmt(t['k7_device_ms'])}, K2 {_fmt(t['k2_device_ms'])} | {t['device_ops']:.0f} "
            f"device ops, "
            f"{t['cudaLaunchKernel']:.0f} cudaLaunchKernel a call")


def _kname(key: str) -> str:
    """A profiler kernel name without the "void " that a template's
    demangled name starts with."""
    return key[5:] if key.startswith("void ") else key


_PORT = os.sep + "fast_limo_tpu_torch" + os.sep


def _sync_calls(fn):
    """(fn(), one entry a synchronizing call it made), run under
    torch.cuda.set_sync_debug_mode("warn").  An entry is the line the
    warning names (the innermost Python frame, often torch's own code) and,
    after " <- ", the innermost port (fast_limo_tpu_torch/) frame inside
    fn on the Python stack when the warning was raised — the port line that
    led to the sync — where there is one."""
    import traceback

    import torch

    caught = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        inside = [i for i, f in enumerate(stack)
                  if f.name == "_sync_calls"
                  and os.path.abspath(f.filename) == os.path.abspath(__file__)]
        stack = stack[inside[-1] + 1 if inside else 0:]
        port = [f for f in stack if _PORT in f.filename]
        entry = f"{os.path.relpath(filename)}:{lineno}"
        if port:
            entry += f" <- {os.path.relpath(port[-1].filename)}:{port[-1].lineno}"
        else:   # the calls that led there, outermost first
            entry += " in " + "/".join(f.name for f in stack if "warnings" not in f.filename)
        caught.append(entry)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, caught


def _port_syncs(entries):
    """The census entries led to by a port source line."""
    return [e for e in entries
            if e.startswith("fast_limo_tpu_torch" + os.sep) or " <- " in e]


def _no_sync(name, fn):
    """fn(), failing on any synchronizing call inside it."""
    out, syncs = _sync_calls(fn)
    if syncs:
        _fail(f"{name} synchronized the host at {syncs}")
    return out


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


WARMUP = 4          # scans before the steady per-scan times
HBM_BPS = 3.35e12   # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
FP32_OPS = 67e12    # H100 SXM float32 operations/s outside the tensor cores


def _nbytes(*objs) -> int:
    """Bytes of the tensors among ``objs`` (tuples such as a NavState are
    walked; other values count nothing)."""
    import torch

    return sum(o.numel() * o.element_size() if torch.is_tensor(o)
               else _nbytes(*o) if isinstance(o, (tuple, list)) else 0 for o in objs)


def _table_work(ptable, row_idx, nc, q, out, d2, E):
    """The work of a top-k on the map table's rows (K2, K7's table entry):
    the four meta planes of every distinct row the queries name, the
    coordinates of those rows' filled slots, the row indices, block
    coordinates, queries and outputs, each read or written once; 8
    operations a valid (query, candidate) distance."""
    import torch

    rows = torch.unique(row_idx.long())
    filled = int(ptable[rows, 3 * E:4 * E].sum())
    n_valid = int(torch.isfinite(d2).sum())
    return (rows.numel() * 4 * E * 4 + 12 * filled + _nbytes(row_idx, nc, q, *out),
            8 * n_valid)


def _bound(nbytes: float, ops: float):
    """(least ms, "bytes" | "operations"): each input read once and each
    output written once at the HBM rate, or the operations at the float32
    rate, whichever takes longer."""
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * ops / FP32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def _maxerr(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(name, got, want, rtol, atol, scale=None):
    """Elementwise |got − want| ≤ atol + rtol·scale, scale = |want| unless
    given (numpy's assert_allclose rule); returns the max abs error."""
    if got.shape != want.shape:
        _fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    d = (got.double() - want.double()).abs()
    bound = atol + rtol * (want.double().abs() if scale is None else scale.double())
    if not bool((d <= bound).all()):
        i = int((d - bound).flatten().nan_to_num(float("inf")).argmax())
        _fail(f"{name}: |err| {float(d.flatten()[i]):.3e} > {float(bound.flatten()[i]):.3e} "
              f"at flat index {i} (rtol {rtol}, atol {atol})")
    return _maxerr(got, want)


def _held(name, got, want):
    """A top-k's (nbrs, sq, valid) bit-equal to its plain version's."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.equal(w):
            _fail(f"{name}: output {i} (nbrs, sq, valid) differs from the plain version")


def _k3_check(name, got, want):
    """K3 against its plain version: gates agree on ≥ 99.5 %; n_abcd rtol
    5e-3 / atol 5e-4 where both are good; returns (max error, agreement)."""
    agree = float((got[1] == want[1]).float().mean())
    if agree < 0.995:
        _fail(f"{name} gate agreement {agree:.4f} < 0.995")
    both = got[1] & want[1]
    return _close(f"{name} n_abcd", got[0][both], want[0][both], 5e-3, 5e-4), agree


def _k4_check(name, got, want, X4, sc4, hkw):
    """K4 against its plain version: rtol 1e-5 of each entry's sum of term
    magnitudes (both sides sum the same float32 products in different
    orders, and the rounding of a sum scales with Σ|terms|; for the
    diagonal of HᵀH that is the entry itself, elsewhere it covers
    cancellation).  Returns (max error, H (Np, 12))."""
    import torch

    from fast_limo_tpu_torch.ops import hstats

    Np4 = X4.shape[0] // 8
    cols, hneg = hstats.h_rows(tuple(X4[i * Np4:(i + 1) * Np4] for i in range(8)), sc4, **hkw)
    Ha = torch.stack(cols, dim=-1).double().abs()
    err = max(_close(f"{name} HTH", got[0], want[0], 1e-5, 0.0, scale=Ha.T @ Ha),
              _close(f"{name} HTh", got[1], want[1], 1e-5, 0.0, scale=Ha.T @ hneg.double().abs()))
    return err, torch.stack(cols, dim=-1).contiguous()


def _k5_check(name, got, want):
    """K5 against its plain version: x rtol 1e-3 / atol 1e-4, P and dx_
    rtol 1e-3 / atol 1e-3 (Jacobi vs eigh guard, f32 gain conditioning)."""
    from fast_limo_tpu_torch.models import state as st

    return max(_close(f"{name} x", st.as_vector(got[0]), st.as_vector(want[0]), 1e-3, 1e-4),
               _close(f"{name} P", got[1], want[1], 1e-3, 1e-3),
               _close(f"{name} dx_", got[2], want[2], 1e-3, 1e-3))


def _once(name, wrapper, call):
    """Run ``call`` (a public kernel wrapper on CUDA tensors) and check that
    it launched its kernel exactly once."""
    n0 = wrapper.launches
    out = call()
    if wrapper.launches != n0 + 1:
        _fail(f"{name}: the wrapper launched {wrapper.launches - n0} times, not once")
    return out


def _profile(torch, Localizer, cfg, stamps, acc, gyro, scans, label: str) -> None:
    """torch.profiler over the steady scans of a fresh replay: device time
    by kernel/op, the device's busy share of the profiled wall time, and
    the host ops with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    loc = Localizer(cfg, device=torch.device("cuda:0"))
    si, prof, t0 = 0, None, None
    for k in range(len(stamps)):
        loc.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            if si == WARMUP:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                t0 = time.perf_counter()
            loc.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
    loc.flush()
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    prof.__exit__(None, None, None)
    n = len(scans) - WARMUP
    stats = prof.key_averages()
    events = [e for e in stats if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events)
    print(f"[smoke] profile {label}: {n} scans, device busy {busy / n / 1e3:.3f} ms/scan of "
          f"{wall_us / n / 1e3:.3f} ms/scan wall (profiled; busy share "
          f"{busy / wall_us:.3f}), {sum(e.count for e in events) / n:.0f} device ops/scan")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[smoke] profile {label}: {e.self_device_time_total / n / 1e3:8.4f} ms/scan "
              f"x{e.count / n:6.1f}  {e.key[:90]}")
    k2 = [e for e in events if "knn_rows" in e.key or "fl_k2" in e.key]
    print(f"[smoke] profile {label}: K2 {sum(e.self_device_time_total for e in k2) / n / 1e3:.4f} "
          f"ms/scan in {sum(e.count for e in k2) / n:.1f} launches a scan", flush=True)
    host = [e for e in stats if e.device_type.name == "CPU"]
    n_sync = sum(e.count for e in host if e.key == "cudaStreamSynchronize")
    n_launch = sum(e.count for e in host if e.key.startswith("cudaLaunchKernel"))
    print(f"[smoke] profile {label}: cudaStreamSynchronize {n_sync / n:.2f} calls a scan "
          f"({n_sync} in {n} scans) | kernel launches {n_launch / n:.1f} a scan "
          f"(cudaLaunchKernel*)")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"[smoke] profile {label} host: {e.self_cpu_time_total / n / 1e3:8.4f} ms/scan "
              f"x{e.count / n:7.1f}  {e.key[:80]}")


def _events(stamps, scans):
    """Arrival order of a replay: ("imu", i) and ("scan", j)."""
    out, si = [], 0
    for k in range(len(stamps)):
        out.append(("imu", k))
        while si < len(scans) and scans[si][0] <= stamps[k]:
            out.append(("scan", si))
            si += 1
    return out


def _feed(loc, ev, stamps, acc, gyro, scans):
    kind, i = ev
    if kind == "imu":
        loc.update_imu(stamps[i], acc[i], gyro[i])
    else:
        loc.update_pointcloud(scans[i][1], scans[i][2], scans[i][0])


def _brute_check(torch, name, stored, q, r, kmax, res):
    """radius_search against a brute force over the stored points, on the
    card: per query the same count (capped at kmax), the sorted sq within
    rtol 1e-5, and every returned point inside the radius.  Returns the
    mean count."""
    nbrs, sq, valid = res
    dx = stored[None, :, 0] - q[:, None, 0]
    dy = stored[None, :, 1] - q[:, None, 1]
    dz = stored[None, :, 2] - q[:, None, 2]
    d2 = dx * dx + dy * dy + dz * dz                 # the kernels' association
    d2 = torch.where(d2 <= r * r, d2, torch.full_like(d2, float("inf")))
    want = torch.topk(d2, kmax, dim=1, largest=False).values
    n_want = torch.isfinite(want).sum(1)
    if not torch.equal(n_want, valid.sum(1)):
        i = int((n_want != valid.sum(1)).nonzero()[0])
        _fail(f"{name}: query {i} returns {int(valid[i].sum())} points, brute force "
              f"{int(n_want[i])}")
    _close(f"{name} sq", sq[valid], want[valid], 1e-5, 0.0)
    dist = torch.linalg.norm(nbrs - q[:, None, :], dim=-1)
    if not bool((dist[valid] <= r + 1e-5).all()):
        _fail(f"{name}: a returned point lies outside the radius")
    return float(n_want.float().mean())


def _map_queries(torch, m, dev):
    """The stored points of map m and 10 000 queries within 0.5 m of them
    (seed 5): the map phase's queries."""
    from fast_limo_tpu_torch.utils import checkpoint

    stored = checkpoint.map_points(m)
    rng = np.random.default_rng(5)
    pick = rng.choice(len(stored), 10000, replace=len(stored) < 10000)
    q = torch.tensor(np.float32(stored[pick] + rng.uniform(-0.5, 0.5, (10000, 3))), device=dev)
    return stored, q


def _radius_settings(vox):
    """The map phase's (radius, max_results): K2 with V = 8, V = 27 at k = 16
    and 64, K7's table entry at 3 m."""
    return [(0.9 * vox, 16), (1.9 * vox, 16), (1.9 * vox, 64), (3.0, 16)]


def _map_phase(dev, cfg, loc, stamps, acc, gyro, scans, wrappers, report):
    """Phase 6: radius_search (K2, K7's table entry) on the main replay's
    final map, K7's two entries and K2 at k = 64 against their plain
    versions, an eviction replay and a checkpoint/resume."""
    import torch

    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.models import mapper
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import dispatch, knn, knn_rows
    from fast_limo_tpu_torch.utils import presets

    def counts():
        return {k: w[0].launches for k, w in wrappers.items()}

    # (a) radius_search at four settings on the final map of phase 3
    m, vox = loc.state.map, cfg.map_voxel_size
    stored, q = _map_queries(torch, m, dev)
    stored_d = torch.tensor(stored, device=dev)
    cap, k2_shapes = {}, []
    o_k7t, o_k2, o_cands = knn._launch_table, knn_rows._launch, mapper.cands_from_rows
    decodes = [0]

    def k7t_cap(*a, **kw):
        cap.setdefault("k7t", (a, kw))
        return o_k7t(*a, **kw)

    def k2_cap(*a, **kw):
        k2_shapes.append((int(a[1].shape[1]), kw["k"]))
        cap.setdefault("k2_64" if kw["k"] == 64 else f"k2_{a[1].shape[1]}_{kw['k']}", (a, kw))
        return o_k2(*a, **kw)

    def cands_count(*a, **kw):
        decodes[0] += 1
        return o_cands(*a, **kw)

    knn._launch_table, knn_rows._launch = k7t_cap, k2_cap
    mapper.cands_from_rows = cands_count
    settings = _radius_settings(vox)
    for w in wrappers.values():
        w[0].launches = 0
    runs = []
    for r, kmax in settings:
        c0, d0 = counts(), decodes[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mapper.radius_search(m, q, r, voxel_size=vox, max_results=kmax)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: n - c0[k] for k, n in counts().items() if n > c0[k]}
        if decodes[0] > d0:
            launched["cands_from_rows"] = decodes[0] - d0
        runs.append((r, kmax, ms, launched, res))
    map_counts = counts()
    knn._launch_table, knn_rows._launch = o_k7t, o_k2
    mapper.cands_from_rows = o_cands
    print(f"[smoke] map: {len(stored)} stored points, {q.shape[0]} queries | launches "
          f"{json.dumps(map_counts)} | K2 (V, k) {sorted(set(k2_shapes))}", flush=True)
    for r, kmax, ms, launched, res in runs:
        name = f"radius {r:.2f} m / {kmax}"
        n = _brute_check(torch, name, stored_d, q[:256], r, kmax,
                         tuple(t[:256] for t in res))
        print(f"[smoke] map: {name}: {ms:.2f} ms | launches {json.dumps(launched)} | 256 "
              f"queries equal brute force ({n:.2f} points each)", flush=True)
    if map_counts["knn_rows"] <= 0:
        _fail("kernel knn_rows did not launch in the map phase")
    for want in ((8, 16), (27, 16), (27, 64)):
        if want not in k2_shapes:
            _fail(f"K2 did not launch with (V, k) = {want} in the map phase")
    if runs[3][3] != {"masked_topk_table": 1}:
        _fail(f"radius_search's wide branch launched {json.dumps(runs[3][3])}, not K7's table "
              f"entry once (and no dense K7, no candidate decode)")

    # the 3.0 m / 16 call: wall and device time, K7's share of it
    t = _query_timing(torch, lambda: mapper.radius_search(m, q, 3.0, voxel_size=vox,
                                                          max_results=16))
    print(f"[smoke] map: {_query_line(f'radius 3.00 m / 16 over {q.shape[0]} queries', t)}",
          flush=True)

    # (b) K7's table entry at that call, and the dense entry on its first
    # 381 queries decoded explicitly (gather + cands_from_rows), against
    # their plain versions: sq, valid and nbrs bit-equal, invalid tail
    # included
    at, kwt = cap["k7t"]
    ptab, ridx, ncb, qt = at
    g = _once("K7 table", knn.masked_topk_from_table,
              lambda: knn.masked_topk_from_table(*at, **kwt))
    _held("K7 table", g, knn.masked_topk_from_table_reference(*at, **kwt))
    Nt, Vt = ridx.shape
    rows = ptab[ridx.long()]
    cand_t, cval_t = mapper.cands_from_rows(rows, ncb, None, kwt["B"])
    del rows
    d2_t = knn.masked_d2(cand_t.reshape(Nt, -1, 3), cval_t.reshape(Nt, -1), qt)
    del cand_t, cval_t
    report("masked_topk (table)", 0.0, lambda: knn.masked_topk_from_table(*at, **kwt),
           lambda: knn.masked_topk_from_table_reference(*at, **kwt),
           *_table_work(ptab, ridx, ncb, qt, g, d2_t, kwt["E"]),
           lambda: torch.topk(d2_t, kwt["k"], dim=1, largest=False),
           f"(radius_search 3.0 m / 16: N={Nt}, V={Vt}, C={d2_t.shape[1]}, k={kwt['k']}, "
           f"{float(torch.isfinite(d2_t).float().mean()):.3f} valid; one launch a call)",
           launches=map_counts["masked_topk_table"], kernel="masked_topk_table",
           prefix="fl_masked_topk")
    del d2_t

    n7 = min(381, Nt)
    rows = ptab[ridx[:n7].long()]
    cand7, cval7 = mapper.cands_from_rows(rows, ncb[:n7], None, kwt["B"])
    a7 = (cand7.reshape(n7, -1, 3), cval7.reshape(n7, -1), qt[:n7])
    kw7 = {"k": kwt["k"]}
    g = _once("K7", knn.masked_topk, lambda: knn.masked_topk(*a7, **kw7))
    _held("K7", g, knn.masked_topk_reference(*a7, **kw7))
    N7, C7 = a7[1].shape
    n_valid = int(a7[1].sum())
    d2_7 = knn.masked_d2(*a7)
    report("masked_topk (map queries, no path)", 0.0, lambda: knn.masked_topk(*a7, **kw7),
           lambda: knn.masked_topk_reference(*a7, **kw7),
           N7 * C7 + 12 * n_valid + _nbytes(a7[2], *g), 8 * n_valid,
           lambda: torch.topk(d2_7, kw7["k"], dim=1, largest=False),
           f"(N={N7}, C={C7}, k={kw7['k']}, {n_valid / (N7 * C7):.3f} valid: the first "
           f"{N7} queries of the 3.0 m call, decoded explicitly; no path gives this shape: "
           f"phase 11 (a)'s rows carry the dense entry's launches)",
           launches=map_counts["masked_topk"], kernel="masked_topk")

    # K2 at k = 64 (V = 27): sq, valid and nbrs bit-equal, ONE CUDA kernel
    # a call; and the device ms of each schedule at the 1.08 m and 2.28 m
    # / 16 calls' shapes
    for key in ("k2_8_16", "k2_27_16"):
        a2, kw2 = cap[key]
        a2 = a2[:4]                               # ptable, row_idx, nc, queries
        want = knn_rows.topk_from_table_reference(*a2, **kw2)
        t2 = {}
        for mode in knn_rows.MODES:
            _held(f"K2 ({key}, {mode})", knn_rows._launch(*a2, None, **kw2, mode=mode), want)
            t2[mode] = _device_ms(lambda: knn_rows._launch(*a2, None, **kw2, mode=mode), "fl_k2")
        print(f"[smoke] map: K2 at V={a2[1].shape[1]}, k={kw2['k']} (N={a2[1].shape[0]}): "
              f"schedule {knn_rows.schedule(a2[1].shape[1], kw2['k'])}, device ms by schedule "
              f"{json.dumps({m: round(t, 5) if t else t for m, t in t2.items()})}, each "
              f"bit-equal to the plain version", flush=True)
    a2, kw2 = cap["k2_64"]
    a2 = a2[:4]
    g = _once("K2 k=64", knn_rows.topk_from_table, lambda: knn_rows.topk_from_table(*a2, **kw2))
    _held("K2 k=64", g, knn_rows.topk_from_table_reference(*a2, **kw2))
    n2 = _cuda_launches(torch, lambda: knn_rows.topk_from_table(*a2, **kw2), "fl_k2")
    if n2 != 1:
        _fail(f"K2 (k = 64) ran {n2} CUDA kernels a call, not one")
    d2_2 = knn_rows.candidate_d2(a2[0][a2[1].long()], *a2[2:], E=kw2["E"], B=kw2["B"])[0]
    report("knn_rows k=64", 0.0, lambda: knn_rows.topk_from_table(*a2, **kw2),
           lambda: knn_rows.topk_from_table_reference(*a2, **kw2),
           *_table_work(*a2, g, d2_2, kw2["E"]),
           lambda: torch.topk(d2_2, 64, dim=1, largest=False),
           f"(radius_search 2.28 m / 64: N={a2[1].shape[0]}, V={a2[1].shape[1]}, k=64, schedule "
           f"{knn_rows.schedule(a2[1].shape[1], 64)}, 1 CUDA kernel a call)",
           launches=map_counts["knn_rows"], kernel="knn_rows", prefix="fl_k2")

    # (c) eviction replay at the bench's soak settings
    seq_e = presets.bench_sequence(n_scans=40)
    st_e, ac_e, gy_e = seq_e.imu_stream()
    sc_e = [seq_e.scan(i) for i in range(seq_e.n_scans)]
    loc_e = Localizer(cfg)
    loc_e.evict_radius, loc_e.evict_occupancy = 30.0, 0.002
    drops, o_evict = [], loc_e._maybe_evict

    def watched(pos):
        before = int(loc_e.state.map.num_points)
        o_evict(pos)
        after = int(loc_e.state.map.num_points)
        if after != before:
            drops.append((len(loc_e._raw_outputs) + 1, before, after))

    loc_e._maybe_evict = watched
    for ev in _events(st_e, sc_e):
        _feed(loc_e, ev, st_e, ac_e, gy_e, sc_e)
    est = loc_e.positions()
    if len(est) != seq_e.n_scans or not np.isfinite(est).all():
        _fail(f"eviction replay has {len(est)} poses or non-finite values")
    ate_e = synthetic.ate_rmse(est, seq_e.traj.pos(loc_e.stamps()))
    print(f"[smoke] evict: {len(est)} scans, ATE {ate_e:.4f} m | evictions (scan, points "
          f"before, after) {drops}", flush=True)
    if not drops or any(after >= before for _, before, after in drops):
        _fail("no eviction dropped the map's point count in 40 scans")
    if not ate_e < 0.15:
        _fail(f"eviction replay ATE {ate_e:.4f} m >= 0.15 m")

    # (d) checkpoint half-way through a replay (five IMU samples after scan
    # save_at was dispatched), resume in a fresh Localizer
    events = _events(stamps, scans)
    save_at = len(scans) // 2
    path = os.path.join(dispatch.BUILD_DIR, "smoke_resume.npz")
    loc_b, fed, held = Localizer(cfg), [], None
    for j, ev in enumerate(events):
        _feed(loc_b, ev, stamps, acc, gyro, scans)
        if ev[0] == "scan":
            fed.append(ev)
        if held is None and len(loc_b._raw_outputs) == save_at and len(loc_b._imu_queue) == 5:
            loc_b.save_checkpoint(path)
            pending = fed[len(fed) - len(loc_b._scan_queue):]
            held = (list(loc_b._imu_queue), pending, j)
    if held is None:
        _fail(f"the replay never held five IMU samples after scan {save_at}")
    loc_c = Localizer(cfg)
    loc_c.load_checkpoint(path)
    for s, a, g in held[0]:
        loc_c.update_imu(s, a, g)
    for ev in held[1] + events[held[2] + 1:]:
        _feed(loc_c, ev, stamps, acc, gyro, scans)
    got, want = loc_c.positions(), loc_b.positions()[save_at:]
    if got.shape != want.shape:
        _fail(f"resumed replay has {len(got)} poses, want {len(want)}")
    err = float(np.abs(got - want).max())
    print(f"[smoke] resume: saved after scan {save_at} ({len(held[0])} IMU samples and "
          f"{len(held[1])} scans queued), resumed on {loc_c.state.P.device} for "
          f"{len(got)} scans: max |dpos| {err:.3e} m vs the uninterrupted replay", flush=True)
    if not err <= 1e-5:
        _fail(f"resumed trajectory departs by {err:.3e} m > 1e-5 m")
    os.remove(path)


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _symbol_head(name: str) -> str:
    """The first identifier of a kernel's symbol: "fl_sort3_grid_kernel"
    of "_Z20fl_sort3_grid_kernel..." (a C name is its own head)."""
    m = re.match(r"_ZN?L?(\d+)", name)
    return name[m.end():m.end() + int(m.group(1))] if m else name


def _graph_launches(torch, fn, prefix: str):
    """(device ops, kernels named ``prefix*``) that one call of fn() puts on
    the stream, read from the nodes of a CUDA graph captured of that call
    (kernel, copy and set nodes; nothing runs).  Raises where the call
    cannot be captured or the driver cannot name a node's kernel."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned {rc}")

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    try:
        ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        ops = named = 0
        for node in nodes[:n.value]:
            kind = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            if kind.value not in (0, 1, 2):   # kernel, memcpy, memset
                continue
            ops += 1
            if kind.value != 0:
                continue
            p, name = _KernelNodeParams(), ctypes.c_char_p()
            ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
               "cuGraphKernelNodeGetParams")
            if p.func:
                ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
            else:
                ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                   "cuKernelGetName")
            named += _symbol_head(name.value.decode()).startswith(prefix)
    finally:
        g.reset()
    return ops, named


_COUNTED_BY = {"graph": 0, "profiler": 0}   # how each kernels-a-call check was read


def _cuda_launches(torch, fn, prefix: str, tries: int = 6, reps: int = 5):
    """CUDA kernels named ``prefix*`` that one call of fn() launches (every
    device op of the call if ``prefix`` is ""), counted from a CUDA graph
    captured of one call; where the call cannot be captured, as
    torch.profiler records them over ``reps`` calls: the first of ``tries``
    profiled sessions that records one ("not measured" if none records a
    device event, else 0).  The profiler on the card has come back empty
    now and then, and now and then without a kernel launched as a
    thread-block cluster (K4, K6, K9) whose launch the wrapper counted,
    with older trees' kernels as with these; sessions of one K9 call have
    come back empty many times in a row where sessions of five did not
    (PERF §7).  A call that launches two kernels still reads 2."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        ops, named = _graph_launches(torch, fn, prefix)
    except Exception as e:   # a call that does not capture: count it in the profiler
        print(f"[smoke] ({prefix or 'all'}: no graph count, {type(e).__name__}: {e}; "
              f"torch.profiler counts it)", flush=True)
    else:
        _COUNTED_BY["graph"] += 1
        return ops if prefix == "" else named
    _COUNTED_BY["profiler"] += 1
    seen = False
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        n = sum(e.count for e in events if _kname(e.key).startswith(prefix))
        if n:
            return n // reps if n % reps == 0 else n / reps
        seen = seen or bool(events)
    return 0 if seen else "not measured"


def _replay_timed(torch, loc, method, stamps, acc, gyro, scans, census=None):
    """Replay in arrival order (then flush), timing each call of
    ``loc.<method>`` on the host between two synchronises; returns
    [(ms, scans in the call)].  With a ``census`` list, every call after
    the first runs under the sync census and its entries are added."""
    times, orig = [], getattr(loc, method)

    def timed(arg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if census is not None and times:
            census.extend(_sync_calls(lambda: orig(arg))[1])
        else:
            orig(arg)
        torch.cuda.synchronize()
        times.append((1e3 * (time.perf_counter() - t), len(arg) if isinstance(arg, list) else 1))

    setattr(loc, method, timed)
    for ev in _events(stamps, scans):
        _feed(loc, ev, stamps, acc, gyro, scans)
    loc.flush()
    delattr(loc, method)
    return times


def _transfer_phase(dev, cfg, seq, loc1, stamps, acc, gyro, scans, scan_ms):
    """Phase 7: chunked replay, the float32 split transfer, AsyncIngest and
    the native packer, on the scans of phase 3 (whose Localizer is loc1)."""
    import copy
    import threading

    import torch

    from fast_limo_tpu_torch.io import native, synthetic
    from fast_limo_tpu_torch.io.stream import AsyncIngest
    from fast_limo_tpu_torch.models import iekf
    from fast_limo_tpu_torch.models.localizer import Localizer

    t1 = loc1.trajectory

    # (a) chunked replay, C = 4, the partial tail sent by flush()
    cfg4 = copy.deepcopy(cfg)
    cfg4.tpu.scan_chunk = 4
    loc4 = Localizer(cfg4, device=dev)
    census4 = []
    chunk_ms = _replay_timed(torch, loc4, "_dispatch_chunk", stamps, acc, gyro, scans, census4)
    t4 = loc4.trajectory
    if len(t4) != len(t1):
        _fail(f"chunked replay has {len(t4)} poses, the one-scan path {len(t1)}")
    dpos = max(float(np.abs(a["pos"] - b["pos"]).max()) for a, b in zip(t1, t4))
    dquat = max(float(np.abs(a["quat"] - b["quat"]).max()) for a, b in zip(t1, t4))
    same_n = all(a["n_pc2match"] == b["n_pc2match"] for a, b in zip(t1, t4))
    print(f"[smoke] transfer: (a) scan_chunk 4: {len(t4)} scans in {len(chunk_ms)} dispatches | "
          f"vs phase 3 max |dpos| {dpos:.3e} m, max |dquat| {dquat:.3e}, n_pc2match "
          f"{'equal' if same_n else 'DIFFER'}", flush=True)
    if not (dpos <= 3e-4 and dquat <= 3e-5 and same_n):
        _fail("chunked replay departs from the one-scan path beyond pos 3e-4 / quat 3e-5")
    sites4 = {f: census4.count(f) for f in sorted(set(census4))}
    print(f"[smoke] transfer: (a) scan_chunk 4, the {len(chunk_ms) - 1} chunks after the first "
          f"under set_sync_debug_mode(\"warn\"): {len(census4)} synchronizing calls "
          f"{json.dumps(sites4)}", flush=True)
    if _port_syncs(census4):
        _fail(f"the chunk step synchronized the host at port lines {_port_syncs(census4)}")

    # (b) the float32 split transfer
    cfgf = copy.deepcopy(cfg)
    cfgf.tpu.quantize_transfer = 0.0
    iekf.counters.host_syncs = iekf.counters.loop_fallbacks = 0
    locf = Localizer(cfgf, device=dev)
    for ev in _events(stamps, scans):
        _feed(locf, ev, stamps, acc, gyro, scans)
    estf = locf.positions()
    ate_f = synthetic.ate_rmse(estf, seq.traj.pos(locf.stamps()))
    print(f"[smoke] transfer: (b) float32 split transfer: {len(estf)} scans, ATE {ate_f:.4f} m | "
          f"loop fallbacks {iekf.counters.loop_fallbacks} | host syncs "
          f"{iekf.counters.host_syncs}", flush=True)
    if len(estf) != len(scans) or not ate_f < 0.15:
        _fail(f"float32 split transfer: {len(estf)} poses, ATE {ate_f:.4f} m (< 0.15 m wanted)")

    # (c) AsyncIngest fed by two producer threads
    loca = Localizer(cfg, device=dev)
    with AsyncIngest(loca) as ingest:
        def imu_producer():
            for k in range(len(stamps)):
                ingest.push_imu(stamps[k], acc[k], gyro[k])
                if k % 50 == 0:
                    time.sleep(0.001)

        def scan_producer():
            for st_, pts, traw in scans:
                ingest.push_scan(pts, traw, st_)
                time.sleep(0.002)

        threads = [threading.Thread(target=imu_producer), threading.Thread(target=scan_producer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            _fail("an AsyncIngest producer thread did not finish")
    pa, p1 = loca.positions(), loc1.positions()
    print(f"[smoke] transfer: (c) AsyncIngest, two producers: {len(pa)} scans, IMU dropped "
          f"{ingest.imu_dropped} | {'equal to' if np.array_equal(pa, p1) else 'DIFFERENT from'} "
          f"phase 3 bit for bit", flush=True)
    if ingest.imu_dropped or not np.array_equal(pa, p1):
        _fail("AsyncIngest replay differs from the synchronous one")

    # (d) the native packer: the C library, bit-equal to its NumPy twin;
    # both timed on the host (median of 20 calls a scan, every scan)
    if native.get_lib() is None:
        _fail("the native int16 packer did not build (g++)")
    N, q = cfg.tpu.max_points_per_scan, cfg.tpu.quantize_transfer
    c_ms, np_ms = [], []
    for i, (_, pts, traw) in enumerate(scans):
        p32 = np.ascontiguousarray(pts[:N], np.float32)
        t32 = np.ascontiguousarray(traw[:N], np.float32)
        a, ta, na = native.pack_scan_i16(p32, t32, N, q)
        b, tb, nb = native.pack_scan_i16_numpy(p32, t32, N, q)
        if not (np.array_equal(a, b) and ta == tb and na == nb):
            _fail(f"native int16 pack of scan {i} differs from its NumPy twin")
        for fn, out in ((native.pack_scan_i16, c_ms), (native.pack_scan_i16_numpy, np_ms)):
            reps = []
            for _ in range(20):
                t = time.perf_counter()
                fn(p32, t32, N, q)
                reps.append(1e3 * (time.perf_counter() - t))
            out.append(float(np.median(reps)))
    print(f"[smoke] transfer: (d) native int16 packer ({os.path.basename(native.library_path())}) "
          f"bit-equal to its NumPy twin on {len(scans)} scans | host ms a scan at N = {N}: "
          f"C p50 {np.percentile(c_ms, 50):.4f} p95 {np.percentile(c_ms, 95):.4f}, NumPy twin "
          f"p50 {np.percentile(np_ms, 50):.4f} p95 {np.percentile(np_ms, 95):.4f}", flush=True)

    # (e) per-scan wall, after the first chunk / the warm-up scans
    per4 = np.asarray([ms / n for ms, n in chunk_ms[1:]])
    steady = scan_ms[WARMUP:]
    print(f"[smoke] transfer: (e) per-scan wall ms: scan_chunk 4 p50 {np.percentile(per4, 50):.2f} "
          f"p95 {np.percentile(per4, 95):.2f} ({len(per4)} chunks after the first) | one scan a "
          f"dispatch (phase 3) p50 {np.percentile(steady, 50):.2f} p95 "
          f"{np.percentile(steady, 95):.2f}", flush=True)


def _split_phase(dev, cfg, seq, loc1, stamps, acc, gyro, scans, scan_ms, counts, zero, syncs1):
    """Phase 8: the scans of phase 3 with the split update body.  Returns
    (launch counts, the arguments of one captured K8 call)."""
    import torch

    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.models import iekf
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import gain

    cap, o_gain = {}, gain._launch

    def gain_cap(*a):
        if gain.gain.launches == 4 * (WARMUP + 4):   # a steady scan's first evaluation
            cap["gain"] = tuple(t.clone() if torch.is_tensor(t) else t for t in a)
        return o_gain(*a)

    gain._launch = gain_cap
    zero()
    iekf.counters.host_syncs = iekf.counters.loop_fallbacks = iekf.counters.guard_eighs = 0
    loc = Localizer(cfg, device=dev, split_body=True)
    times = _replay_timed(torch, loc, "_dispatch", stamps, acc, gyro, scans)
    gain._launch = o_gain
    c = counts()
    traj, t1 = loc.trajectory, loc1.trajectory
    if len(traj) != len(scans):
        _fail(f"split-body replay has {len(traj)} poses, want {len(scans)}")
    est = loc.positions()
    ate = synthetic.ate_rmse(est, seq.traj.pos(loc.stamps()))
    evals = cfg.ikfom.MAX_NUM_ITERS + 1
    updated = sum(1 for t in traj if t["n_pc2match"] > 1)
    ms = np.asarray([m for m, _ in times])[WARMUP:]
    steady = scan_ms[WARMUP:]
    print(f"[smoke] split: {len(traj)} scans, ATE {ate:.4f} m | launches {json.dumps(c)} | "
          f"n_iters {[t['n_iters'] for t in traj]}", flush=True)
    print(f"[smoke] split: scan ms p50 {np.percentile(ms, 50):.2f} p95 {np.percentile(ms, 95):.2f}"
          f" | host syncs {iekf.counters.host_syncs} | guard eigh calls "
          f"{iekf.counters.guard_eighs} || phase 3: p50 {np.percentile(steady, 50):.2f} p95 "
          f"{np.percentile(steady, 95):.2f} | host syncs {syncs1}", flush=True)
    if c["gain"] != evals * updated or updated != len(scans):
        _fail(f"K8 launched {c['gain']} times, want {evals} for each of {updated} updated scans")
    if any(not 1 <= t["n_iters"] <= evals for t in traj):
        _fail("split body: n_iters outside 1 … max_iters + 1")
    if c["update_body"] or c["update_loop"]:
        _fail(f"split body launched K5 {c['update_body']} / K6 {c['update_loop']} times")
    if iekf.counters.host_syncs != evals * updated:
        _fail(f"split body: {iekf.counters.host_syncs} host reads, want one guard bound an "
              f"evaluation ({evals * updated})")
    for name in ("deskew", "knn_rows", "fit_planes_select", "hstats", "sort3"):
        if c[name] <= 0:
            _fail(f"kernel {name} did not launch on the split-body path")
    if c["fit_planes_select"] != c["gain"]:
        _fail(f"split body: K3 launched {c['fit_planes_select']} times, not once an evaluation")
    if not ate < 0.15:
        _fail(f"split-body ATE {ate:.4f} m >= 0.15 m")
    dpos = dquat = 0.0
    for i, (a, b) in enumerate(zip(traj, t1)):
        dpos = max(dpos, _close(f"split pos, scan {i}", torch.tensor(a["pos"]),
                                torch.tensor(b["pos"]), 1e-3, 2e-4))
        dquat = max(dquat, _close(f"split quat, scan {i}", torch.tensor(a["quat"]),
                                  torch.tensor(b["quat"]), 1e-3, 2e-4))
    print(f"[smoke] split: vs phase 3 (K6, K5 on its fallbacks) max |dpos| {dpos:.3e} m, "
          f"max |dquat| {dquat:.3e} over all {len(traj)} scans", flush=True)
    if "gain" not in cap:
        _fail("no K8 call was captured in the split-body replay")
    return c, cap["gain"]


def _drive(engine, seq, gps_every: float = 0.0):
    """Replay a synthetic sequence in arrival order (then flush); with
    ``gps_every`` seconds > 0, GPS fixes at that period (ground truth plus a
    fixed 2-3 cm offset, as bench.py:190-224 feeds them)."""
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    si, last_gps = 0, -1e9
    for k in range(len(stamps)):
        engine.update_imu(stamps[k], acc[k], gyro[k])
        if gps_every > 0 and stamps[k] - last_gps >= gps_every:
            last_gps = stamps[k]
            gt = seq.traj.pos(np.asarray([stamps[k]]))[0]
            engine.update_gps(stamps[k], gt + 0.02 * np.array([1, -1, 0.5]))
        while si < len(scans) and scans[si][0] <= stamps[k]:
            engine.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
    engine.flush()
    return scans


def _kf_rmse(slam, seq) -> float:
    kfp = np.array([kf.pos for kf in slam.keyframes])
    kgt = seq.traj.pos(np.array([kf.stamp for kf in slam.keyframes]))
    return float(np.sqrt(np.mean(np.sum((kfp - kgt) ** 2, axis=1))))


def _slam_phase(dev, cfg, counts, zero):
    """Phase 9: soak with loop closure, GPS corridor, session + relocalize,
    the CLI.  Returns the soak's keyframe count and ATE, and the pose graph
    (and its iteration count) that the soak's last loop closure optimised."""
    import contextlib
    import io

    import torch

    from fast_limo_tpu_torch import cli
    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.models import pipeline as pl
    from fast_limo_tpu_torch.models import posegraph
    from fast_limo_tpu_torch.models.slam import SLAM
    from fast_limo_tpu_torch.ops import dispatch
    from fast_limo_tpu_torch.utils import presets

    # (a) the soak
    seq = presets.soak_sequence(192)
    slam = SLAM(cfg, presets.soak_loop_cfg())
    slam.loc.evict_radius, slam.loc.evict_occupancy = 30.0, 0.002
    wall = {"detect": [], "optimize": [], "rebuild": []}

    def timed(name, key, nested):
        """Time slam.<name> on the host between two synchronises, less the
        time of the nested calls timed under the keys ``nested``."""
        orig = getattr(slam, name)

        def run(*a):
            torch.cuda.synchronize()
            t, before, loops = time.perf_counter(), sum(map(sum, map(wall.get, nested))), \
                slam.n_loops_closed
            orig(*a)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) - (sum(map(sum, map(wall.get, nested))) - before)
            if key != "detect" or slam.n_loops_closed > loops:   # detections that closed a loop
                wall[key].append(ms)

        setattr(slam, name, run)

    timed("_rebuild_map", "rebuild", ())
    timed("_optimize_and_correct", "optimize", ("rebuild",))
    timed("_detect_loop", "detect", ("optimize", "rebuild"))
    graphs, o_opt = [], posegraph.optimize

    def opt_capture(g, **kw):   # phase 11 (c) takes the last graph
        graphs[:] = [(g, kw["iters"])]
        return o_opt(g, **kw)

    posegraph.optimize = opt_capture
    zero()
    t0 = time.perf_counter()
    try:
        scans = _drive(slam, seq)
    finally:
        posegraph.optimize = o_opt
    torch.cuda.synchronize()
    t_soak = time.perf_counter() - t0
    c = counts()
    est, gt = slam.positions(), seq.traj.pos(slam.stamps())
    kf_rmse, soak_keyframes = _kf_rmse(slam, seq), len(slam.keyframes)
    soak_ate = synthetic.ate_rmse(est, gt)
    tail_rmse = float(np.sqrt(np.mean(np.sum((est[-60:] - gt[-60:]) ** 2, axis=1))))

    def p50(v):
        return f"{np.percentile(v, 50):.1f} (x{len(v)})" if v else "none"

    print(f"[smoke] slam: (a) soak {len(est)} scans in {t_soak:.1f} s (data included) | loops "
          f"{slam.n_loops_closed} | keyframes {len(slam.keyframes)} | map rebuilds "
          f"{slam.n_rebuilds} | keyframe RMSE {kf_rmse:.4f} m | last-60-scan RMSE "
          f"{tail_rmse:.4f} m | ATE {soak_ate:.4f} m | launches {json.dumps(c)}", flush=True)
    print(f"[smoke] slam: (a) wall ms p50: loop detection (ScanContext + ICP + refinement) "
          f"{p50(wall['detect'])} | graph optimise + state correction {p50(wall['optimize'])} | "
          f"map rebuild {p50(wall['rebuild'])}", flush=True)
    if len(est) != seq.n_scans or not np.isfinite(est).all():
        _fail(f"soak has {len(est)} poses or non-finite values")
    if slam.n_loops_closed < 1:
        _fail("the soak closed no loop")
    if not (kf_rmse < 0.3 and tail_rmse < 0.3):
        _fail(f"soak keyframe RMSE {kf_rmse:.4f} m / tail RMSE {tail_rmse:.4f} m (< 0.3 m wanted)")
    for name in ("deskew", "knn_rows", "update_loop", "sort3"):
        if c[name] <= 0:
            _fail(f"kernel {name} did not launch under the SLAM engine")
    if slam.n_rebuilds and c["sort3"] <= 2 * seq.n_scans:
        _fail("the map rebuild's inserts did not go through K9")

    # (c) session: save, load into a fresh engine, relocalize two later scans
    prefix = os.path.join(dispatch.BUILD_DIR, "smoke_session")
    slam.save_session(prefix)
    fresh = SLAM(cfg, presets.soak_loop_cfg())
    fresh.load_session(prefix)
    (sa, pa, _), (sb, pb, _) = scans[150], scans[151]
    res, vel = fresh.relocalize_bootstrap(pa, np.ones(len(pa), bool), sa,
                                          pb, np.ones(len(pb), bool), sb)
    gt_mid = seq.traj.pos(np.asarray([sb + 0.5 / seq.scan_rate]))[0]
    err = float(np.linalg.norm(res.pos - gt_mid))
    on_dev = fresh.loc.state.x.pos.device
    print(f"[smoke] slam: (c) session of {len(fresh.keyframes)} keyframes reloaded on {on_dev} | "
          f"relocalized scans 150/151: success {res.success}, keyframe {res.keyframe_index}, "
          f"sc {res.sc_dist:.3f}, icp rmse {res.icp_rmse:.3f}, |pos − truth at mid-sweep| "
          f"{err:.3f} m, |v| {np.linalg.norm(vel):.2f} m/s", flush=True)
    if not (res.success and err < 0.5):
        _fail("relocalization in the reloaded session failed or is off by >= 0.5 m")
    if not np.allclose(fresh.loc.state.x.pos.cpu().numpy(), res.pos, atol=1e-5):
        _fail("the relocalized pose did not reach the filter state")
    for suffix in (".state.npz", ".keyframes.npz"):
        os.remove(prefix + suffix)

    # (b) the corridor with and without 2 Hz GPS priors
    rmse = {}
    for key, every in (("odo", 0.0), ("gps", 0.5)):
        seq_c = presets.bench_sequence(seed=7, n_scans=48)
        slam_c = SLAM(cfg, presets.corridor_gps_loop_cfg())
        _drive(slam_c, seq_c, gps_every=every)
        rmse[key] = (_kf_rmse(slam_c, seq_c), len(slam_c.keyframes), len(slam_c.gps_factors))
    print(f"[smoke] slam: (b) corridor, 48 scans: keyframe RMSE odometry only "
          f"{rmse['odo'][0]:.4f} m ({rmse['odo'][1]} keyframes) | with 2 Hz GPS "
          f"{rmse['gps'][0]:.4f} m ({rmse['gps'][2]} GPS factors)", flush=True)
    if not (rmse["gps"][2] > 0 and rmse["gps"][0] < rmse["odo"][0]):
        _fail("GPS priors did not lower the corridor's keyframe RMSE")

    # (d) the CLI, in-process, at the default Config() (cfg.debug on); every
    # scan dispatch after the warm-up runs under the sync census
    from fast_limo_tpu_torch.models.localizer import Localizer

    out_path = os.path.join(dispatch.BUILD_DIR, "smoke_cli.tum")
    dump_path = os.path.join(dispatch.BUILD_DIR, "smoke_cli_debug.npz")
    buf, census, seen = io.StringIO(), [], []
    o_dispatch = Localizer._dispatch

    def dispatch_census(self, scan):
        seen.append(bool(self.cfg.debug))
        if len(seen) <= WARMUP:
            return o_dispatch(self, scan)
        census.extend(_sync_calls(lambda: o_dispatch(self, scan))[1])

    Localizer._dispatch = dispatch_census
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["synthetic", "--scans", "24", "--debug-dump", dump_path,
                           "--out", out_path])
    finally:
        Localizer._dispatch = o_dispatch
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc or not lines:
        _fail(f"the CLI returned {rc} and printed no JSON line")
    info = json.loads(lines[-1])
    dump = np.load(dump_path)
    missing = [f for f in pl.DebugOutput._fields if f not in dump.files]
    with open(out_path) as f:
        n_tum = sum(1 for _ in f)
    print(f"[smoke] slam: (d) CLI synthetic --scans 24: {json.dumps(info)} | {n_tum} TUM lines | "
          f"debug dump fields {len(dump.files)} (n_stale {int(dump['n_stale'])}, loop_fallback "
          f"{bool(dump['loop_fallback'])}, matches kept {int(dump['match_keep'].sum())})",
          flush=True)
    if missing or not (info["scans"] == 24 and info["ate_m"] < 0.15 and n_tum == 24):
        _fail(f"CLI run: {info}, {n_tum} TUM lines, missing debug fields {missing}")
    sites = {f: census.count(f) for f in sorted(set(census))}
    print(f"[smoke] slam: (d) CLI dispatches after the first {WARMUP} ({len(seen) - WARMUP}, "
          f"cfg.debug {all(seen)}) under set_sync_debug_mode(\"warn\"): {len(census)} "
          f"synchronizing calls {json.dumps(sites)}", flush=True)
    if not all(seen) or len(seen) <= WARMUP:
        _fail(f"the CLI dispatched {len(seen)} scans, cfg.debug {set(seen)}")
    if _port_syncs(census):
        _fail(f"the CLI's step synchronized the host at port lines {_port_syncs(census)}")
    os.remove(out_path)
    os.remove(dump_path)
    return soak_keyframes, soak_ate, graphs[0] if graphs else None, slam


MAIN_KERNELS = ("deskew", "knn_rows", "fit_planes_select", "hstats", "update_body",
                "update_loop", "sort3")
# The JAX package's ATE on phase 10 (c)'s replay (phase 3's corridor, 24
# sweeps in 4 packets at kitti_like_cfg, 32768 slots) on the CPU: `PYTHONPATH=.
# python tests/test_torch_packet_corridor.py --sweeps 24 --slots 32768`.  The
# reference itself drifts past max(3 x the sweep ATE, 0.15 m) there, so (c)
# also accepts the port within 1.25 x of it, the relative tolerance
# tests/test_torch_packet_corridor.py holds the two packages to.
JAX_PACKET_CORRIDOR_ATE = 0.1872
# (profile, sensor type, standstill s, GPS every n scans): each configs/<p>_tpu.yaml
# in its own sensor's time convention; cat and ona calibrate over 3 s
PROFILES = (("kitti", 1, 0.0, 0), ("utbm", 1, 0.0, 5), ("cat", 1, 3.0, 0), ("ona", 2, 3.0, 0))
DATA_SCANS = 24


def _launched(name, c):
    """Fail unless every kernel of the main path launched on the path ``name``."""
    idle = [k for k in MAIN_KERNELS if c[k] <= 0]
    if idle:
        _fail(f"{name}: kernels {idle} did not launch")


def _cli(argv):
    """cli.main(argv) in-process with its output captured → (stdout, its
    last JSON line as a dict); fails on a non-zero return or no JSON line."""
    import contextlib
    import io

    from fast_limo_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc or not lines:
        _fail(f"the CLI {argv[:2]} returned {rc} and printed no JSON line")
    return buf.getvalue(), json.loads(lines[-1])


def _tum_ate(name, path, n_want, gt_fn):
    """The ATE (m) of a TUM file's positions against ``gt_fn(stamps)``;
    fails on a missing or non-finite pose."""
    from fast_limo_tpu_torch.io import synthetic

    rows = np.loadtxt(path).reshape(-1, 8)
    if len(rows) != n_want or not np.isfinite(rows).all():
        _fail(f"{name}: {len(rows)} poses (want {n_want}) or non-finite values")
    return synthetic.ate_rmse(rows[:, 1:4], gt_fn(rows[:, 0]))


def _timed_dispatches(fn, census):
    """fn() with every Localizer._dispatch timed on the host between two
    synchronises, the dispatches after the first WARMUP under the sync
    census (entries added to ``census``); returns (fn(), [ms])."""
    import torch

    from fast_limo_tpu_torch.models.localizer import Localizer

    ms, orig = [], Localizer._dispatch

    def timed(self, scan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if len(ms) >= WARMUP:
            census.extend(_sync_calls(lambda: orig(self, scan))[1])
        else:
            orig(self, scan)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))

    Localizer._dispatch = timed
    try:
        return fn(), ms
    finally:
        Localizer._dispatch = orig


def _readers_phase(dev, counts, zero, work):
    """Phase 10 (a): make-synthetic → sequence for the four profiles."""
    from fast_limo_tpu_torch.io import synthetic

    repo = os.path.dirname(os.path.abspath(__file__))
    dv = ["--device", dev.type]
    for name, sensor, standstill, gps in PROFILES:
        d, tum = os.path.join(work, name), os.path.join(work, f"{name}.tum")
        _cli(["make-synthetic", "--dir", d, "--scans", str(DATA_SCANS), "--sensor-type",
              str(sensor), "--standstill", str(standstill), "--gps-every", str(gps),
              "--seed", "0"] + dv)
        yaml = os.path.join(repo, "configs", f"{name}_tpu.yaml")
        census = []
        zero()
        (_out, info), ms = _timed_dispatches(
            lambda: _cli(["sequence", "--data", d, "--config", yaml, "--out", tum] + dv), census)
        c = counts()
        synth = synthetic.SyntheticSequence(seed=0, n_scans=DATA_SCANS, points_per_scan=16384)
        ate = _tum_ate(f"sequence {name}", tum, DATA_SCANS,
                       lambda t: synth.traj.pos(t - standstill))
        steady = np.asarray(ms[WARMUP:])
        sites = {f: census.count(f) for f in sorted(set(census))}
        print(f"[smoke] data: (a) {name}_tpu.yaml (sensor {sensor}, standstill {standstill} s, "
              f"GPS every {gps or '-'}): {json.dumps(info)} | {len(ms)} dispatches | ATE "
              f"{ate:.4f} m | scan ms p50 {np.percentile(steady, 50):.2f} p95 "
              f"{np.percentile(steady, 95):.2f} | launches {json.dumps(c)} | census of "
              f"{len(steady)} steady scans: {len(census)} synchronizing calls "
              f"{json.dumps(sites)}", flush=True)
        if info["scans"] != DATA_SCANS or not ate < 0.5:
            _fail(f"sequence {name}: {info['scans']} scans, ATE {ate:.4f} m (< 0.5 m wanted)")
        _launched(f"sequence {name}", c)
        if _port_syncs(census):
            _fail(f"sequence {name}: synchronized the host at port lines {_port_syncs(census)}")
        if name == "ona":   # --async must give the synchronous run's file bit for bit
            tum_a = os.path.join(work, "ona_async.tum")
            _cli(["sequence", "--async", "--data", d, "--config", yaml, "--out", tum_a] + dv)
            with open(tum, "rb") as fs, open(tum_a, "rb") as fa:
                same = fs.read() == fa.read()
            print(f"[smoke] data: (a) {name} --async: TUM "
                  f"{'bit-equal to' if same else 'DIFFERENT from'} the synchronous run's",
                  flush=True)
            if not same:
                _fail("sequence --async differs from the synchronous run")


def _write_kitti_drive(root, synth, n_scans, base="2011-09-26 13:02:25"):
    """The synthetic world in KITTI's raw-sync layout: float32 [x, y, z,
    intensity] .bin scans, OXTS rows (30 columns) with the body-frame
    acceleration in 14:17 and the rates in 20:23, and both timestamps.txt
    files in KITTI's text format.  Returns the stamp of ``base``."""
    import datetime as dt

    t0 = dt.datetime.strptime(base, "%Y-%m-%d %H:%M:%S")

    def stamp_line(t):
        ns = int(round(t * 1e9))
        when = t0 + dt.timedelta(seconds=ns // 10 ** 9)
        return f"{when:%Y-%m-%d %H:%M:%S}.{ns % 10 ** 9:09d}\n"

    vp, ox = os.path.join(root, "velodyne_points"), os.path.join(root, "oxts")
    os.makedirs(os.path.join(vp, "data"), exist_ok=True)
    os.makedirs(os.path.join(ox, "data"), exist_ok=True)
    with open(os.path.join(vp, "timestamps.txt"), "w") as f:
        for i in range(n_scans):
            stamp, pts, _t = synth.scan(i)
            f.write(stamp_line(stamp))
            rows = np.zeros((len(pts), 4), np.float32)
            rows[:, :3] = pts
            rows.tofile(os.path.join(vp, "data", f"{i:010d}.bin"))
    stamps, acc, gyro = synth.imu_stream()
    with open(os.path.join(ox, "timestamps.txt"), "w") as f:
        for k in range(len(stamps)):
            f.write(stamp_line(stamps[k]))
            row = np.zeros(30)
            row[14:17], row[20:23] = acc[k], gyro[k]
            np.savetxt(os.path.join(ox, "data", f"{k:010d}.txt"), row[None], fmt="%.9f")
    return t0.timestamp()


def _kitti_phase(dev, counts, zero, work):
    """Phase 10 (b): a KITTI raw drive written from the synthetic world,
    through the CLI's kitti subcommand at configs/kitti_tpu.yaml."""
    from fast_limo_tpu_torch.io import synthetic

    synth = synthetic.SyntheticSequence(seed=0, n_scans=DATA_SCANS, points_per_scan=120000)
    drive, tum = os.path.join(work, "drive"), os.path.join(work, "kitti_drive.tum")
    base = _write_kitti_drive(drive, synth, DATA_SCANS)
    yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "kitti_tpu.yaml")
    zero()
    t = time.perf_counter()
    _out, info = _cli(["kitti", "--drive", drive, "--config", yaml, "--out", tum,
                       "--device", dev.type])
    wall = time.perf_counter() - t
    c = counts()
    ate = _tum_ate("kitti", tum, DATA_SCANS, lambda s: synth.traj.pos(s - base))
    print(f"[smoke] data: (b) kitti drive, {DATA_SCANS} scans x 120000 points (stride-"
          f"downsampled to the profile's 32768 slots): {json.dumps(info)} in {wall:.1f} s | ATE "
          f"{ate:.4f} m (point times from azimuth, not the world's: no bound) | launches "
          f"{json.dumps(c)}", flush=True)
    if info["scans"] != DATA_SCANS:
        _fail(f"kitti: {info['scans']} scans, want {DATA_SCANS}")
    _launched("kitti", c)


def _packet_phase(dev, cfg, counts, zero, main_ate, full_soak):
    """Phase 10 (c): phase 3's corridor in 4 packets a sweep through SLAM,
    then the soak in 3 (``full_soak``: phase 9's full-sweep keyframe count
    and ATE)."""
    import torch

    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.io.packets import PacketSlicer
    from fast_limo_tpu_torch.models.slam import SLAM
    from fast_limo_tpu_torch.ops import sort
    from fast_limo_tpu_torch.utils import presets

    sizes, o_sort = set(), sort._launch

    def sort_sizes(*a):
        sizes.add(int(a[0].shape[0]))
        return o_sort(*a)

    def replay(slam, seq, n_packets):
        stamps, acc, gyro = seq.imu_stream()
        scans = [seq.scan(i) for i in range(seq.n_scans)]
        slicer, si = PacketSlicer(n_packets=n_packets), 0
        for k in range(len(stamps)):
            slam.update_imu(stamps[k], acc[k], gyro[k])
            while si < len(scans) and scans[si][0] <= stamps[k]:
                for p_pts, p_traw, p_st in slicer.packets(*scans[si][1:], scans[si][0]):
                    slam.update_pointcloud(p_pts, p_traw, p_st)
                si += 1
        slam.flush()
        torch.cuda.synchronize()

    sort._launch = sort_sizes
    try:
        seq = presets.bench_sequence(n_scans=DATA_SCANS)
        slam = SLAM(cfg, device=dev)
        zero()
        t = time.perf_counter()
        replay(slam, seq, 4)
        wall = time.perf_counter() - t
        c = counts()
        est = slam.positions()
        ate = synthetic.ate_rmse(est, seq.traj.pos(slam.stamps()))
        print(f"[smoke] data: (c) corridor, {DATA_SCANS} sweeps in 4 packets: {len(est)} poses "
              f"in {wall:.1f} s ({1e3 * wall / max(len(est), 1):.1f} ms a packet) | ATE "
              f"{ate:.4f} m (full sweeps, phase 3: {main_ate:.4f} m) | keyframes "
              f"{len(slam.keyframes)} | K9 sizes {sorted(sizes)} | launches {json.dumps(c)}",
              flush=True)
        if len(est) != 4 * DATA_SCANS or not np.isfinite(est).all():
            _fail(f"packet corridor: {len(est)} poses (want {4 * DATA_SCANS}) or non-finite")
        want = max(3.0 * main_ate, 0.15, 1.25 * JAX_PACKET_CORRIDOR_ATE)
        print(f"[smoke] data: (c) corridor packet ATE {ate:.4f} m against max(3 x {main_ate:.4f}"
              f", 0.15, 1.25 x JAX's {JAX_PACKET_CORRIDOR_ATE}) = {want:.4f} m; against max(3 x,"
              f" 0.15 m) alone: {'within' if ate < max(3.0 * main_ate, 0.15) else 'over'}",
              flush=True)
        if not ate < want:
            _fail(f"packet corridor ATE {ate:.4f} m >= {want:.4f} m")
        _launched("packet corridor", c)
        cap = max(cfg.tpu.max_points_per_scan,
                  presets.soak_loop_cfg().rebuild_batch * presets.soak_loop_cfg().rebuild_points)

        seq = presets.soak_sequence(192)
        soak = SLAM(cfg, presets.soak_loop_cfg(), device=dev)
        soak.loc.evict_radius, soak.loc.evict_occupancy = 30.0, 0.002
        zero()
        t = time.perf_counter()
        replay(soak, seq, 3)
        wall = time.perf_counter() - t
        c = counts()
        est = soak.positions()
        kf_rmse = _kf_rmse(soak, seq)
        soak_ate = synthetic.ate_rmse(est, seq.traj.pos(soak.stamps()))
        print(f"[smoke] data: (c) soak, {seq.n_scans} sweeps in 3 packets: {len(est)} poses in "
              f"{wall:.1f} s"
              f" | loops {soak.n_loops_closed} | keyframes {len(soak.keyframes)} (full sweeps, "
              f"phase 9: {full_soak[0]}) | map rebuilds {soak.n_rebuilds} | keyframe RMSE "
              f"{kf_rmse:.4f} m | ATE {soak_ate:.4f} m (full sweeps, phase 9: "
              f"{full_soak[1]:.4f} m) | K9 sizes {sorted(sizes)} | launches {json.dumps(c)}",
              flush=True)
        if len(est) != 3 * seq.n_scans or not np.isfinite(est).all():
            _fail(f"packet soak: {len(est)} poses (want {3 * seq.n_scans}) or non-finite")
        if soak.n_loops_closed < 1:
            _fail("the packet soak closed no loop")
        if not len(soak.keyframes) < 1.5 * full_soak[0]:
            _fail(f"packet soak: {len(soak.keyframes)} keyframes >= 1.5 x {full_soak[0]}")
        if not soak_ate < max(3.0 * full_soak[1], 0.15):
            _fail(f"packet soak ATE {soak_ate:.4f} m >= max(3 x {full_soak[1]:.4f}, 0.15) m")
        if max(sizes, default=0) > cap:
            _fail(f"K9 sorted {max(sizes)} elements, more than a scan or a rebuild ({cap}): "
                  f"a stitched sweep was sorted whole")
        _launched("packet soak", c)
    finally:
        sort._launch = o_sort


def _fleet_phase(dev, cfg, counts, zero):
    """Phase 10 (d): four sessions on one card through the batched step."""
    import torch

    from fast_limo_tpu_torch.models import iekf
    from fast_limo_tpu_torch.models import pipeline as pl
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.parallel import batched
    from fast_limo_tpu_torch.utils import presets

    S, TICKS, IDLE, IDLE_TICKS = 4, 12, 2, (4, 5)
    sessions = []
    for seed in range(7, 7 + S):
        loc, cap = Localizer(cfg, device=dev), []
        loc.on_dispatch = lambda sp, ip, cap=cap: cap.append(
            batched.batch_from_packs(cfg, sp, ip, dev))
        presets.replay(loc, presets.bench_sequence(seed=seed, n_scans=TICKS))
        if len(cap) != TICKS:
            _fail(f"fleet: session seed {seed} dispatched {len(cap)} scans, want {TICKS}")
        sessions.append(cap)
    # which batch each session steps on each tick (None: idle)
    plan = [[None if (i == IDLE and k in IDLE_TICKS) else
             k - (len(IDLE_TICKS) if (i == IDLE and k > max(IDLE_TICKS)) else 0)
             for i in range(S)] for k in range(TICKS)]
    step = batched.build_batched_scan_step(cfg, dev)
    noop = batched.noop_batch(cfg, dev)
    on = torch.ones(S, dtype=torch.bool, device=dev)
    idle = torch.tensor([i != IDLE for i in range(S)], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    states = batched.init_batched_state(cfg, S, dev)
    state_bytes = _nbytes(batched.select_session(states, 0))
    zero()
    iekf.counters.loop_fallbacks = 0
    census, tick_ms, poses, frozen = [], [], [], None
    for k in range(TICKS):
        bb = batched.stack_batches([noop if j is None else sessions[i][j]
                                    for i, j in enumerate(plan[k])])
        act = idle if None in plan[k] else on
        torch.cuda.synchronize()
        t = time.perf_counter()
        if k:
            (states, outs), syncs = _sync_calls(lambda: step(states, bb, act))
            census.extend(syncs)
        else:
            states, outs = step(states, bb, act)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t))
        poses.append((outs.pos, outs.quat))
        if k + 1 == min(IDLE_TICKS):
            frozen = [t_.clone() for t_ in _leaves(batched.select_session(states, IDLE))]
        elif k in IDLE_TICKS:
            now = _leaves(batched.select_session(states, IDLE))
            if not all(torch.equal(a, b) for a, b in zip(frozen, now)):
                _fail(f"fleet: the idle session's state changed on tick {k}")
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    fallbacks = iekf.counters.loop_fallbacks
    # every session's poses against its own single-session steps
    inner = pl.build_scan_step(cfg, dev)
    for i in range(S):
        s = pl.init_state(cfg, dev)
        for k in range(TICKS):
            j = plan[k][i]
            if j is None:
                continue
            s, out = inner(s, sessions[i][j])
            pos, quat = poses[k]
            if not (torch.equal(out.pos, pos[i]) and torch.equal(out.quat, quat[i])):
                _fail(f"fleet: session {i} tick {k} differs from its single-session step")
    # cudaLaunchKernel calls a tick, from the profiler over two more ticks
    from torch.profiler import ProfilerActivity, profile

    bb = batched.stack_batches([sessions[i][-1] for i in range(S)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(states, bb, on)
        torch.cuda.synchronize()
    host = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    dev_ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n_launch = sum(e.count for e in host if e.key.startswith("cudaLaunchKernel")) / 2
    busy = sum(e.self_device_time_total for e in dev_ev) / 2 / 1e3 if dev_ev else None
    steady = np.asarray(tick_ms[1:])
    full = np.asarray([m for k, m in enumerate(tick_ms) if k and None not in plan[k]])
    sites = {f: census.count(f) for f in sorted(set(census))}
    print(f"[smoke] data: (d) fleet S = {S}, {TICKS} ticks (session {IDLE} idle on ticks "
          f"{list(IDLE_TICKS)}): every session bit-equal to its single-session steps, the idle "
          f"state bit-equal across its idle ticks | tick ms p50 {np.percentile(steady, 50):.2f}"
          f" p95 {np.percentile(steady, 95):.2f} (first {tick_ms[0]:.1f}) | ms a session-scan "
          f"p50 {np.percentile(full, 50) / S:.2f} | cudaLaunchKernel {n_launch:.0f} a tick "
          f"({n_launch / S:.0f} a session-scan), device busy {_fmt(busy)} a tick | peak memory "
          f"{peak / 2 ** 20:.1f} MiB over the states' {S} x {state_bytes / 2 ** 20:.1f} MiB | "
          f"loop fallbacks {fallbacks} in {S * TICKS} session-steps", flush=True)
    per_tick = {k: v / TICKS for k, v in c.items() if v}
    print(f"[smoke] data: (d) fleet launches {json.dumps(c)} ({json.dumps(per_tick)} a tick) | "
          f"census of {TICKS - 1} ticks: {len(census)} synchronizing calls {json.dumps(sites)}",
          flush=True)
    if c["update_loop"] != S * TICKS:
        _fail(f"fleet: K6 launched {c['update_loop']} times, want {S * TICKS} (a session a tick)")
    _launched("fleet", c)
    if _port_syncs(census):
        _fail(f"fleet: the batched step synchronized the host at port lines {_port_syncs(census)}")


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _entry_phase(dev, counts, zero):
    """Phase 10 (e): the entry() twin, one step on the card."""
    import torch

    from fast_limo_tpu_torch import entry

    step, (state, batch) = entry.entry(device=dev)
    zero()
    s2, out = step(state, batch)
    torch.cuda.synchronize()
    c = counts()
    finite = all(bool(torch.isfinite(t).all()) for t in (out.pos, out.quat, out.vel, s2.P))
    pos = np.array2string(out.pos.cpu().numpy(), precision=6)
    print(f"[smoke] data: (e) entry(): pos {pos}, n_iters "
          f"{int(out.n_iters)}, map points {int(s2.map.num_points)} | launches {json.dumps(c)}",
          flush=True)
    if not finite or int(s2.map.num_points) <= 0:
        _fail("entry(): non-finite outputs or an empty map")
    _launched("entry()", c)


def _data_phase(dev, cfg, counts, zero, main_ate, soak):
    """Phase 10: the data readers, the CLI, packets, the fleet, entry()."""
    import shutil

    from fast_limo_tpu_torch.ops import dispatch

    work = os.path.join(dispatch.BUILD_DIR, "smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        _readers_phase(dev, counts, zero, work)
        _kitti_phase(dev, counts, zero, work)
        _packet_phase(dev, cfg, counts, zero, main_ate, soak)
        _fleet_phase(dev, cfg, counts, zero)
        _entry_phase(dev, counts, zero)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The JAX package's own gap between its sharded step and its single-card
# step at the same global capacity, on phase 3's 24 scans at
# kitti_like_cfg (32768 slots), the largest |dpos| (m) and |dquat| over
# the scans, on the CPU (virtual devices): `PYTHONPATH=. python
# tests/test_torch_shard_corridor.py --scans 24 --slots 32768`.  Phase 11
# holds the port's sharded step to max(3e-4 m / 3e-5, 1.25 x that gap)
# against phase 3; 3e-4 m / 3e-5 are phase 7's bounds
# (tests/test_pipeline.py:254-256).
JAX_SHARD_GAP = {"map4": {"pos": 0.0, "quat": 0.0},
                 "map2xdata2": {"pos": 0.0026721954345703125, "quat": 1.0334333637729287e-05}}
SHARD_FLOOR = {"pos": 3e-4, "quat": 3e-5}


def _shard_bounds(key: str) -> dict:
    return {k: max(SHARD_FLOOR[k], 1.25 * JAX_SHARD_GAP[key][k]) for k in SHARD_FLOOR}


def _shard_run(dev, cfg, mesh, state, batches, counts, census_from, hold=None):
    """Phase 3's batches through the sharded step on ``mesh`` at the
    per-shard capacity map_capacity / n_map, from ``state`` (phase 3's
    initial state: its empty map has the global capacity, the sharded
    step's layout): per-scan wall ms, poses, num_points, the tables after
    scan 1 and the state after scan 12, the synchronizing calls of every
    scan from ``census_from`` on, the kernel counts, peak memory and
    cudaLaunchKernel a scan (profiler, two more scans)."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_limo_tpu_torch.parallel import sharded

    n_map = mesh.axes[sharded.AXIS]
    cfg_s = copy.deepcopy(cfg)
    cfg_s.tpu.map_capacity = cfg.tpu.map_capacity // n_map
    cfg_s.tpu.num_map_shards = n_map
    step, _ = sharded.build_sharded_scan_step(cfg_s, mesh, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mesh.reset_received()
    r = {"ms": [], "pos": [], "quat": [], "npts": [], "census": [], "cfg": cfg_s, "step": step}
    for i, b in enumerate(batches):
        if hold is not None:
            hold["scan"] = i
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i >= census_from:
            (state, out), syncs = _sync_calls(lambda: step(state, b))
            r["census"].extend(syncs)
        else:
            state, out = step(state, b)
        torch.cuda.synchronize()
        r["ms"].append(1e3 * (time.perf_counter() - t))
        r["pos"].append(out.pos)
        r["quat"].append(out.quat)
        r["npts"].append(state.map.num_points)
        if i == 0:
            r["tab1"] = (state.map.table.clone(), state.map.ptable.clone())
        if i == 11:
            r["s12"] = state
    r["peak"] = torch.cuda.max_memory_allocated(dev) - base
    r["received"] = [mesh.received(k) for k in range(mesh.size)]
    r["counts"] = counts()
    if hold is not None:
        hold["scan"] = None
    r["pos"] = torch.stack(r["pos"]).double().cpu().numpy()
    r["quat"] = torch.stack(r["quat"]).double().cpu().numpy()
    r["npts"] = [int(n) for n in torch.stack(r["npts"]).cpu()]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, batches[-1])
        torch.cuda.synchronize()
    r["launch"] = sum(e.count for e in prof.key_averages()
                      if e.key.startswith("cudaLaunchKernel")) / 2
    return r


def _shard_check(tag, r, key, p3, model, n_scans):
    """The checks (a) and (b) share: the tables after scan 1 bit-equal to
    phase 3's, the poses within the bound, the census, and the received
    bytes term by term against comm_volume (the cap gather and the gate
    psums a third: the port finishes the selected branch once)."""
    import torch

    from fast_limo_tpu_torch.io import synthetic

    if not (torch.equal(r["tab1"][0], p3["tab1"][0]) and torch.equal(r["tab1"][1], p3["tab1"][1])):
        _fail(f"shard: {tag} the shards after scan 1 differ from phase 3's table/ptable")
    dpos = float(np.abs(r["pos"] - p3["pos"]).max())
    dquat = float(np.abs(r["quat"] - p3["quat"]).max())
    bound = _shard_bounds(key)
    ate = synthetic.ate_rmse(r["pos"], p3["gt"])
    steady = np.asarray(r["ms"][WARMUP:])
    sites = {f: r["census"].count(f) for f in sorted(set(r["census"]))}
    print(f"[smoke] shard: {tag} {n_scans} scans | tables after scan 1 equal phase 3's bit for "
          f"bit | vs phase 3 max |dpos| {dpos:.3e} m, max |dquat| {dquat:.3e} (bounds "
          f"{bound['pos']:.1e} / {bound['quat']:.1e}: max(3e-4 / 3e-5, 1.25 x JAX's "
          f"{JAX_SHARD_GAP[key]['pos']:.3e} / {JAX_SHARD_GAP[key]['quat']:.3e}) | ATE "
          f"{ate:.4f} m (phase 3 {synthetic.ate_rmse(p3['pos'], p3['gt']):.4f} m) | scan ms p50 "
          f"{np.percentile(steady, 50):.2f} p95 {np.percentile(steady, 95):.2f} (first "
          f"{r['ms'][0]:.1f}) | cudaLaunchKernel {r['launch']:.0f} a scan | peak memory "
          f"{r['peak'] / 2 ** 20:.1f} MiB | census of {n_scans - WARMUP} scans: "
          f"{len(r['census'])} synchronizing calls {json.dumps(sites)}", flush=True)
    per_scan = [{k: v / n_scans for k, v in rec.items()} for rec in r["received"]]
    print(f"[smoke] shard: {tag} received bytes a scan, rank 0 {json.dumps(per_scan[0])} | "
          f"comm_volume {json.dumps(model)}", flush=True)
    if dpos > bound["pos"] or dquat > bound["quat"] or not ate < 0.15:
        _fail(f"shard: {tag} poses off phase 3's by {dpos:.3e} m / {dquat:.3e} or ATE {ate:.4f}")
    if _port_syncs(r["census"]):
        _fail(f"shard: {tag} the sharded step synchronized the host at port lines "
              f"{_port_syncs(r['census'])}")
    for rank, got in enumerate(per_scan):
        for k in ("knn_allgather_bytes", "hstats_psum_bytes", "cert_psum_bytes",
                  "num_points_psum_bytes", "cap_allgather_bytes", "gate_psum_bytes"):
            want = model[k] / 3 if k in ("cap_allgather_bytes", "gate_psum_bytes") else model[k]
            if abs(got.get(k, 0) - want) > 1e-6 * max(want, 1):
                _fail(f"shard: {tag} rank {rank} received {got.get(k, 0)} bytes of {k} a scan, "
                      f"the model {want}")


def _shard_phase(dev, cfg, seq, loc, counts, zero, report, rows_out, soak_graph):
    """Phase 11: the multi-device layer on the one card, in-process backend."""
    import torch

    from fast_limo_tpu_torch import entry
    from fast_limo_tpu_torch.models import iekf, measurement, posegraph
    from fast_limo_tpu_torch.models import pipeline as pl
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import dispatch, hstats, knn, plane_kernel, update_body
    from fast_limo_tpu_torch.parallel import batched, distributed, sharded
    from fast_limo_tpu_torch.utils import presets

    # phase 3's batches, tables after scan 1 and num_points after every scan,
    # from a second replay at its configuration (poses equal to phase 3's)
    ref, packs, npts, tab1, init = Localizer(cfg, device=dev), [], [], [], []
    ref.on_dispatch = lambda sp, ip: packs.append((np.array(sp), np.array(ip)))
    o_disp, o_step = ref._dispatch, ref.scan_step

    def step_capture(s, *a):
        if not init:
            init.append(s)
        return o_step(s, *a)

    def disp(scan):
        o_disp(scan)
        npts.append(ref.state.map.num_points.clone())
        if not tab1:
            tab1.append((ref.state.map.table.clone(), ref.state.map.ptable.clone()))

    ref._dispatch, ref.scan_step = disp, step_capture
    presets.replay(ref, seq)
    if not np.array_equal(ref.positions(), loc.positions()):
        _fail("shard: a second replay of phase 3 differs from phase 3")
    n_scans = len(packs)
    p3 = {"pos": loc.positions(), "quat": np.stack([t["quat"] for t in loc.trajectory]),
          "npts": [int(n) for n in npts], "tab1": tab1[0], "gt": seq.traj.pos(loc.stamps())}
    batches = [batched.batch_from_packs(cfg, sp, ip, dev) for sp, ip in packs]
    evals = cfg.ikfom.MAX_NUM_ITERS + 1

    # (a) map axis, D = 4.  K7's dense entry serves three call sites a rank:
    # the window resolve (k = W), and each evaluation's stale patch (the
    # budget's queries) and full re-gather (every query) at k; its launches
    # in the 24 scans are counted by site, and each site's first call is
    # captured in one more step from scan 12's state, after the measured
    # run (so the held inputs stay out of its peak memory)
    D = 4
    mesh = sharded.make_mesh(D)
    hold, o_k7 = {"scan": None}, knn._launch
    k_match = cfg.ikfom.mapping.NUM_MATCH_POINTS
    sites = {"window": 0, "patch": 0, "full": 0}

    def k7_site(n_queries, k):
        if k > k_match:
            return "window"
        return "patch" if n_queries == measurement.STALE_BUDGET else "full"

    def k7_capture(cand_pts, cand_valid, queries, *, k):
        site = k7_site(queries.shape[0], k)
        if isinstance(hold["scan"], int):     # the 24 scans
            sites[site] += 1
        if hold["scan"] == "capture" and site not in hold:
            hold[site] = (cand_pts.clone(), cand_valid.clone(), queries.clone(), k)
        return o_k7(cand_pts, cand_valid, queries, k=k)

    knn._launch = k7_capture
    zero()
    iekf.counters.loop_fallbacks = 0
    try:
        ra = _shard_run(dev, cfg, mesh, init[0], batches, counts, WARMUP, hold)
        fb = iekf.counters.loop_fallbacks
        hold["scan"] = "capture"
        ra["step"](ra["s12"], batches[12])
    finally:
        knn._launch = o_k7
    ca = ra["counts"]
    print(f"[smoke] shard: (a) 'map' = {D}, in-process ranks on {torch.cuda.get_device_name(0)}, "
          f"{cfg.tpu.map_capacity // D} entries a shard | launches {json.dumps(ca)} "
          f"({ca['masked_topk'] / n_scans:.0f} dense K7 a scan; by site {json.dumps(sites)}) | "
          f"loop fallbacks {fb} (rank-scans) | num_points equal phase 3's after every scan: "
          f"{ra['npts'] == p3['npts']}", flush=True)
    _shard_check("(a)", ra, "map4", p3, sharded.comm_volume(ra["cfg"], D, 1), n_scans)
    if ra["npts"] != p3["npts"]:
        _fail(f"shard: (a) num_points {ra['npts']} differ from phase 3's {p3['npts']}")
    if ca["update_loop"] != D * n_scans:
        _fail(f"shard: (a) K6 launched {ca['update_loop']} times, want {D * n_scans}")
    if ca["knn_rows"]:
        _fail(f"shard: (a) K2 launched {ca['knn_rows']} times on the sharded path")
    for name in ("masked_topk", "sort3", "deskew", "fit_planes_select", "hstats",
                 "update_body"):
        if ca[name] <= 0:
            _fail(f"shard: (a) kernel {name} did not launch")
    want_sites = {"window": D * n_scans, "patch": D * evals * n_scans,
                  "full": D * evals * n_scans}
    if sites != want_sites or sum(sites.values()) != ca["masked_topk"]:
        _fail(f"shard: (a) K7's launches by site {sites} (of {ca['masked_topk']}), want "
              f"{want_sites}")

    # K7's dense entry at each of (a)'s call sites, on one rank's captured
    # inputs: bit-equal to its plain version, timed; each row carries its
    # site's launches
    what = {"window": "window resolve (its owned candidates)",
            "patch": "stale patch of the budget's queries",
            "full": "full re-gather of every query"}
    for site in ("window", "patch", "full"):
        if site not in hold:
            _fail(f"shard: (a) no {site} call of K7 was captured")
        cand, cval, q7, k7 = hold.pop(site)
        g = _once(f"K7 (shard {site})", knn.masked_topk,
                  lambda: knn.masked_topk(cand, cval, q7, k=k7))
        _held(f"K7 (shard {site})", g, knn.masked_topk_reference(cand, cval, q7, k=k7))
        N7, C7 = cval.shape
        n_valid = int(cval.sum())
        d2 = knn.masked_d2(cand, cval, q7)
        report(f"masked_topk (shard {site})", 0.0, lambda: knn.masked_topk(cand, cval, q7, k=k7),
               lambda: knn.masked_topk_reference(cand, cval, q7, k=k7),
               N7 * C7 + 12 * n_valid + _nbytes(q7, *g), 8 * n_valid,
               lambda: torch.topk(d2, k7, dim=1, largest=False),
               f"(N={N7}, C={C7}, k={k7}, {n_valid / (N7 * C7):.3f} valid: one rank's "
               f"{what[site]} in (a); {sites[site] / n_scans:.0f} launches a scan)",
               launches=sites[site], kernel="masked_topk")
        del cand, cval, d2

    # (c) the pose graph of phase 9's last loop closure, edges over 4 ranks
    # and on one: in float32 (the engine's dtype) and cast to float64
    if soak_graph is None:
        _fail("shard: (c) phase 9 optimised no pose graph")
    pgraph, iters = soak_graph

    def timed(fn):   # the second of two calls
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def both(g):
        return (timed(lambda: posegraph.optimize(g, iters=iters)),
                timed(lambda: posegraph.optimize_distributed(g, sharded.make_mesh(4),
                                                             iters=iters)))

    def rtol(a, b):
        return float(((a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-300)).max())

    ((g1, c1), ms1), ((g4, c4), ms4) = both(pgraph)
    g64 = pgraph._replace(**{f: getattr(pgraph, f).double() for f in pgraph._fields
                             if getattr(pgraph, f).is_floating_point()})
    ((h1, d1), _), ((h4, d4), _) = both(g64)
    dt, dt64 = float((g4.trans - g1.trans).abs().max()), float((h4.trans - h1.trans).abs().max())
    e4 = rtol(c4, d1)

    def reordered(seed):   # the same graph with its edge slots in another order
        p = torch.from_numpy(np.random.default_rng(seed).permutation(pgraph.edge_i.shape[0]))
        p = p.to(pgraph.edge_i.device)
        return pgraph._replace(**{f: getattr(pgraph, f)[p] for f in pgraph._fields
                                  if f.startswith("edge_")})

    # one rank's own float32 error: its largest over the given edge order
    # and four others (a float32 sum's rounding depends on the order, and
    # the card's index_add_ orders by its atomics), so that the bound is
    # not one draw of that noise
    e1s = [rtol(c1, d1)] + [rtol(posegraph.optimize(reordered(s), iters=iters)[1], d1)
                            for s in range(4)]
    e1 = max(e1s)
    print(f"[smoke] shard: (c) pose graph of phase 9's last loop closure ({int(pgraph.n_nodes)} "
          f"nodes, {int(pgraph.n_edges)} edges of {pgraph.edge_i.shape[0]}, {iters} iterations), "
          f"edges over 4 ranks vs one | float64: max |dtrans| {dt64:.3e} m, cost rtol "
          f"{rtol(d4, d1):.3e} (bounds 1e-4, 1e-4) | float32: max |dtrans| {dt:.3e} m (1e-4), "
          f"cost rtol {rtol(c4, c1):.3e} to each other, against float64 one rank "
          f"{e1:.3e} (largest of {len(e1s)} edge orders: {', '.join(f'{e:.3e}' for e in e1s)}) "
          f"/ four ranks {e4:.3e} (bound max(1e-4, 2 x one rank's)) | costs "
          f"{[float(c) for c in c1]} | wall ms (float32) optimize {ms1:.1f}, "
          f"optimize_distributed {ms4:.1f}", flush=True)
    if not (dt64 <= 1e-4 and rtol(d4, d1) <= 1e-4 and dt <= 1e-4 and e4 <= max(1e-4, 2 * e1)):
        _fail("shard: (c) the edge-sharded pose graph differs from the single one")

    # (d) checkpoint across topologies: (a)'s state after scan 12 -> a
    # single-card Localizer -> back onto D = 4; one more step from the live
    # and from the restored state
    path = os.path.join(dispatch.BUILD_DIR, "smoke_shard.npz")
    path1 = os.path.join(dispatch.BUILD_DIR, "smoke_shard_single.npz")
    s12, step_a = ra["s12"], ra["step"]
    distributed.save_checkpoint(path, s12, mesh)
    one = Localizer(cfg, device=dev)
    one.load_checkpoint(path)
    one.save_checkpoint(path1)
    restored = distributed.load_checkpoint(
        path1, sharded.init_global_state(ra["cfg"], D, dev), mesh)
    s_live, o_live = step_a(s12, batches[12])
    s_rest, o_rest = step_a(restored, batches[12])
    _, o_one = pl.build_scan_step(cfg, dev)(one.state, batches[12])
    equal = (torch.equal(o_live.pos, o_rest.pos) and torch.equal(o_live.quat, o_rest.quat)
             and torch.equal(s_live.map.table, s_rest.map.table)
             and torch.equal(s_live.P, s_rest.P)
             and int(s_live.map.num_points) == int(s_rest.map.num_points))
    d_one = float((o_one.pos - o_live.pos).abs().max())
    print(f"[smoke] shard: (d) (a)'s state after scan 12 saved by distributed.save_checkpoint "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB), loaded into a single-card Localizer "
          f"({one.state.map.capacity} entries) and back onto D = {D}: scan 13 from the live "
          f"and the restored state bit-equal {equal} | the single card's scan 13 from the "
          f"same file: max |dpos| {d_one:.3e} m", flush=True)
    for p in (path, path1):
        os.remove(p)
    if not equal or d_one > _shard_bounds("map4")["pos"]:
        _fail("shard: (d) the checkpoint continuation differs")
    del ra, s12, restored, s_live, s_rest, one

    # (e) the dryrun twin
    legs = entry.dryrun_multichip(4, dev)
    print(f"[smoke] shard: (e) entry.dryrun_multichip(4): the 1-D and 2-D meshes in-process on "
          f"{dev}, the two-process leg on CPU processes (torch.distributed, gloo; it does not "
          f"run on the card: one card cannot host two NCCL ranks) | legs {sorted(legs)}",
          flush=True)
    if sorted(legs) != ["1d", "2d", "processes"]:
        _fail(f"shard: (e) the dryrun ran legs {sorted(legs)}")

    # (b) 'map' 2 x 'data' 2 (run last: (d) takes (a)'s state); the first
    # K3 (select entry), K4 and K5 call of one more step from scan 12's
    # state captured after the measured run: K3 and K4 work on a rank's
    # query slice
    mesh2 = sharded.make_mesh_2d(2, 2)
    hold2 = {"scan": None}
    o_k3, o_k4, o_k5 = plane_kernel._launch_select, hstats._launch, update_body._launch

    def capture(key, launch, n_args):   # (positional args, kwargs, active flag)
        def cap(*a, **kw):
            if hold2["scan"] == "capture":
                hold2.setdefault(key, (a[:n_args], kw, a[n_args] if len(a) > n_args else None))
            return launch(*a, **kw)
        return cap

    plane_kernel._launch_select, hstats._launch, update_body._launch = (
        capture("k3", o_k3, 6), capture("k4", o_k4, 2), capture("k5", o_k5, 7))
    zero()
    try:
        rb = _shard_run(dev, cfg, mesh2, init[0], batches, counts, WARMUP, hold2)
        hold2["scan"] = "capture"
        rb["step"](rb["s12"], batches[12])
    finally:
        plane_kernel._launch_select, hstats._launch, update_body._launch = o_k3, o_k4, o_k5
    cb = rb["counts"]
    dn = max(abs(a - b) for a, b in zip(rb["npts"], p3["npts"]))
    print(f"[smoke] shard: (b) 'map' 2 x 'data' 2 | launches {json.dumps(cb)} | num_points vs "
          f"phase 3's: max |diff| {dn} (last {rb['npts'][-1]} vs {p3['npts'][-1]})", flush=True)
    _shard_check("(b)", rb, "map2xdata2", p3, sharded.comm_volume(rb["cfg"], 2, 2), n_scans)
    if any(abs(a - b) > 0.05 * max(a, b) for a, b in zip(rb["npts"], p3["npts"])):
        _fail("shard: (b) num_points off phase 3's by more than 5 %")
    if cb["update_loop"]:
        _fail(f"shard: (b) K6 launched {cb['update_loop']} times under query sharding")
    for name in ("fit_planes_select", "hstats", "update_body"):
        if cb[name] != mesh2.size * evals * n_scans:
            _fail(f"shard: (b) {name} launched {cb[name]} times, want "
                  f"{mesh2.size * evals * n_scans} (every rank, every evaluation, every scan)")
    del rb
    for key in ("k3", "k4", "k5"):
        if key not in hold2:
            _fail(f"shard: (b) no {key.upper()} call was captured")
        if hold2[key][2] is not None and not bool(hold2[key][2]):
            _fail(f"shard: (b) the captured {key.upper()} call ran with its flag clear")

    # K3's select entry (at the captured branch code and at codes 0, 1 and
    # budget + 1, the sharded re-match's three), K4 and K5 on (b)'s captured
    # inputs, held to their plain versions with phase 5's tolerances; the
    # rows carry (b)'s launches
    (win, patch, idx, stale, full, viol), fkw, _ = hold2.pop("k3")
    sel = (win, patch, idx, stale, full, viol)
    N3 = win[0].shape[0]
    errs, agrees = [], []
    for code in (None, 0, 1, min(measurement.STALE_BUDGET, N3) + 1):
        sel_c = sel if code is None else sel[:5] + (torch.tensor(code, dtype=torch.int32,
                                                                 device=dev),)
        a = _once("K3 select (shard slice)", plane_kernel.fit_planes_select,
                  lambda: plane_kernel.fit_planes_select(*sel_c, **fkw))
        e, g = _k3_check(f"K3 select (shard slice, code {code})", a,
                         plane_kernel.fit_planes_select_plain(*sel_c, **fkw))
        errs.append(e)
        agrees.append(g)
    a = plane_kernel.fit_planes_select(*sel, **fkw)
    err, agree = max(errs), min(agrees)
    report("fit_planes_select (shard slice)", err,
           lambda: plane_kernel.fit_planes_select(*sel, **fkw),
           lambda: plane_kernel.fit_planes_select_plain(*sel, **fkw),
           _nbytes(win, patch, idx, stale, viol, *a), 250 * N3,
           extra=f"(N={N3}, B={idx.shape[0]}, one rank's query slice in (b), branch code "
                 f"{int(viol)}; held at codes 0, 1 and budget + 1 too, gate agreement at "
                 f"least {agree:.5f})",
           launches=cb["fit_planes_select"], kernel="fit_planes_select", prefix="fl_fit_planes")
    (X4, sc4), hkw, _ = hold2.pop("k4")
    a = _once("K4 (shard slice)", hstats.hstats, lambda: hstats.hstats(X4, sc4, **hkw))
    err, H4 = _k4_check("K4 (shard slice)", a, hstats.hstats_plain(X4, sc4, **hkw), X4, sc4, hkw)
    report("hstats (shard slice)", err, lambda: hstats.hstats(X4, sc4, **hkw),
           lambda: hstats.hstats_plain(X4, sc4, **hkw), _nbytes(X4, sc4, *a),
           290 * H4.shape[0], lambda: torch.matmul(H4.T, H4),
           f"(Np={H4.shape[0]}, one rank's query slice in (b), before the psum)",
           launches=cb["hstats"], kernel="hstats")
    ba = hold2.pop("k5")[0]
    a = _once("K5 (shard slice)", update_body.update_body, lambda: update_body.update_body(*ba))
    err = _k5_check("K5 (shard slice)", a, update_body.update_body_plain(*ba))
    report("update_body (shard slice)", err, lambda: update_body.update_body(*ba),
           lambda: update_body.update_body_plain(*ba), _nbytes(*ba, *a), 3e5,
           extra="(one rank's iteration in (b), after the HTH psum)",
           launches=cb["update_body"], kernel="update_body")


# The JAX package's ATE on phase 12 (a)'s replay (presets.ouster128_sequence,
# 24 scans of 262 144 returns at presets.ouster128_cfg), on the CPU:
#   PYTHONPATH=. python tests/test_torch_wide_scan.py --slots 262144 --scans 24
# (the port's plain versions there: 0.00849 m, max |dpos| 1.4e-4 m)
JAX_WIDE_ATE = 0.00848
WIDE_PROFILED = 4   # scans of (a) under torch.profiler, after the warm-up
# the sizes at which both K9 routes are timed, both forms, to place the switch
K9_CROSSOVER_N = (1024, 4096, 10000, 16384, 24576, 32768, 65536, 98304, 1 << 17)
K9_WIDE_INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "k9_wide.npz")   # phase 12's captured sorts, for k9_phases.py


def _k9_seeded(torch, dev, form, N, seed):
    """Seeded K9 operands of a caller's form: "voxel" (an int32 voxel key
    with a fifth of it marked invalid, arange, arange: 4 passes over k1) or
    "insert" (a group index with invalid marks, a packed 30-bit voxel,
    arange: 8 passes over k1 and k2)."""
    rng = np.random.default_rng(seed)
    ar = np.arange(N, dtype=np.int32)
    if form == "voxel":
        k1 = rng.integers(0, 1 << 30, N).astype(np.int32)
        k2 = ar
    else:
        k1 = rng.integers(0, max(N // 8, 1), N).astype(np.int32)
        k2 = rng.integers(0, 1 << 30, N).astype(np.int32)
    k1[rng.random(N) < 0.2] = np.iinfo(np.int32).max
    return [torch.tensor(x, device=dev) for x in (k1, k2, ar)]


def _k9_crossover(torch, dev, sort):
    """Both K9 routes at each of K9_CROSSOVER_N, both forms: device ms of
    one call (torch.profiler, the median of three sessions of 5 calls), each
    held bit-equal to the plain version → ({(N, form): (cluster ms, grid
    ms)}, the largest N at which the cluster kernel wins in both forms, or
    0)."""
    table, upto = {}, 0
    for N in K9_CROSSOVER_N:
        for form in ("voxel", "insert"):
            ops = _k9_seeded(torch, dev, form, N, N)
            want = sort.sort3_plain(*ops)
            ms = []
            for grid, prefix in ((False, "fl_sort3_kernel"), (True, "fl_sort3_grid")):
                got = sort._launch(*ops, grid=grid)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    _fail(f"K9 crossover: the {prefix} route at N = {N} ({form}) differs from "
                          f"the plain version")
                runs = [_device_ms(lambda: sort._launch(*ops, grid=grid), prefix)
                        for _ in range(3)]
                runs = [x for x in runs if x is not None]
                ms.append(float(np.median(runs)) if runs else None)
            table[N, form] = tuple(ms)
        if all(None not in table[N, f] and table[N, f][0] < table[N, f][1]
               for f in ("voxel", "insert")):
            upto = N
    return table, upto


def _k9_row(torch, report, name, k1, k2, v, launches, form):
    """A K9 row of the wide phase: all three outputs bit-equal to the plain
    version, one CUDA kernel a call (the grid kernel above the switch, the
    cluster kernel at or below it), with both one-call yardsticks: torch.sort
    of the int32 key with its indices, and of the int64 key (k1 << 30) | k2;
    the form's own is the row's library call."""
    from fast_limo_tpu_torch.ops import sort

    N = int(k1.shape[0])
    grid = N > sort.CLUSTER_MAXN
    g0 = sort.sort3.grid_launches
    a = _once(f"K9 {name}", sort.sort3, lambda: sort.sort3(k1, k2, v))
    if sort.sort3.grid_launches != g0 + int(grid):
        _fail(f"K9 {name}: N = {N} did not take the {'grid' if grid else 'cluster'} kernel")
    for i, (g, w) in enumerate(zip(a, sort.sort3_plain(k1, k2, v))):
        if not torch.equal(g, w):
            _fail(f"K9 {name}: output {i} differs from the plain version")
    prefix = "fl_sort3_grid" if grid else "fl_sort3_kernel"
    n_cuda, n_mine = (_cuda_launches(torch, lambda: sort.sort3(k1, k2, v), p, tries=3, reps=5)
                      for p in ("fl_sort3", prefix))
    if n_cuda != 1 or n_mine != 1:
        _fail(f"K9 {name} ran {n_cuda} CUDA kernels a call ({n_mine} named {prefix}), not one")
    packed = (k1.long() << 30) | k2.long()
    calls = {"voxel": lambda: torch.sort(k1, stable=True),
             "insert": lambda: torch.sort(packed, stable=True)}
    other = "insert" if form == "voxel" else "voxel"
    oms, odms = _time_ms(calls[other]), _device_ms(calls[other])
    report(name, 0.0, lambda: sort.sort3(k1, k2, v), lambda: sort.sort3_plain(k1, k2, v),
           24 * N, 0, calls[form],
           f"(N={N}, {form} form, {'grid' if grid else 'cluster'} kernel, 1 CUDA kernel a "
           f"call; the {other} form's one call {oms:.4f} ms (device {_fmt(odms)}))",
           launches=launches, kernel="sort3", prefix=prefix)


def _wide_phase(dev, counts, zero, report, soak_slam):
    """Phase 12: the 128-beam configuration and a 262 144-point map rebuild,
    both through K9's grid kernel."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.models.slam import SLAM
    from fast_limo_tpu_torch.ops import sort
    from fast_limo_tpu_torch.utils import presets

    # (a) the 128-beam replay through the Localizer
    cfg = presets.ouster128_cfg()
    seq = presets.ouster128_sequence()
    t0 = time.perf_counter()
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    n_ret = sorted({s[1].shape[0] for s in scans})
    print(f"[smoke] wide: data {len(scans)} scans x {n_ret} returns "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    loc = Localizer(cfg, device=dev)
    ms, census, win, cap = [], [], {}, {}
    o_dispatch, o_sort = loc._dispatch, sort._launch
    last = len(scans) - 1

    def dispatch(scan):
        k = len(ms) + win.get("n", 0)
        cap["on"] = k == last
        if k == WARMUP:
            win["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            win["prof"].__enter__()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if k >= WARMUP + WIDE_PROFILED:
            census.extend(_sync_calls(lambda: o_dispatch(scan))[1])
        else:
            o_dispatch(scan)
        torch.cuda.synchronize()
        if WARMUP <= k < WARMUP + WIDE_PROFILED:
            win["n"] = win.get("n", 0) + 1
            if k == WARMUP + WIDE_PROFILED - 1:
                win["prof"].__exit__(None, None, None)
        else:
            ms.append(1e3 * (time.perf_counter() - t))
        cap["on"] = False

    def sort_capture(*a):
        if cap.get("on"):
            cap.setdefault("sorts", []).append(tuple(x.clone() for x in a))
        return o_sort(*a)

    loc._dispatch, sort._launch = dispatch, sort_capture
    zero()
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    try:
        for ev in _events(stamps, scans):
            _feed(loc, ev, stamps, acc, gyro, scans)
        loc.flush()
        torch.cuda.synchronize()
    finally:
        loc._dispatch, sort._launch = o_dispatch, o_sort
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    c = counts()
    est = loc.positions()
    if len(est) != seq.n_scans or not np.isfinite(est).all():
        _fail(f"wide: {len(est)} poses (want {seq.n_scans}) or non-finite values")
    ate = synthetic.ate_rmse(est, seq.traj.pos(loc.stamps()))
    stats = win["prof"].key_averages()
    dev_ev = [e for e in stats if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in dev_ev) / WIDE_PROFILED / 1e3 if dev_ev else None
    launches = sum(e.count for e in stats if e.device_type.name == "CPU"
                   and e.key.startswith("cudaLaunchKernel")) / WIDE_PROFILED
    k9_seen = sum(e.count for e in dev_ev if _kname(e.key).startswith("fl_sort3_grid"))
    steady = np.asarray(ms[WARMUP:])
    print(f"[smoke] wide: (a) {len(est)} scans of {cfg.tpu.max_points_per_scan} slots | ATE "
          f"{ate:.4f} m (JAX package {JAX_WIDE_ATE} m) | scan ms p50 "
          f"{np.percentile(steady, 50):.2f} p95 {np.percentile(steady, 95):.2f} ({len(steady)} "
          f"scans after {WARMUP} warm-up and {WIDE_PROFILED} profiled) | cudaLaunchKernel "
          f"{launches:.1f} a scan | device busy {_fmt(busy)} a scan (profiler; K9's grid kernel "
          f"seen {k9_seen} of {2 * WIDE_PROFILED} launches) | peak memory {peak_mib:.1f} MiB "
          f"({base_mib:.1f} MiB allocated before) | launches {json.dumps(c)}", flush=True)
    sites = {f: census.count(f) for f in sorted(set(census))}
    n_census = seq.n_scans - WARMUP - WIDE_PROFILED
    print(f"[smoke] wide: (a) the last {n_census} scans under set_sync_debug_mode(\"warn\"): "
          f"{len(census)} synchronizing calls {json.dumps(sites)}", flush=True)
    if not (ate < 0.15 and ate <= 1.25 * JAX_WIDE_ATE):
        _fail(f"wide: ATE {ate:.4f} m, not < 0.15 m and <= 1.25 x {JAX_WIDE_ATE} m")
    if c["sort3"] != 2 * seq.n_scans or c["sort3_grid"] != c["sort3"]:
        _fail(f"wide: K9 launched {c['sort3']} times ({c['sort3_grid']} through the grid "
              f"kernel) in {seq.n_scans} scans, not twice a scan, every one on the grid")
    _launched("wide", c)
    if _port_syncs(census):
        _fail(f"wide: the scan step synchronized the host at port lines {_port_syncs(census)}")

    # (b) K9 against its plain version: (a)'s two sorts, then seeded sorts
    # of the callers' forms
    sorts = cap.get("sorts", [])
    if len(sorts) != 2 or any(int(x[0].shape[0]) != cfg.tpu.max_points_per_scan for x in sorts):
        _fail(f"wide: captured K9 calls at N = {[int(x[0].shape[0]) for x in sorts]}")
    n_grid = c["sort3_grid"]
    _k9_row(torch, report, "sort3 (grid, voxel)", *sorts[0], n_grid, "voxel")
    _k9_row(torch, report, "sort3 (grid, insert)", *sorts[1], n_grid, "insert")
    # the switch's two sides in both forms, then the grid route above 2^17
    switch = sort.CLUSTER_MAXN
    sizes = [(N, form) for N in (switch, switch + 1) for form in ("insert", "voxel") if N >= 1]
    sizes += [(N, "insert") for N in ((1 << 17) + 1, 1 << 20, 1 << 22) if N != switch + 1]
    rng = np.random.default_rng(12)
    for N, form in sizes:
        ops = _k9_seeded(torch, dev, form, N, 12 + N)
        route = "grid" if N > switch else "cluster"
        tag = "" if form == "insert" else "voxel, "
        _k9_row(torch, report, f"sort3 ({route}, {tag}N={N})", *ops, 0, form)
        full = [torch.tensor(rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32), device=dev)
                for _ in range(3)]
        for i, (a, b) in enumerate(zip(sort.sort3(*full), sort.sort3_plain(*full))):
            if not torch.equal(a, b):
                _fail(f"K9 at N = {N}, full-range triples: output {i} differs from the plain")
    torch.cuda.synchronize()
    print(f"[smoke] wide: (b) K9 bit-equal to its plain version at N = "
          f"{sorted({N for N, _ in sizes})} and 2^18 (the captured sorts), the switch "
          f"(CLUSTER_MAXN = {switch}) on both sides in both forms, full-range triples too",
          flush=True)
    table, upto = _k9_crossover(torch, dev, sort)
    print("[smoke] wide: (b) K9 crossover, device ms a call (torch.profiler, median of 3 "
          "sessions of 5 calls), cluster / grid kernel:", flush=True)
    for N in K9_CROSSOVER_N:
        cells = " | ".join(f"{form} {_fmt(table[N, form][0])} / {_fmt(table[N, form][1])}"
                           for form in ("voxel", "insert"))
        print(f"[smoke] wide: (b)   N = {N:6d}: {cells}", flush=True)
    print(f"[smoke] wide: (b) the largest N at which the cluster kernel wins both forms: "
          f"{upto} (0: none); the switch CLUSTER_MAXN = {switch}", flush=True)

    # (c) a map rebuild of 32 keyframe clouds in one insert on phase 9's
    # soak, then 24 more scans of the soak on the rebuilt map
    slam = soak_slam
    slam.loop_cfg = dataclasses.replace(slam.loop_cfg, rebuild_batch=32)
    lc = slam.loop_cfg
    width = lc.rebuild_batch * max(
        (kf.cloud if kf.rebuild_cloud is None else kf.rebuild_cloud).shape[0]
        for kf in slam.keyframes)
    slam._rebuild_snapshot = None    # re-insert every keyframe
    rebuilt = []

    def rebuild_capture(*a):
        rebuilt.append(tuple(x.clone() for x in a))
        return o_sort(*a)

    sort._launch = rebuild_capture
    zero()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        SLAM._rebuild_map(slam)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    finally:
        sort._launch = o_sort
    c = counts()
    n_ins = -(-len(slam.keyframes) // lc.rebuild_batch)
    print(f"[smoke] wide: (c) map rebuild of {len(slam.keyframes)} keyframes at rebuild_batch "
          f"{lc.rebuild_batch}: {n_ins} inserts of {width} points in {wall:.1f} ms | K9 sizes "
          f"{[int(x[0].shape[0]) for x in rebuilt]} | launches {json.dumps(c)}", flush=True)
    if width != 262144 or c["sort3"] != n_ins or c["sort3_grid"] != n_ins or \
            any(int(x[0].shape[0]) != width for x in rebuilt):
        _fail(f"wide: the rebuild's K9 calls were not {n_ins} grid sorts of 262 144")
    _k9_row(torch, report, "sort3 (grid, rebuild)", *rebuilt[0], c["sort3_grid"], "insert")
    os.makedirs(os.path.dirname(K9_WIDE_INPUTS), exist_ok=True)
    np.savez(K9_WIDE_INPUTS, **{name: torch.stack(ops).cpu().numpy() for name, ops in
                                (("voxel", sorts[0]), ("insert", sorts[1]),
                                 ("rebuild", rebuilt[0]))})
    soak = presets.soak_sequence(216)
    s_stamps, s_acc, s_gyro = soak.imu_stream()
    s_scans = [soak.scan(i) for i in range(soak.n_scans)]
    t_last, si = slam.loc._newest_imu_stamp, len(slam.positions())
    zero()
    for k in range(len(s_stamps)):
        if s_stamps[k] > t_last:
            slam.update_imu(s_stamps[k], s_acc[k], s_gyro[k])
            while si < len(s_scans) and s_scans[si][0] <= s_stamps[k]:
                slam.update_pointcloud(s_scans[si][1], s_scans[si][2], s_scans[si][0])
                si += 1
    slam.flush()
    torch.cuda.synchronize()
    c = counts()
    est, gt = slam.positions(), soak.traj.pos(slam.stamps())
    kf_rmse = _kf_rmse(slam, soak)
    tail = float(np.sqrt(np.mean(np.sum((est[-60:] - gt[-60:]) ** 2, axis=1))))
    print(f"[smoke] wide: (c) the soak on to scan {len(est)} on the rebuilt map: loops "
          f"{slam.n_loops_closed} | keyframes {len(slam.keyframes)} | map rebuilds "
          f"{slam.n_rebuilds} | keyframe RMSE {kf_rmse:.4f} m | last-60-scan RMSE {tail:.4f} m "
          f"| ATE {synthetic.ate_rmse(est, gt):.4f} m | launches {json.dumps(c)}", flush=True)
    if len(est) != soak.n_scans or not np.isfinite(est).all():
        _fail(f"wide: the soak has {len(est)} poses after the rebuild (want {soak.n_scans})")
    if slam.n_loops_closed < 1 or not (kf_rmse < 0.3 and tail < 0.3):
        _fail(f"wide: after the rebuild loops {slam.n_loops_closed}, keyframe RMSE "
              f"{kf_rmse:.4f} m, tail RMSE {tail:.4f} m (>= 1 loop, < 0.3 m wanted)")
    for name in ("deskew", "knn_rows", "update_loop", "sort3"):
        if c[name] <= 0:
            _fail(f"kernel {name} did not launch on the soak after the rebuild")


def _compare(args, smi) -> None:
    """--compare: phase 3's replay (no capture, census or check) and the
    map phase's radius_search calls, each timed as the map phase times its
    3 m call, with the port of the checkout at --tree; --out saves the
    trajectory, the loop-fallback count and the timings, --against prints
    the largest pose differences from another run's file."""
    import torch

    sys.path.insert(0, os.path.abspath(args.tree))
    import fast_limo_tpu_torch
    from fast_limo_tpu_torch.models import iekf, mapper
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import sort
    from fast_limo_tpu_torch.utils import presets

    print(f"[compare] {smi} | port from {os.path.dirname(fast_limo_tpu_torch.__file__)}",
          flush=True)
    dev = torch.device("cuda:0")
    cfg = presets.kitti_like_cfg()
    seq = presets.bench_sequence(n_scans=args.scans)
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    loc = Localizer(cfg, device=dev)
    iekf.counters.loop_fallbacks = 0
    sort.sort3.launches = 0
    for ev in _events(stamps, scans):
        _feed(loc, ev, stamps, acc, gyro, scans)
    torch.cuda.synchronize()
    k9 = (sort.sort3.launches, getattr(sort.sort3, "grid_launches", 0))
    traj = loc.trajectory
    pos = np.array([t["pos"] for t in traj])
    quat = np.array([t["quat"] for t in traj])
    n_iters = np.array([t["n_iters"] for t in traj])
    fallbacks = int(iekf.counters.loop_fallbacks)
    print(f"[compare] replay: {len(traj)} scans | loop fallbacks {fallbacks} | K9 launches "
          f"{k9[0]} ({k9[1]} through a grid kernel) | n_iters {n_iters.tolist()}", flush=True)

    m, vox = loc.state.map, cfg.map_voxel_size
    _, q = _map_queries(torch, m, dev)
    timings = {}
    for r, kmax in _radius_settings(vox):
        name = f"{r:.2f} m / {kmax}"
        timings[name] = _query_timing(torch, lambda: mapper.radius_search(
            m, q, r, voxel_size=vox, max_results=kmax))
        print(f"[compare] {_query_line(f'radius {name}', timings[name])}", flush=True)
    print(json.dumps({"tree": os.path.abspath(args.tree), "fallbacks": fallbacks,
                      "radius": timings}))
    if args.out:
        np.savez(args.out, pos=pos, quat=quat, n_iters=n_iters, fallbacks=fallbacks)
    if args.against:
        other = np.load(args.against)
        same = bool(np.array_equal(pos, other["pos"]) and np.array_equal(quat, other["quat"]))
        print(f"[compare] against {os.path.basename(args.against)}: max |dpos| "
              f"{float(np.abs(pos - other['pos']).max()):.3e} m, max |dquat| "
              f"{float(np.abs(quat - other['quat']).max()):.3e}, bit-equal {same}, n_iters "
              f"equal {bool(np.array_equal(n_iters, other['n_iters']))}, fallbacks "
              f"{fallbacks} vs {int(other['fallbacks'])}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--profile", action="store_true",
                    help="also profile the steady scans of a one-scan and a "
                         "chunked (C = 4) replay (torch.profiler)")
    ap.add_argument("--compare", action="store_true",
                    help="only replay phase 3 and time the map phase's radius_search calls "
                         "(no check), with the port of --tree: two trees in one call")
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="with --compare: the checkout whose fast_limo_tpu_torch is imported "
                         "(default: this one); it builds its own kernels")
    ap.add_argument("--out", help="with --compare: save the trajectory to this .npz")
    ap.add_argument("--against", help="with --compare: compare the trajectory with a saved one")
    args = ap.parse_args()

    # ---- 1. device ----
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = _smi()
    if args.compare:
        _compare(args, smi)
        return
    dev = torch.device("cuda:0")
    print(f"[smoke] device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from fast_limo_tpu_torch.models import deskew as dsk_model
    from fast_limo_tpu_torch.models import iekf, measurement
    from fast_limo_tpu_torch.models import state as st
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.ops import (deskew_kernel, dispatch, gain, hstats, knn, knn_rows,
                                         plane_kernel, sort, update_body, update_loop)
    from fast_limo_tpu_torch.utils import presets

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = dispatch.build()
    dispatch.library()
    print(f"[smoke] build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path)}",
          flush=True)
    log_path = os.path.join(dispatch.BUILD_DIR, "build.log")
    if os.path.isfile(log_path):
        with open(log_path) as f:
            log = f.read()
        name, props = "?", ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
            if m:
                name = m.group(2)[:int(m.group(1))]
            elif "spill" in line:
                props = line.strip()
            elif "registers" in line:
                print(f"[smoke] ptxas {name}: {line.split('Used ')[-1].strip()} | {props}")

    wrappers = {
        "deskew": (deskew_kernel.deskew, "fast_limo_tpu_torch/csrc/deskew.cu",
                   "fast_limo_tpu/ops/deskew_kernel.py:149"),
        "knn_rows": (knn_rows.topk_from_table, "fast_limo_tpu_torch/csrc/knn_rows.cu",
                     "fast_limo_tpu/ops/knn_rows.py:107"),
        "fit_planes": (plane_kernel.fit_planes, "fast_limo_tpu_torch/csrc/plane.cu",
                       "fast_limo_tpu/ops/plane_kernel.py:193"),
        "fit_planes_select": (plane_kernel.fit_planes_select, "fast_limo_tpu_torch/csrc/plane.cu",
                              "fast_limo_tpu/ops/plane_kernel.py:193"),
        "hstats": (hstats.hstats, "fast_limo_tpu_torch/csrc/hstats.cu",
                   "fast_limo_tpu/ops/hstats.py:194"),
        "update_body": (update_body.update_body, "fast_limo_tpu_torch/csrc/update_body.cu",
                        "fast_limo_tpu/ops/update_body.py:448"),
        "update_loop": (update_loop.update_loop, "fast_limo_tpu_torch/csrc/update_loop.cu",
                        "fast_limo_tpu/ops/update_loop.py:394"),
        "masked_topk": (knn.masked_topk, "fast_limo_tpu_torch/csrc/masked_topk.cu",
                        "fast_limo_tpu/ops/knn.py:52"),
        "masked_topk_table": (knn.masked_topk_from_table,
                              "fast_limo_tpu_torch/csrc/masked_topk.cu",
                              "fast_limo_tpu/ops/knn.py:52"),
        "gain": (gain.gain, "fast_limo_tpu_torch/csrc/gain.cu",
                 "fast_limo_tpu/ops/gain.py:157"),
        "sort3": (sort.sort3, "fast_limo_tpu_torch/csrc/sort3.cu",
                  "fast_limo_tpu/ops/sort.py:98"),
    }

    def counts():   # K9's grid route counted beside its total
        return {**{k: w[0].launches for k, w in wrappers.items()},
                "sort3_grid": sort.sort3.grid_launches}

    def zero():
        for w in wrappers.values():
            w[0].launches = 0
        sort.sort3.grid_launches = 0

    # ---- 3. main path ----
    cfg = presets.kitti_like_cfg()
    seq = presets.bench_sequence(n_scans=args.scans)
    t0 = time.perf_counter()
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    print(f"[smoke] data: {len(scans)} scans x {scans[0][1].shape[0]} points, "
          f"{len(stamps)} IMU samples ({time.perf_counter() - t0:.1f} s)", flush=True)

    loc = Localizer(cfg, device=dev)
    capture_at = min(WARMUP + 4, args.scans - 1)
    cap = {}
    scan_ms = []
    orig_dispatch = loc._dispatch
    orig_make = measurement.make_h_model
    orig_deskew = dsk_model.deskew
    orig_knn = knn_rows._launch
    orig_loop = update_loop._launch
    orig_sort = sort._launch
    census = []   # the synchronizing calls of every steady scan, by source line

    def dispatch_timed(scan):
        capturing = len(scan_ms) == capture_at
        cap["on"] = capturing
        if len(scan_ms) == WARMUP:   # the fallbacks before the census (a read, outside it)
            cap["fb_warm"] = iekf.counters.loop_fallbacks
        torch.cuda.synchronize()
        t = time.perf_counter()
        if len(scan_ms) >= WARMUP:
            census.extend(_sync_calls(lambda: orig_dispatch(scan))[1])
        else:
            orig_dispatch(scan)
        torch.cuda.synchronize()
        scan_ms.append(1e3 * (time.perf_counter() - t))
        cap["on"] = False

    def make_capture(*a, **kw):
        h = orig_make(*a, **kw)
        if cap.get("on"):
            cap["h_model"] = h
        return h

    def desk_capture(*a):
        if cap.get("on"):
            cap["deskew"] = a
        return orig_deskew(*a)

    def knn_capture(ptable, row_idx, nc, q, active, **kw):
        # on the main path only the window resolve goes through _launch
        cap["n_window"] = cap.get("n_window", 0) + 1
        if cap.get("on") and "knn" not in cap:
            cap["knn"] = (ptable, row_idx, nc, q, kw)
        return orig_knn(ptable, row_idx, nc, q, active, **kw)

    def sort_capture(*a):
        if cap.get("on"):
            cap.setdefault("sort", []).append(tuple(t.clone() for t in a))
        return orig_sort(*a)

    def loop_capture(*a, **kw):
        if cap.get("on"):
            cap["loop"] = (a, kw)
        out = orig_loop(*a, **kw)
        if cap.get("on"):
            cap["loop_out"] = out
        return out

    loc._dispatch = dispatch_timed
    measurement.make_h_model = make_capture
    dsk_model.deskew = desk_capture
    knn_rows._launch = knn_capture
    update_loop._launch = loop_capture
    sort._launch = sort_capture

    # the census of a call that does nothing: what the census itself shows
    empty = _sync_calls(lambda: None)[1]
    print(f"[smoke] main: the sync census of an empty call: {len(empty)} synchronizing calls "
          f"{json.dumps(empty)}", flush=True)
    zero()
    iekf.counters.host_syncs = iekf.counters.loop_fallbacks = 0
    t0 = time.perf_counter()
    si = 0
    for k in range(len(stamps)):
        loc.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            loc.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = counts()
    syncs, fallbacks = iekf.counters.host_syncs, iekf.counters.loop_fallbacks
    loc._dispatch = orig_dispatch
    measurement.make_h_model = orig_make
    dsk_model.deskew = orig_deskew
    knn_rows._launch = orig_knn
    update_loop._launch = orig_loop
    sort._launch = orig_sort

    est = loc.positions()
    if len(est) != args.scans or not np.isfinite(est).all():
        _fail(f"trajectory has {len(est)} poses (want {args.scans}) or non-finite values")
    ate = synthetic.ate_rmse(est, seq.traj.pos(loc.stamps()))
    steady = np.asarray(scan_ms[WARMUP:])
    print(f"[smoke] main: {len(scan_ms)} scans in {wall:.2f} s | ATE {ate:.4f} m | "
          f"scan ms p50 {np.percentile(steady, 50):.2f} p95 {np.percentile(steady, 95):.2f} "
          f"(after {WARMUP} warm-up scans; first scan {scan_ms[0]:.1f} ms)", flush=True)
    print(f"[smoke] main: launches {json.dumps(main_counts)} | loop fallbacks {fallbacks} "
          f"| host syncs {syncs} | n_iters {[t['n_iters'] for t in loc.trajectory]}",
          flush=True)
    if not ate < 0.15:
        _fail(f"ATE {ate:.4f} m >= 0.15 m")
    # the exact loop's kernels launch on every scan behind their active flag,
    # K3 once an evaluation (the re-match's three branches in one launch)
    for name in ("deskew", "knn_rows", "fit_planes_select", "hstats", "update_body",
                 "update_loop"):
        if main_counts[name] <= 0:
            _fail(f"kernel {name} did not launch on the main path")
    evals = cfg.ikfom.MAX_NUM_ITERS + 1
    if main_counts["fit_planes_select"] != evals * args.scans or main_counts["fit_planes"]:
        _fail(f"K3 launched {main_counts['fit_planes_select']} + {main_counts['fit_planes']} "
              f"times in {args.scans} scans, not once an evaluation ({evals} a scan)")
    # K9 twice a scan, each sort on the route its width takes at the switch
    n_grid = args.scans * sum(n > sort.CLUSTER_MAXN for n in
                              (cfg.tpu.max_points_per_scan, cfg.tpu.max_insert_points))
    if main_counts["sort3"] != 2 * args.scans or main_counts["sort3_grid"] != n_grid:
        _fail(f"K9 launched {main_counts['sort3']} times in {args.scans} scans "
              f"({main_counts['sort3_grid']} through the grid kernel), not twice a scan "
              f"with {n_grid} through the grid kernel (CLUSTER_MAXN = {sort.CLUSTER_MAXN})")
    # K2: one window resolve a scan, one select launch an evaluation
    n_window = cap.get("n_window", 0)
    if n_window != args.scans or main_counts["knn_rows"] != (1 + evals) * args.scans:
        _fail(f"K2 launched {main_counts['knn_rows']} times ({n_window} window resolves) in "
              f"{args.scans} scans, not {1 + evals} a scan (one window resolve, one select "
              f"launch an evaluation)")
    if syncs:
        _fail(f"the main path read the device {syncs} times (iekf.counters.host_syncs)")
    for key in ("h_model", "deskew", "knn", "loop", "loop_out", "sort"):
        if key not in cap:
            _fail(f"capture of scan {capture_at} missed {key}")
    sites = {f: census.count(f) for f in sorted(set(census))}
    n_steady = args.scans - WARMUP
    fb_steady = fallbacks - cap.get("fb_warm", fallbacks)
    print(f"[smoke] main: the {n_steady} steady scans ({fb_steady} of them fell "
          f"back to the exact loop) under set_sync_debug_mode(\"warn\"): {len(census)} "
          f"synchronizing calls ({len(census) / n_steady:.2f} a scan) {json.dumps(sites)}",
          flush=True)
    if _port_syncs(census):
        _fail(f"the scan step synchronized the host at port lines {_port_syncs(census)}")

    # ---- 4. fallback path on the captured scan ----
    h = cap["h_model"]
    (X, P, x_prop, R, D, limit), loop_kw = cap["loop"]
    xk, Pk, aux_k = cap["loop_out"]
    for w in wrappers.values():
        w[0].launches = 0
    h.loop_pack = None                        # force the exact per-iteration loop
    cap3 = {}
    o_hs, o_ub = hstats._launch, update_body._launch

    def hs_cap(X, sc, active, **kw):
        cap3.setdefault("hstats", ((X, sc), kw))
        return o_hs(X, sc, active, **kw)

    def ub_cap(*a):
        cap3.setdefault("body", (a[:7], {}))
        return o_ub(*a)

    hstats._launch, update_body._launch = hs_cap, ub_cap
    x_f, P_f, n_f = iekf.update_iterated(
        x_prop, P, h, R=R, D=D, max_iters=loop_kw["max_iters"], limit=limit)
    torch.cuda.synchronize()
    hstats._launch, update_body._launch = o_hs, o_ub
    fb_counts = counts()
    print(f"[smoke] fallback: launches {json.dumps(fb_counts)} | n_iters exact {int(n_f)} "
          f"vs whole-loop {int(aux_k[0])}", flush=True)
    if fb_counts["fit_planes_select"] != int(n_f) or fb_counts["fit_planes"]:
        _fail(f"the exact loop launched K3 {fb_counts['fit_planes_select']} + "
              f"{fb_counts['fit_planes']} times in {int(n_f)} evaluations, not once each")
    for name in ("knn_rows", "fit_planes_select", "hstats", "update_body"):
        if fb_counts[name] <= 0:
            _fail(f"kernel {name} did not launch in the fallback phase")
    if fb_counts["knn_rows"] != int(n_f):
        _fail(f"the exact loop launched K2 {fb_counts['knn_rows']} times in {int(n_f)} "
              f"evaluations, not once each (its select entry)")
    ex = _close("fallback x vs whole-loop x", st.as_vector(x_f), st.as_vector(xk), 1e-3, 2e-4)
    eP = _close("fallback P vs whole-loop P", P_f, Pk, 1e-3, 2e-4)
    print(f"[smoke] fallback: exact loop vs K6 on scan {capture_at}: max|dx| {ex:.2e} "
          f"max|dP| {eP:.2e}", flush=True)

    # ---- 8. the split update body (before phase 5: K8's inputs come from it) ----
    split_counts, gain_args = _split_phase(dev, cfg, seq, loc, stamps, acc, gyro, scans,
                                           np.asarray(scan_ms), counts, zero, syncs)

    # ---- 5. kernel vs plain on captured main-path inputs ----
    # Each kernel is called through its public wrapper (the code the main
    # path runs) and held elementwise to its plain version on the same CUDA
    # tensors: |kernel − plain| ≤ atol + rtol·|plain|.
    rows_out = []

    def report(name, err, k_fn, p_fn, nbytes, ops, lib_fn=None, extra="", launches=None,
               kernel=None, prefix=None):
        """A kernel row: CUDA-event times through the wrapper (ms) and of the
        plain version, the kernel's own device time (device_ms, torch.profiler
        matched by kernel name over as many reps), the bound, and the one
        PyTorch call's event and device times."""
        kernel = kernel or name
        ms, pms = _time_ms(k_fn), _time_ms(p_fn, reps=3)
        dms = _device_ms(k_fn, prefix or "fl_" + kernel)
        lms = _time_ms(lib_fn) if lib_fn is not None else None
        ldms = _device_ms(lib_fn) if lib_fn is not None else None
        bms, by = _bound(nbytes, ops)
        _, src, rep = wrappers[kernel]
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": main_counts[kernel] if launches is None else launches,
                         "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                         "bound_by": by, "library_ms": lms, "device_ms": dms,
                         "library_device_ms": ldms})
        lib = "none" if lib_fn is None else f"{lms:.4f} ms (device {_fmt(ldms)})"
        print(f"[smoke] kernel {name}: max_abs_err {err:.3e} | {ms:.4f} ms (device "
              f"{_fmt(dms)}) vs plain {pms:.4f} ms | bound {bms:.4f} ms ({by}) | one PyTorch "
              f"call {lib} {extra}", flush=True)

    # K1 deskew — rtol 1e-4 / atol 2e-4 (f32 association, transcendental
    # ulps); the frame sources as the scan step passed them, the plain
    # version on the table and scalars built in plain torch; ONE CUDA
    # kernel a call (the frame table is built in it)
    pts, t_pts, valid, frames, x_last, q_ext, t_ext = cap["deskew"]

    def k1():
        return deskew_kernel.deskew(pts, t_pts, valid, frames, x_last.rot, x_last.pos,
                                    q_ext, t_ext)

    def k1_plain():
        return deskew_kernel.deskew_plain(
            pts, t_pts, valid, deskew_kernel.frame_table(deskew_kernel.stack_frames(frames)),
            deskew_kernel._scalars(q_ext, t_ext, x_last.rot, x_last.pos))

    a, b = _once("K1", deskew_kernel.deskew, k1), k1_plain()
    err = max(_close("K1 xt2", a[0], b[0], 1e-4, 2e-4), _close("K1 world", a[1], b[1], 1e-4, 2e-4))
    n1 = _cuda_launches(torch, k1, "")
    if n1 != 1:
        _fail(f"K1 ran {n1} CUDA kernels a call, not one")
    K1 = sum(f.time.shape[0] for f in frames)
    # ~140 float32 operations a valid point (interpolation, two rotations)
    report("deskew", err, k1, k1_plain, _nbytes(pts, t_pts, valid, *frames, *a),
           140 * int(valid.sum()), extra=f"(N={pts.shape[0]}, K={K1}, {n1} CUDA kernel a call)")

    # K2 at the main path's window resolve — sq, valid and nbrs bit-equal
    # to the plain version (the gather, then the plain top-k), invalid tail
    # included, ONE CUDA kernel a call; the device ms of every schedule that
    # takes k (the wrapper picks one from (V, k))
    ptab, ridx, nc, q, kw = cap["knn"]

    def k2_one_kernel(name, fn):
        n2 = _cuda_launches(torch, fn, "fl_k2")
        if n2 != 1:
            _fail(f"{name} ran {n2} CUDA kernels a call, not one")

    def k2t():
        return knn_rows.topk_from_table(ptab, ridx, nc, q, **kw)

    a = _once("K2", knn_rows.topk_from_table, k2t)
    b = knn_rows.topk_from_table_reference(ptab, ridx, nc, q, **kw)
    _held("K2", a, b)
    k2_one_kernel("K2", k2t)
    modes = {}
    for mode in knn_rows.MODES:
        if mode == "block" or kw["k"] <= knn_rows.WARP_KMAX:
            _held(f"K2 ({mode})", knn_rows._launch(ptab, ridx, nc, q, None, **kw, mode=mode), b)
            modes[mode] = _device_ms(
                lambda: knn_rows._launch(ptab, ridx, nc, q, None, **kw, mode=mode), "fl_k2")
    d2_k2 = knn_rows.candidate_d2(ptab[ridx.long()], nc, q, E=kw["E"], B=kw["B"])[0]
    nb2, ops2 = _table_work(ptab, ridx, nc, q, a, d2_k2, kw["E"])
    report("knn_rows", 0.0, k2t,
           lambda: knn_rows.topk_from_table_reference(ptab, ridx, nc, q, **kw), nb2, ops2,
           lambda: torch.topk(d2_k2, kw["k"], dim=1, largest=False),
           f"(N={q.shape[0]}, V={ridx.shape[1]}, k={kw['k']}, "
           f"{float(torch.isfinite(d2_k2).float().mean()):.3f} valid, at most "
           f"{int(torch.isfinite(d2_k2).sum(1).max())} columns a query; schedule "
           f"{knn_rows.schedule(ridx.shape[1], kw['k'])}; device ms by schedule "
           f"{json.dumps({m: round(t, 5) if t else t for m, t in modes.items()})}; 1 CUDA "
           f"kernel a call; launches: the window resolves)",
           launches=cap["n_window"], prefix="fl_k2")
    del d2_k2

    # K2's select entry — the exact loop's re-match at the captured scan's
    # predicted pose (the fallback phase's first evaluation), the budget
    # first valid queries marked stale: at each branch code the taken branch bit-equal to the
    # plain version (K2 on the idx rows, K2 on every query), ONE CUDA kernel
    # a call, and under a clear flag
    glob0 = h.glob0
    rows0 = h._rows(glob0)[:2]
    stale = h.pc_valid & (torch.cumsum(h.pc_valid.to(torch.int32), 0) <= h.budget)
    idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:h.budget]
    skw = dict(E=kw["E"], B=kw["B"], k=h.k)
    sel_args = (ptab, *rows0, glob0, idx)
    want2 = knn_rows.topk_from_table_select_reference(*sel_args, **skw)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    dev2 = {}
    for code, v, flag in ((0, 0, None), (1, int(stale.sum()), None), (2, h.budget + 1, None),
                          ("clear flag", h.budget + 1, off)):
        viol = torch.tensor(v, dtype=torch.int32, device=dev)

        def k2s():
            return knn_rows.topk_from_table_select(*sel_args, viol, **skw, active=flag)

        got = _once(f"K2 select ({code})", knn_rows.topk_from_table, k2s)
        if code in (1, 2):
            _held(f"K2 select (branch {code})", got[code - 1], want2[code - 1])
        dev2[code] = _device_ms(k2s, "fl_k2")
        k2_one_kernel(f"K2 select ({code})", k2s)
    viol2 = torch.tensor(h.budget + 1, dtype=torch.int32, device=dev)
    modes2 = {}
    for mode in knn_rows.MODES:
        got = knn_rows._run(*sel_args[:4], None, viol2, idx, **skw, mode=mode)
        _held(f"K2 select ({mode})", got[1], want2[1])
        modes2[mode] = _device_ms(
            lambda: knn_rows._run(*sel_args[:4], None, viol2, idx, **skw, mode=mode), "fl_k2")
    d2_s = knn_rows.candidate_d2(ptab[rows0[0].long()], rows0[1], glob0, E=kw["E"],
                                 B=kw["B"])[0]
    # branch 2 (the full re-match): every query's rows, N outputs
    report("knn_rows (select)", 0.0,
           lambda: knn_rows.topk_from_table_select(*sel_args, viol2, **skw),
           lambda: knn_rows.topk_from_table_select_reference(*sel_args, **skw),
           *_table_work(ptab, rows0[0], rows0[1], glob0, want2[1], d2_s, kw["E"]),
           lambda: torch.topk(d2_s, h.k, dim=1, largest=False),
           f"(N={glob0.shape[0]}, budget {h.budget}, k={h.k}, branch 2, schedule "
           f"{knn_rows.schedule(rows0[0].shape[1], h.k)}; device ms by branch code "
           f"{json.dumps({c: round(t, 5) if t else t for c, t in dev2.items()})}, at branch 2 by "
           f"schedule {json.dumps({m: round(t, 5) if t else t for m, t in modes2.items()})}; the taken "
           f"branch bit-equal to the plain version, 1 CUDA kernel a call; launches: the select "
           f"launches)",
           launches=main_counts["knn_rows"] - cap["n_window"], kernel="knn_rows", prefix="fl_k2")
    del d2_s

    # K3 — the re-match's sets at the same pose and stale marks as K2's
    # select row: the window rank, and K2 without a flag on the idx rows and
    # on every query, so all three sets are real.
    fkw = dict(num_match_points=h.k, max_dist_plane=h.max_dist_plane,
               plane_threshold=h.plane_threshold)
    win = h._window_rank(glob0)
    fa = (win[0], win[1], torch.isfinite(win[1]))
    full = h._topk(glob0, h.k, rows0)
    patch = h._topk(glob0[idx], h.k, (rows0[0][idx], rows0[1][idx]))
    sel = (win, patch, idx, stale, full)

    # K3 fit_planes, the one-set entry, on the window set
    a = _once("K3", plane_kernel.fit_planes, lambda: plane_kernel.fit_planes(*fa, **fkw))
    err, agree = _k3_check("K3", a, plane_kernel.fit_planes_plain(*fa, **fkw))
    # ~250 float32 operations a query (5-point moments, normal, gates)
    report("fit_planes", err, lambda: plane_kernel.fit_planes(*fa, **fkw),
           lambda: plane_kernel.fit_planes_plain(*fa, **fkw), _nbytes(*fa, *a),
           250 * fa[0].shape[0],
           launches=main_counts["fit_planes"] + main_counts["fit_planes_select"],
           extra=f"(N={fa[0].shape[0]}, gate agreement {agree:.5f}; launches: the main path's "
                 f"of this kernel, all through fit_planes_select)")

    # K3 fit_planes_select — at each branch code bit for bit merge_fits of
    # the three one-set launches on the card, within K3's bounds of its
    # plain version, ONE CUDA kernel a call
    n_st = int(stale.sum())
    errs, dev3 = [], {}
    for code, v in ((0, 0), (1, n_st), (2, h.budget + 1)):
        viol = torch.tensor(v, dtype=torch.int32, device=dev)

        def k3s():
            return plane_kernel.fit_planes_select(*sel, viol, **fkw)

        a = _once(f"K3 select (branch {code})", plane_kernel.fit_planes_select, k3s)
        three = [plane_kernel.fit_planes(*fa, **fkw), plane_kernel.fit_planes(*patch, **fkw),
                 plane_kernel.fit_planes(*full, **fkw)]
        want = plane_kernel.merge_fits(*three, idx, stale, viol)
        if not all(torch.equal(g, w) for g, w in zip(a, want)):
            _fail(f"K3 select (branch {code}) differs from the merge of three one-set launches")
        errs.append(_k3_check(f"K3 select (branch {code})", a,
                             plane_kernel.fit_planes_select_plain(*sel, viol, **fkw))[0])
        dev3[code] = _device_ms(k3s, "fl_fit_planes")
        n3 = _cuda_launches(torch, k3s, "fl_fit_planes")
        if n3 != 1:
            _fail(f"K3 select (branch {code}) ran {n3} CUDA kernels a call, not one")
    viol1 = torch.tensor(n_st, dtype=torch.int32, device=dev)
    N3, B3 = fa[0].shape[0], idx.shape[0]
    # branch 1 (the patch taken): the window set, the patch, idx, stale and
    # viol read, N fits
    report("fit_planes_select", max(errs),
           lambda: plane_kernel.fit_planes_select(*sel, viol1, **fkw),
           lambda: plane_kernel.fit_planes_select_plain(*sel, viol1, **fkw),
           _nbytes(win, patch, idx, stale, viol1, *a), 250 * N3,
           extra=f"(N={N3}, B={B3}, branch 1 with {n_st} stale; device ms by branch code "
                 f"{json.dumps({c: round(t, 5) if t else t for c, t in dev3.items()})}; bit-equal "
                 f"to the merge of three one-set launches at codes 0-2, 1 CUDA kernel a call)",
           kernel="fit_planes_select", prefix="fl_fit_planes")

    # K4 hstats — rtol 1e-5 of each entry's sum of term magnitudes (_k4_check)
    (X4, sc4), hkw = cap3["hstats"]

    def k4():
        return hstats.hstats(X4, sc4, **hkw)

    a = _once("K4", hstats.hstats, lambda: _no_sync("K4's wrapper", k4))
    b = hstats.hstats_plain(X4, sc4, **hkw)
    again = k4()
    if not (torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])):
        _fail("K4: two launches on the same inputs differ")
    n4 = _cuda_launches(torch, k4, "fl_hstats")
    if n4 != 1:
        _fail(f"K4 ran {n4} CUDA kernels a call, not one")
    Np4 = X4.shape[0] // 8
    err, H4 = _k4_check("K4", a, b, X4, sc4, hkw)
    # ~290 float32 operations a point: its H row (~110) and its share of
    # the 78 + 12 sums of HᵀH and Hᵀh (2 each)
    report("hstats", err, k4, lambda: hstats.hstats_plain(X4, sc4, **hkw),
           _nbytes(X4, sc4, *a), 290 * Np4, lambda: torch.matmul(H4.T, H4),
           f"(Np={Np4}, {n4} CUDA kernel a call, bit-equal run to run)")

    # K5 update_body — x rtol 1e-3 / atol 1e-4, P and dx_ rtol 1e-3 / atol 1e-3
    ba, bkw = cap3["body"]
    a = _once("K5", update_body.update_body,
              lambda: _no_sync("K5's wrapper", lambda: update_body.update_body(*ba, **bkw)))
    err = _k5_check("K5", a, update_body.update_body_plain(*ba, **bkw))
    # ~3e5 float32 operations: about ten 23×23 products, the 12×12 solve
    report("update_body", err, lambda: update_body.update_body(*ba, **bkw),
           lambda: update_body.update_body_plain(*ba, **bkw), _nbytes(*ba, *a), 3e5)

    # K6 update_loop — x, P rtol 1e-3 / atol 2e-4; n_iters, ok, stale count exact
    la, lkw = cap["loop"]

    def k6():
        out = update_loop.update_loop(*la, **lkw, with_aux=True)
        return out[0], out[1], out[6]

    a = _once("K6", update_loop.update_loop, lambda: _no_sync("K6's wrapper", k6))
    b = update_loop.update_loop_plain(*la, **lkw)
    again = k6()
    if not (torch.equal(st.as_vector(a[0]), st.as_vector(again[0]))
            and torch.equal(a[1], again[1]) and torch.equal(a[2], again[2])):
        _fail("K6: two launches on the same inputs differ")
    n6 = _cuda_launches(torch, k6, "fl_update_loop")
    if n6 != 1:
        _fail(f"K6 ran {n6} CUDA kernels a call, not one")
    if a[2][[0, 1, 4]].tolist() != b[2][[0, 1, 4]].tolist():
        _fail(f"K6 (n_iters, ok, stale) {a[2][[0, 1, 4]].tolist()} != plain {b[2][[0, 1, 4]].tolist()}")
    err = max(_close("K6 x", st.as_vector(a[0]), st.as_vector(b[0]), 1e-3, 2e-4),
              _close("K6 P", a[1], b[1], 1e-3, 2e-4))
    Np6, W6, it6 = la[0].shape[0] // (5 + 3 * lkw['window'].W), lkw['window'].W, int(a[2][0])
    # per iteration: ~(540 + 8·W) float32 operations a point (window
    # re-rank, plane fit, H row and sums) and ~3e5 for the 23×23 update
    report("update_loop", err, k6, lambda: update_loop.update_loop_plain(*la, **lkw),
           _nbytes(*la, *a),
           it6 * ((540 + 8 * W6) * Np6 + 3e5),
           extra=f"(Np={Np6}, n_iters {it6}, ok {bool(a[2][1] > 0)}, stale {int(a[2][4])}, "
                 f"{n6} CUDA kernel a call, bit-equal run to run)")

    # K8 gain — against its plain version gain_math (rtol 1e-3 + 1e-3 of
    # the largest entry: the plain version's products are library matmuls,
    # the same float32 terms in another order through an ill-conditioned
    # 12×12 solve) and against float64 truth by the rule of
    # tests/test_gain.py (error ≤ 12× the float32 library solve's + 2e-5 of
    # the largest entry); no single PyTorch call computes it
    g_HTH, g_HTh, g_P, g_R = gain_args
    inv_R8 = torch.tensor(1.0 / g_R, device=dev)

    def k8_plain():
        return gain.gain_math(g_HTH, g_HTh, g_P[:, :gain.M].contiguous(), inv_R8)

    a = _once("K8", gain.gain,
              lambda: _no_sync("K8's wrapper", lambda: gain.gain(g_HTH, g_HTh, g_P, g_R)))
    b = k8_plain()
    lib8 = gain.gain_reference(g_HTH, g_HTh, g_P, g_R)
    truth8 = gain.gain_reference(g_HTH.double(), g_HTh.double(), g_P.double(), g_R)
    err = 0.0
    for nm, g8, p8, l8, t8 in zip(("K_x", "K_h", "K"), a, b, lib8, truth8):
        err = max(err, _close(f"K8 {nm}", g8, p8, 1e-3, 1e-3 * float(p8.abs().max())))
        s8 = float(t8.abs().max()) + 1e-12
        e_k, e_l = _maxerr(g8, t8) / s8, _maxerr(l8, t8) / s8
        if not e_k <= 12.0 * e_l + 2e-5:
            _fail(f"K8 {nm}: error to float64 truth {e_k:.2e} > 12 x library {e_l:.2e} + 2e-5")
    # ~3e4 float32 operations: the 12×12 factorization and elimination on a
    # 35-wide augmented matrix, three small products; P's columns 0:12 read
    report("gain", err, lambda: gain.gain(g_HTH, g_HTh, g_P, g_R), k8_plain,
           4 * (144 + 12 + 276) + _nbytes(*a), 3e4, launches=split_counts["gain"],
           extra=f"({split_counts['gain']} launches in the split-body replay)")

    # K5, K6 and K8 against their records, bit for bit: K5 the golden file
    # recorded before the gain moved into gain.cuh, and the one-cluster K6
    # (8 cases), K8 (4) and K5 (6 more) as the one-cluster K6 tree recorded
    # them (tests/data/*.npz, inputs made on the host by tests/test_torch_cuda.py)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_cuda as golden

    for path, fn, pre in ((golden.GOLDEN, golden._golden_outputs, "k5_"),
                          (golden.CLUSTER_GOLDEN, golden._cluster_golden_outputs, "")):
        want, got = np.load(path), fn(dev)
        keys = [k for k in want.files if k.startswith(pre)]
        bad = [k for k in keys if got[k].tobytes() != want[k].tobytes()]
        if bad:
            _fail(f"{os.path.basename(path)}: {bad} differ from the record")
        print(f"[smoke] golden: {len(keys)} arrays of {os.path.basename(path)} bit-equal "
              f"({', '.join(sorted({k.split('_')[0] for k in keys}))})", flush=True)

    # K9 sort3 — all three outputs bit-equal to the plain version, on the
    # voxel sort (N = 32768) and the insert sort (N = 10000) of the
    # captured scan, ONE CUDA kernel a call; one PyTorch call for the same
    # function: the voxel sort is torch.sort of the int32 key with its
    # indices (sort_key_val), the insert sort the stable sort of the int64
    # key (k1 << 30) | k2 — both are timed at both shapes
    sorts = {int(c[0].shape[0]): c for c in cap["sort"]}
    n_vox, n_ins = cfg.tpu.max_points_per_scan, cfg.tpu.max_insert_points
    if len(cap["sort"]) != 2 or set(sorts) != {n_vox, n_ins}:
        _fail(f"captured K9 calls at N = {[int(c[0].shape[0]) for c in cap['sort']]}, "
              f"not one voxel sort (N = {n_vox}) and one insert sort (N = {n_ins})")
    for n_sort, name, what in ((n_vox, "sort3", "voxel"), (n_ins, "sort3 (insert)", "insert")):
        k1, k2, v = sorts[n_sort]
        a = _once(f"K9 {what}", sort.sort3, lambda: sort.sort3(k1, k2, v))
        b = sort.sort3_plain(k1, k2, v)
        for i, (g, w) in enumerate(zip(a, b)):
            if not torch.equal(g, w):
                _fail(f"K9 ({what}) output {i} differs from the plain version")
        packed = (k1.long() << 30) | k2.long()
        calls = {"voxel": lambda: torch.sort(k1, stable=True),
                 "insert": lambda: torch.sort(packed, stable=True)}
        other = "insert" if what == "voxel" else "voxel"
        oms, odms = _time_ms(calls[other]), _device_ms(calls[other])
        n_cuda = _cuda_launches(torch, lambda: sort.sort3(k1, k2, v), "fl_sort3")
        if n_cuda != 1:
            _fail(f"K9 ({what}) ran {n_cuda} CUDA kernels a call, not one")
        report(name, 0.0, lambda: sort.sort3(k1, k2, v), lambda: sort.sort3_plain(k1, k2, v),
               24 * k1.shape[0], 0, calls[what],
               f"(N={k1.shape[0]}, {what} sort, {n_cuda} CUDA kernel a call; the {other} "
               f"sort's one call here {oms:.4f} ms (device {_fmt(odms)}))", kernel="sort3")
    torch.cuda.synchronize()

    # ---- 6. map: the long-session surface ----
    _map_phase(dev, cfg, loc, stamps, acc, gyro, scans, wrappers, report)

    # ---- 7. transfer and replay: the bench's other streaming entry points ----
    _transfer_phase(dev, cfg, seq, loc, stamps, acc, gyro, scans, np.asarray(scan_ms))

    if args.profile:
        cfg4 = presets.kitti_like_cfg()
        cfg4.tpu.scan_chunk = 4
        for label, c in (("C=1", cfg), ("C=4", cfg4)):
            _profile(torch, Localizer, c, stamps, acc, gyro, scans, label)

    # ---- 9. the SLAM engine and its CLI ----
    soak = _slam_phase(dev, cfg, counts, zero)

    # ---- 10. the data readers, the CLI's data subcommands, packets, the fleet ----
    _data_phase(dev, cfg, counts, zero, ate, soak)

    # ---- 11. the multi-device layer: sharded steps on the one card ----
    _shard_phase(dev, cfg, seq, loc, counts, zero, report, rows_out, soak[2])

    # ---- 12. wide: a 128-beam scan and a 262 144-point map rebuild (K9's grid kernel) ----
    _wide_phase(dev, counts, zero, report, soak[3])

    # ---- 13. result ----
    print(f"[smoke] kernels a call: {_COUNTED_BY['graph']} checks read from captured CUDA "
          f"graphs, {_COUNTED_BY['profiler']} from torch.profiler", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
