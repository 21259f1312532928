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
              launch count of every kernel (K1, K2, K6 must be > 0; K9
              exactly twice a scan: the voxel and the insert sort), the
              loop-fallback count and the host-sync count; one steady scan
              runs under torch.cuda.set_sync_debug_mode("warn") and its
              synchronizing calls are listed by source line (none may lie
              in the K4/K5/K6/K8 wrappers).
4. fallback — the exact per-iteration update loop (the path taken when the
              whole-loop kernel's certificates fail) on one captured scan at
              main-path shapes, plus its stale-patch and full re-match
              branches: K2 (k=5), K3, K4, K5 must launch; its x/P are
              compared with the whole-loop kernel's on that scan.
5. kernels  — every kernel's public wrapper against its plain PyTorch
              version on the card, on inputs captured from phases 3-4 and,
              for K8, from phase 8, which therefore runs before this one
              (K9 on the captured voxel sort, N = 32768, and insert sort,
              N = 10000: all three outputs bit-equal, with its CUDA
              launches a call counted by torch.profiler; K8 against its
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
                  K7 at r = 3 m), 256 of them held to a brute force over
                  the stored points; K2 and K7 must launch;
              (b) K7 and K2 at k = 64 against their plain versions on a
                  captured chunk (sq/valid bit-equal), with times;
              (c) an eviction replay (40 scans, evict_radius 30 m,
                  evict_occupancy 0.002): an eviction must drop the map's
                  point count, ATE < 0.15 m;
              (d) checkpoint/resume: a replay saved half-way and resumed
                  in a fresh Localizer(cfg) must retrace the rest within
                  1e-5 m.
7. transfer — the same scans through the bench's other streaming entry
              points: (a) chunked replay (scan_chunk = 4, flush()), poses
              within the JAX package's chunk bounds of phase 3's (pos 3e-4,
              quat 3e-5, n_pc2match equal); (b) the float32 split transfer
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
              and K6 never; ATE < 0.15 m; the poses within rtol 1e-3 / atol
              2e-4 (phase 4's bounds) of phase 3's.  Prints per-scan wall
              p50/p95, host syncs and guard eigh calls beside phase 3's.
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
              in-process, `synthetic --scans 24 --debug-dump … --out …`:
              its JSON line has ate_m < 0.15 and the dump every DebugOutput
              field.
10. result  — the card's name and power limit, the kernels JSON line, then
              the final status line.

Usage: python3 chip_smoke.py [--scans N] [--profile]
Exits non-zero on any failed check; there is no CPU path.
"""

from __future__ import annotations

import argparse
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
    ``prefix``, or every device op of the call if None.  None if the
    profiler records no device op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not ev:
        return None
    mine = [e for e in ev if prefix is None or e.key.startswith(prefix)]
    return sum(e.self_device_time_total for e in mine) / reps / 1e3


def _sync_calls(fn):
    """(fn(), the "file:line" of each synchronizing call it made), run under
    torch.cuda.set_sync_debug_mode("warn")."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


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


def _k2_work(rows, nc, q, out, d2, E):
    """K2's data-dependent work: every row's four meta planes, the
    coordinates of the filled slots of wanted blocks, the outputs; 8
    operations a distance."""
    import torch

    n_valid = int(torch.isfinite(d2).sum())
    N, V, _ = rows.shape
    return N * V * 4 * E * 4 + 12 * n_valid + _nbytes(nc, q, *out), 8 * n_valid


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
    host = [e for e in stats if e.device_type.name == "CPU"]
    n_sync = sum(e.count for e in host if e.key == "cudaStreamSynchronize")
    print(f"[smoke] profile {label}: cudaStreamSynchronize {n_sync / n:.2f} calls a scan "
          f"({n_sync} in {n} scans)")
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


def _map_phase(dev, cfg, loc, stamps, acc, gyro, scans, wrappers, report):
    """Phase 6: radius_search (K2, K7) on the main replay's final map, K7
    and K2 at k = 64 against their plain versions, an eviction replay and a
    checkpoint/resume."""
    import torch

    from fast_limo_tpu_torch.io import synthetic
    from fast_limo_tpu_torch.models import mapper
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import dispatch, knn, knn_rows
    from fast_limo_tpu_torch.utils import checkpoint, presets

    def counts():
        return {k: w[0].launches for k, w in wrappers.items()}

    # (a) radius_search at four settings on the final map of phase 3
    m, vox = loc.state.map, cfg.map_voxel_size
    stored = checkpoint.map_points(m)
    rng = np.random.default_rng(5)
    pick = rng.choice(len(stored), 10000, replace=len(stored) < 10000)
    q = torch.tensor(np.float32(stored[pick] + rng.uniform(-0.5, 0.5, (10000, 3))), device=dev)
    stored_d = torch.tensor(stored, device=dev)
    cap, k2_shapes = {}, []
    o_k7, o_k2 = knn._launch, knn_rows._launch

    def k7_cap(*a, **kw):
        cap.setdefault("k7", (a, kw))
        return o_k7(*a, **kw)

    def k2_cap(*a, **kw):
        k2_shapes.append((int(a[0].shape[1]), kw["k"]))
        if kw["k"] == 64:
            cap.setdefault("k2_64", (a, kw))
        return o_k2(*a, **kw)

    knn._launch, knn_rows._launch = k7_cap, k2_cap
    settings = [(0.9 * vox, 16), (1.9 * vox, 16), (1.9 * vox, 64), (3.0, 16)]
    for w in wrappers.values():
        w[0].launches = 0
    runs = []
    for r, kmax in settings:
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mapper.radius_search(m, q, r, voxel_size=vox, max_results=kmax)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        runs.append((r, kmax, ms, {k: n - c0[k] for k, n in counts().items() if n > c0[k]}, res))
    map_counts = counts()
    knn._launch, knn_rows._launch = o_k7, o_k2
    print(f"[smoke] map: {len(stored)} stored points, {q.shape[0]} queries | launches "
          f"{json.dumps(map_counts)} | K2 (V, k) {sorted(set(k2_shapes))}", flush=True)
    for r, kmax, ms, launched, res in runs:
        name = f"radius {r:.2f} m / {kmax}"
        n = _brute_check(torch, name, stored_d, q[:256], r, kmax,
                         tuple(t[:256] for t in res))
        print(f"[smoke] map: {name}: {ms:.2f} ms | launches {json.dumps(launched)} | 256 "
              f"queries equal brute force ({n:.2f} points each)", flush=True)
    for name in ("knn_rows", "masked_topk"):
        if map_counts[name] <= 0:
            _fail(f"kernel {name} did not launch in the map phase")
    for want in ((8, 16), (27, 16), (27, 64)):
        if want not in k2_shapes:
            _fail(f"K2 did not launch with (V, k) = {want} in the map phase")
    if "masked_topk" not in runs[3][3]:
        _fail("radius_search's wide branch did not launch K7")

    # (b) K7 and K2 at k = 64 against their plain versions
    a7, kw7 = cap["k7"]
    g = _once("K7", knn.masked_topk, lambda: knn.masked_topk(*a7, **kw7))
    w = knn.masked_topk_reference(*a7, **kw7)
    if not (torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])):
        _fail("K7 sq/valid differ from the plain version")
    err = _maxerr(g[0][w[2]], w[0][w[2]])
    if err != 0.0:
        _fail(f"K7 neighbours differ where valid: {err:.3e}")
    N7, C7 = a7[1].shape
    n_valid = int(a7[1].sum())
    d2_7 = knn.masked_d2(*a7)
    report("masked_topk", err, lambda: knn.masked_topk(*a7, **kw7),
           lambda: knn.masked_topk_reference(*a7, **kw7),
           N7 * C7 + 12 * n_valid + _nbytes(a7[2], *g), 8 * n_valid,
           lambda: torch.topk(d2_7, kw7["k"], dim=1, largest=False),
           f"(N={N7}, C={C7}, k={kw7['k']}, {n_valid / (N7 * C7):.3f} valid; one of "
           f"{map_counts['masked_topk']} chunks)", launches=map_counts["masked_topk"])

    a2, kw2 = cap["k2_64"]
    g = _once("K2 k=64", knn_rows.topk_from_rows, lambda: knn_rows.topk_from_rows(*a2, **kw2))
    w = knn_rows.topk_from_rows_reference(*a2, **kw2)
    if not (torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])):
        _fail("K2 (k = 64) sq/valid differ from the plain version")
    err = _maxerr(g[0][w[2]], w[0][w[2]])
    if err != 0.0:
        _fail(f"K2 (k = 64) neighbours differ where valid: {err:.3e}")
    d2_2 = knn_rows.candidate_d2(*a2, E=kw2["E"], B=kw2["B"])[0]
    ms = _time_ms(lambda: knn_rows.topk_from_rows(*a2, **kw2))
    dms = _device_ms(lambda: knn_rows.topk_from_rows(*a2, **kw2), "fl_knn_rows")
    pms = _time_ms(lambda: knn_rows.topk_from_rows_reference(*a2, **kw2), reps=3)
    lms = _time_ms(lambda: torch.topk(d2_2, 64, dim=1, largest=False))
    ldms = _device_ms(lambda: torch.topk(d2_2, 64, dim=1, largest=False))
    bms, by = _bound(*_k2_work(*a2, g, d2_2, kw2["E"]))
    print(f"[smoke] kernel knn_rows (k=64): max_abs_err {err:.3e} | {ms:.4f} ms (device "
          f"{_fmt(dms)}) vs plain {pms:.4f} ms | bound {bms:.4f} ms ({by}) | one PyTorch call "
          f"{lms:.4f} ms (device {_fmt(ldms)}) (N={a2[0].shape[0]}, V={a2[0].shape[1]}, k=64)",
          flush=True)

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


def _cuda_launches(torch, fn, prefix: str):
    """CUDA kernels named ``prefix*`` that one call of fn() launches, as
    torch.profiler records them ("not measured" if it records none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n = sum(e.count for e in events if e.key.startswith(prefix))
    return n if events else "not measured"


def _replay_timed(torch, loc, method, stamps, acc, gyro, scans):
    """Replay in arrival order (then flush), timing each call of
    ``loc.<method>`` on the host between two synchronises; returns
    [(ms, scans in the call)]."""
    times, orig = [], getattr(loc, method)

    def timed(arg):
        torch.cuda.synchronize()
        t = time.perf_counter()
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
    chunk_ms = _replay_timed(torch, loc4, "_dispatch_chunk", stamps, acc, gyro, scans)
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
    for name in ("deskew", "knn_rows", "fit_planes", "hstats", "sort3"):
        if c[name] <= 0:
            _fail(f"kernel {name} did not launch on the split-body path")
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
    the CLI."""
    import contextlib
    import io

    import torch

    from fast_limo_tpu_torch import cli
    from fast_limo_tpu_torch.models import pipeline as pl
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
    zero()
    t0 = time.perf_counter()
    scans = _drive(slam, seq)
    torch.cuda.synchronize()
    t_soak = time.perf_counter() - t0
    c = counts()
    est, gt = slam.positions(), seq.traj.pos(slam.stamps())
    kf_rmse = _kf_rmse(slam, seq)
    tail_rmse = float(np.sqrt(np.mean(np.sum((est[-60:] - gt[-60:]) ** 2, axis=1))))

    def p50(v):
        return f"{np.percentile(v, 50):.1f} (x{len(v)})" if v else "none"

    print(f"[smoke] slam: (a) soak {len(est)} scans in {t_soak:.1f} s (data included) | loops "
          f"{slam.n_loops_closed} | keyframes {len(slam.keyframes)} | map rebuilds "
          f"{slam.n_rebuilds} | keyframe RMSE {kf_rmse:.4f} m | last-60-scan RMSE "
          f"{tail_rmse:.4f} m | launches {json.dumps(c)}", flush=True)
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

    # (d) the CLI, in-process
    out_path = os.path.join(dispatch.BUILD_DIR, "smoke_cli.tum")
    dump_path = os.path.join(dispatch.BUILD_DIR, "smoke_cli_debug.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["synthetic", "--scans", "24", "--debug-dump", dump_path, "--out", out_path])
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
    os.remove(out_path)
    os.remove(dump_path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--profile", action="store_true",
                    help="also profile the steady scans of a one-scan and a "
                         "chunked (C = 4) replay (torch.profiler)")
    args = ap.parse_args()

    # ---- 1. device ----
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = _smi()
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
        "knn_rows": (knn_rows.topk_from_rows, "fast_limo_tpu_torch/csrc/knn_rows.cu",
                     "fast_limo_tpu/ops/knn_rows.py:107"),
        "fit_planes": (plane_kernel.fit_planes, "fast_limo_tpu_torch/csrc/plane.cu",
                       "fast_limo_tpu/ops/plane_kernel.py:193"),
        "hstats": (hstats.hstats, "fast_limo_tpu_torch/csrc/hstats.cu",
                   "fast_limo_tpu/ops/hstats.py:194"),
        "update_body": (update_body.update_body, "fast_limo_tpu_torch/csrc/update_body.cu",
                        "fast_limo_tpu/ops/update_body.py:448"),
        "update_loop": (update_loop.update_loop, "fast_limo_tpu_torch/csrc/update_loop.cu",
                        "fast_limo_tpu/ops/update_loop.py:394"),
        "masked_topk": (knn.masked_topk, "fast_limo_tpu_torch/csrc/masked_topk.cu",
                        "fast_limo_tpu/ops/knn.py:52"),
        "gain": (gain.gain, "fast_limo_tpu_torch/csrc/gain.cu",
                 "fast_limo_tpu/ops/gain.py:157"),
        "sort3": (sort.sort3, "fast_limo_tpu_torch/csrc/sort3.cu",
                  "fast_limo_tpu/ops/sort.py:98"),
    }

    def counts():
        return {k: w[0].launches for k, w in wrappers.items()}

    def zero():
        for w in wrappers.values():
            w[0].launches = 0

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

    def dispatch_timed(scan):
        capturing = len(scan_ms) == capture_at
        cap["on"] = capturing
        torch.cuda.synchronize()
        t = time.perf_counter()
        if capturing:   # the steady scan's synchronizing calls, by source line
            cap["syncs"] = _sync_calls(lambda: orig_dispatch(scan))[1]
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

    def knn_capture(rows, nc, q, **kw):
        if cap.get("on") and "knn" not in cap:
            cap["knn"] = (rows, nc, q, kw)
        return orig_knn(rows, nc, q, **kw)

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

    for w in wrappers.values():
        w[0].launches = 0
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
    for name in ("deskew", "knn_rows", "update_loop"):
        if main_counts[name] <= 0:
            _fail(f"kernel {name} did not launch on the main path")
    if main_counts["sort3"] != 2 * args.scans:
        _fail(f"K9 launched {main_counts['sort3']} times in {args.scans} scans, not twice a scan")
    for key in ("h_model", "deskew", "knn", "loop", "loop_out", "sort", "syncs"):
        if key not in cap:
            _fail(f"capture of scan {capture_at} missed {key}")
    sites = {f: cap["syncs"].count(f) for f in sorted(set(cap["syncs"]))}
    print(f"[smoke] main: scan {capture_at} under set_sync_debug_mode(\"warn\"): "
          f"{len(cap['syncs'])} synchronizing calls {json.dumps(sites)}", flush=True)
    wrapped = [f for f in sites if os.path.basename(f) in
               ("update_loop.py", "hstats.py", "update_body.py", "gain.py")]
    if wrapped:
        _fail(f"a kernel wrapper synchronized the host: {wrapped}")

    # ---- 4. fallback path on the captured scan ----
    h = cap["h_model"]
    (X, P, x_prop, R, D, limit), loop_kw = cap["loop"]
    xk, Pk, aux_k = cap["loop_out"]
    for w in wrappers.values():
        w[0].launches = 0
    h.loop_pack = None                        # force the exact per-iteration loop
    cap3 = {}
    o_fit, o_hs, o_ub = plane_kernel._launch, hstats._launch, update_body._launch

    def fit_cap(*a, **kw):
        cap3.setdefault("fit", (a, kw))
        return o_fit(*a, **kw)

    def hs_cap(*a, **kw):
        cap3.setdefault("hstats", (a, kw))
        return o_hs(*a, **kw)

    def ub_cap(*a, **kw):
        cap3.setdefault("body", (a, kw))
        return o_ub(*a, **kw)

    plane_kernel._launch, hstats._launch, update_body._launch = fit_cap, hs_cap, ub_cap
    x_f, P_f, n_f = iekf.update_iterated(
        x_prop, P, h, R=R, D=D, max_iters=loop_kw["max_iters"], limit=limit)
    glob0 = h.glob0
    ranked = h._window_rank(glob0)
    stale = torch.zeros_like(h.pc_valid)
    stale[: h.budget] = True
    h._patched_match(glob0, ranked, stale & h.pc_valid)
    h._match(glob0)
    torch.cuda.synchronize()
    plane_kernel._launch, hstats._launch, update_body._launch = o_fit, o_hs, o_ub
    fb_counts = counts()
    print(f"[smoke] fallback: launches {json.dumps(fb_counts)} | n_iters exact {int(n_f)} "
          f"vs whole-loop {int(aux_k[0])}", flush=True)
    for name in ("knn_rows", "fit_planes", "hstats", "update_body"):
        if fb_counts[name] <= 0:
            _fail(f"kernel {name} did not launch in the fallback phase")
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
               kernel=None):
        """A kernel row: CUDA-event times through the wrapper (ms) and of the
        plain version, the kernel's own device time (device_ms, torch.profiler
        matched by kernel name over as many reps), the bound, and the one
        PyTorch call's event and device times."""
        kernel = kernel or name
        ms, pms = _time_ms(k_fn), _time_ms(p_fn, reps=3)
        dms = _device_ms(k_fn, "fl_" + kernel)
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

    # K1 deskew — rtol 1e-4 / atol 2e-4 (f32 association, transcendental ulps)
    pts, t_pts, valid, frames, x_last, q_ext, t_ext = cap["deskew"]

    def k1():
        return deskew_kernel.deskew(pts, t_pts, valid, frames, x_last.rot, x_last.pos,
                                    q_ext, t_ext)

    def k1_plain():
        return deskew_kernel.deskew_plain(
            pts, t_pts, valid, deskew_kernel.frame_table(frames),
            deskew_kernel._scalars(q_ext, t_ext, x_last.rot, x_last.pos))

    a, b = _once("K1", deskew_kernel.deskew, k1), k1_plain()
    err = max(_close("K1 xt2", a[0], b[0], 1e-4, 2e-4), _close("K1 world", a[1], b[1], 1e-4, 2e-4))
    # ~140 float32 operations a valid point (interpolation, two rotations)
    report("deskew", err, k1, k1_plain, _nbytes(pts, t_pts, valid, *a), 140 * int(valid.sum()),
           extra=f"(N={pts.shape[0]})")

    # K2 knn_rows — sq and valid bit-equal, nbrs equal where finite
    rows, nc, q, kw = cap["knn"]
    a = _once("K2", knn_rows.topk_from_rows,
              lambda: knn_rows.topk_from_rows(rows, nc, q, **kw))
    b = knn_rows.topk_from_rows_reference(rows, nc, q, **kw)
    if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])):
        _fail(f"K2 sq/valid differ from the plain version (max {_maxerr(a[1][b[2]], b[1][b[2]]):.3e})")
    err = _maxerr(a[0][b[2]], b[0][b[2]])
    if err != 0.0:
        _fail(f"K2 neighbours differ where distances are finite: {err:.3e}")
    d2_k2 = knn_rows.candidate_d2(rows, nc, q, E=kw["E"], B=kw["B"])[0]
    nb2, ops2 = _k2_work(rows, nc, q, a, d2_k2, kw["E"])
    report("knn_rows", err, lambda: knn_rows.topk_from_rows(rows, nc, q, **kw),
           lambda: knn_rows.topk_from_rows_reference(rows, nc, q, **kw), nb2, ops2,
           lambda: torch.topk(d2_k2, kw["k"], dim=1, largest=False),
           f"(N={q.shape[0]}, V={rows.shape[1]}, k={kw['k']})")

    # K3 fit_planes — gates agree on ≥ 99.5 %; rtol 5e-3 / atol 5e-4 where both good
    fa, fkw = cap3["fit"]
    a = _once("K3", plane_kernel.fit_planes, lambda: plane_kernel.fit_planes(*fa, **fkw))
    b = plane_kernel.fit_planes_plain(*fa, **fkw)
    agree = float((a[1] == b[1]).float().mean())
    if agree < 0.995:
        _fail(f"K3 gate agreement {agree:.4f} < 0.995")
    both = a[1] & b[1]
    err = _close("K3 n_abcd", a[0][both], b[0][both], 5e-3, 5e-4)
    # ~250 float32 operations a query (5-point moments, normal, gates)
    report("fit_planes", err, lambda: plane_kernel.fit_planes(*fa, **fkw),
           lambda: plane_kernel.fit_planes_plain(*fa, **fkw), _nbytes(*fa, *a),
           250 * fa[0].shape[0], extra=f"(N={fa[0].shape[0]}, gate agreement {agree:.5f})")

    # K4 hstats — rtol 1e-5 of each entry's sum of term magnitudes: both
    # sides sum the same 10^4 float32 products in different orders, and the
    # rounding of a sum scales with Σ|terms| (for the diagonal of HᵀH that
    # is the entry itself, elsewhere it covers cancellation)
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
    cols, hneg = hstats.h_rows(tuple(X4[i * Np4:(i + 1) * Np4] for i in range(8)), sc4, **hkw)
    Ha = torch.stack(cols, dim=-1).double().abs()
    err = max(_close("K4 HTH", a[0], b[0], 1e-5, 0.0, scale=Ha.T @ Ha),
              _close("K4 HTh", a[1], b[1], 1e-5, 0.0, scale=Ha.T @ hneg.double().abs()))
    H4 = torch.stack(cols, dim=-1).contiguous()
    # ~290 float32 operations a point: its H row (~110) and its share of
    # the 78 + 12 sums of HᵀH and Hᵀh (2 each)
    report("hstats", err, k4, lambda: hstats.hstats_plain(X4, sc4, **hkw),
           _nbytes(X4, sc4, *a), 290 * Np4, lambda: torch.matmul(H4.T, H4),
           f"(Np={Np4}, {n4} CUDA kernel a call, bit-equal run to run)")

    # K5 update_body — x rtol 1e-3 / atol 1e-4, P and dx_ rtol 1e-3 / atol 1e-3
    # (Jacobi vs eigh guard, f32 gain conditioning)
    ba, bkw = cap3["body"]
    a = _once("K5", update_body.update_body,
              lambda: _no_sync("K5's wrapper", lambda: update_body.update_body(*ba, **bkw)))
    b = update_body.update_body_plain(*ba, **bkw)
    err = max(_close("K5 x", st.as_vector(a[0]), st.as_vector(b[0]), 1e-3, 1e-4),
              _close("K5 P", a[1], b[1], 1e-3, 1e-3), _close("K5 dx_", a[2], b[2], 1e-3, 1e-3))
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

    # K9 sort3 — all three outputs bit-equal to the plain version, on the
    # voxel sort (N = 32768) and the insert sort (N = 10000) of the
    # captured scan; one PyTorch call: the stable int64 packed-key sort the
    # port ran before K9
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
        packed = (k1.long() << 30) | k2.long() if what == "insert" else k1.long()
        n_cuda = _cuda_launches(torch, lambda: sort.sort3(k1, k2, v), "fl_sort3")
        report(name, 0.0, lambda: sort.sort3(k1, k2, v), lambda: sort.sort3_plain(k1, k2, v),
               24 * k1.shape[0], 0, lambda: torch.sort(packed, stable=True),
               f"(N={k1.shape[0]}, {what} sort, {n_cuda} CUDA launches a call)", kernel="sort3")
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
    _slam_phase(dev, cfg, counts, zero)

    # ---- 10. result ----
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
