"""The port's twin of the JAX repository's ``__graft_entry__``:
``entry()``, the flagship per-scan step (``pipeline.build_scan_step``) at
tiny shapes plus example arguments, ready to call on the card
(``device="cuda"``, the default) or the CPU, and ``dryrun_multichip(n)``,
the sharded step on the meshes of parallel/sharded.py.

    step, (state, batch) = entry(device="cpu")
    state2, out = step(state, batch)

``_tiny_cfg`` and ``_example_batch`` are ``__graft_entry__._tiny_cfg`` and
``_example_batch`` field for field (the same seeded numpy draws), so both
packages start from the same state and batch.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.ops import dispatch
from fast_limo_tpu_torch.utils.config import Config


def _tiny_cfg(n_pts: int = 512, map_cap: int = 4096, n_shards: int = 1) -> Config:
    cfg = Config()
    cfg.sensor_type = 1
    cfg.gravity_align = cfg.calibrate_accel = cfg.calibrate_gyro = False
    cfg.time_offset = False
    cfg.debug = cfg.verbose = False
    cfg.intrinsics.accel_bias = [0.0, 0.0, 0.0]
    cfg.intrinsics.gyro_bias = [0.0, 0.0, 0.0]
    cfg.filters.crop_active = False
    cfg.filters.dist_active = False
    cfg.filters.voxel_active = True
    cfg.filters.leafSize = [0.5, 0.5, 0.5]
    cfg.ikfom.estimate_extrinsics = True
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = n_pts
    cfg.ikfom.mapping.MAX_NUM_MATCHES = n_pts
    cfg.tpu.max_points_per_scan = n_pts
    cfg.tpu.map_capacity = map_cap
    cfg.tpu.map_points_per_voxel = 2
    cfg.tpu.imu_batch = 8
    cfg.tpu.hash_probes = 8
    cfg.tpu.num_map_shards = n_shards
    return cfg


def _example_batch(cfg: Config, seed: int = 0, device="cuda") -> pl.ScanBatch:
    device = dispatch.resolve_device(device)
    rng = np.random.default_rng(seed)
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return pl.ScanBatch(
        points=t(rng.uniform(-20, 20, (N, 3))),
        t_raw=t(rng.uniform(0, 0.1, N)),
        valid=torch.ones(N, dtype=torch.bool, device=device),
        stamp=t(0.0),
        epoch_shift=t(0.1),
        imu_acc=t(rng.normal(0, 0.1, (K, 3)) + [0, 0, 9.81]),
        imu_gyro=t(rng.normal(0, 0.01, (K, 3))),
        imu_stamp=t(np.linspace(0.01, 0.105, K)),
        imu_valid=torch.ones(K, dtype=torch.bool, device=device),
    )


def entry(device="cuda"):
    """(fn, example_args) for the flagship per-scan step on ``device``."""
    cfg = _tiny_cfg()
    step = pl.build_scan_step(cfg, device)
    return step, (pl.init_state(cfg, device), _example_batch(cfg, device=device))


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The sharded scan step on tiny shapes, executed, on every mesh
    layout (the JAX ``dryrun_multichip``):

    * 1-D ('map',) — ``n_ranks`` in-process ranks on ``device``;
    * 2-D ('map' n/2, 'data' 2) — when ``n_ranks`` is even and ≥ 4;
    * two processes over torch.distributed (gloo) on the CPU, one rank a
      process, through parallel/_dist_worker.py — when ``n_ranks`` is
      even: the process-spanning collectives and checkpoint round trip.

    Prints ``comm_volume`` of each mesh beside the bytes its rank 0
    received; returns the positions of each leg."""
    from fast_limo_tpu_torch.parallel import sharded

    device = dispatch.resolve_device(device)
    legs = {}
    mesh = sharded.make_mesh(n_ranks)
    cfg = _tiny_cfg(n_pts=512, map_cap=4096, n_shards=n_ranks)
    step, state = sharded.build_sharded_scan_step(cfg, mesh, device)
    state, out = step(state, _example_batch(cfg, device=device))
    pos = out.pos.cpu().numpy()
    if not np.isfinite(pos).all():
        raise RuntimeError(f"1-D mesh step gave non-finite positions {pos}")
    legs["1d"] = pos
    print(f"[dryrun] 1-D ('map',) mesh ok: {n_ranks} in-process ranks on {device}; comm/scan: "
          f"{sharded.comm_volume(cfg, n_ranks, 1)}; received by rank 0: {mesh.received(0)}",
          flush=True)

    if n_ranks >= 4 and n_ranks % 2 == 0:
        n_map = n_ranks // 2
        mesh2 = sharded.make_mesh_2d(n_map, 2)
        cfg2 = _tiny_cfg(n_pts=512, map_cap=4096, n_shards=n_map)
        step2, s2 = sharded.build_sharded_scan_step(cfg2, mesh2, device)
        for i in range(2):
            s2, out2 = step2(s2, _example_batch(cfg2, seed=i, device=device))
        pos2 = out2.pos.cpu().numpy()
        if not np.isfinite(pos2).all():
            raise RuntimeError(f"2-D mesh step gave non-finite positions {pos2}")
        legs["2d"] = pos2
        print(f"[dryrun] 2-D ('map'={n_map},'data'=2) mesh ok on {device}; comm/scan: "
              f"{sharded.comm_volume(cfg2, n_map, 2)}; received by rank 0 in 2 scans: "
              f"{mesh2.received(0)}", flush=True)

    if n_ranks >= 2 and n_ranks % 2 == 0:
        legs["processes"] = _dryrun_multiprocess()
    return legs


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(n_processes: int, out: str, scans: int = 2, checkpoint: str = None,
                timeout: float = 600.0) -> list:
    """Run parallel/_dist_worker.py in ``n_processes`` CPU processes over
    torch.distributed (gloo) and wait for them (at most ``timeout``
    seconds, then they are killed); returns their logs and raises on a
    failed one.  Rank 0 writes ``out``."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "fast_limo_tpu_torch", "parallel", "_dist_worker.py")
    port = free_port()
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""      # CPU processes: gloo on CPU tensors
    cmd = [sys.executable, worker, "--num-processes", str(n_processes), "--port", str(port),
           "--scans", str(scans), "--out", out]
    if checkpoint:
        cmd += ["--checkpoint", checkpoint]
    procs = [subprocess.Popen(cmd + ["--process-id", str(pid)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(n_processes)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"distributed worker {pid} failed (rc={p.returncode}):\n"
                               f"{logs[pid][-3000:]}")
    return logs


def _dryrun_multiprocess():
    """The process-spanning leg: 2 CPU processes, one rank each, over
    torch.distributed (gloo); the sharded step and the checkpoint saved
    from and restored onto both."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "dist.npz")
        run_workers(2, out, scans=2)
        d = np.load(out)
        if not bool(d["roundtrip_ok"]):
            raise RuntimeError("the two-process checkpoint round trip differs")
        print(f"[dryrun] process-spanning mesh ok: {int(d['n_processes'])} CPU processes x 1 "
              f"rank over torch.distributed (gloo), checkpoint round trip bit-equal", flush=True)
        return d["final_pos"]
