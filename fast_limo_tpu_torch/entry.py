"""The port's twin of the JAX repository's ``__graft_entry__.entry()``:
the flagship per-scan step (``pipeline.build_scan_step``) at tiny shapes
plus example arguments, ready to call on the card (``device="cuda"``, the
default) or the CPU.

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


def _tiny_cfg(n_pts: int = 512, map_cap: int = 4096) -> Config:
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
