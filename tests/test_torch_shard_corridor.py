"""The sharded step on the bench corridor (``presets.bench_sequence``:
15 m/s, ±0.5 rad yaw weave, ``kitti_like_cfg``): how far each package's
sharded step lies from its own single-card step at the same global map
capacity.

The JAX package's own gap is what ``chip_smoke.py`` phase 11 bounds the
port by on the card (``JAX_SHARD_GAP``: max(3e-4 m / 3e-5, 1.25 × the
gap)).  ``PYTHONPATH=. python tests/test_torch_shard_corridor.py
--scans 24 --slots 32768`` prints it at phase 11's size (the 24 scans of
phase 3 at ``kitti_like_cfg``'s own 32768 slots; the ScanBatches come
from a port Localizer's ``on_dispatch`` and go to both packages): the
largest |Δpos| and |Δquat| between the JAX sharded step and the JAX
single-card step over the scans, for 'map' = 4 and for 'map' 2 × 'data'
2, one JSON line.  It runs the JAX package on the CPU (virtual devices);
it takes a few minutes.

As a test (CPU, small: 2048-slot sweeps stride-cut as in
tests/test_torch_packet_corridor.py, 4 scans, 'map' = 4): both gaps, the
port's within max(3e-4 m, 1.25 × the JAX package's) — the rule of phase
11 — and the port's sharded poses within 1e-3 m of the JAX sharded
step's.
"""

import dataclasses
import json
import os

if __name__ == "__main__":
    # the virtual CPU devices of tests/conftest.py, set before JAX starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import torch

import bench
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.parallel import sharded as jsh
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.parallel import batched, sharded
from fast_limo_tpu_torch.utils import presets

from test_torch_packet_corridor import _cfg, _port_cfg
from test_torch_sequence import one_thread  # noqa: F401 (fixture)

SCANS, SLOTS, D = 4, 2048, 4


def _batches(cfg, n_scans, slots):
    """The ScanBatches a port Localizer dispatches on the corridor (CPU)."""
    loc, cap = Localizer(cfg, device="cpu"), []
    loc.on_dispatch = lambda sp, ip: cap.append(batched.batch_from_packs(cfg, sp, ip, "cpu"))
    presets.replay(loc, presets.bench_sequence(n_scans=n_scans, points_per_scan=slots))
    assert len(cap) == n_scans
    return cap


def _per_shard(cfg, n_map):
    out = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu))
    out.tpu.map_capacity = cfg.tpu.map_capacity // n_map
    out.tpu.num_map_shards = n_map
    return out


def _gap(a, b):
    return {"pos": float(np.abs(a[0] - b[0]).max()), "quat": float(np.abs(a[1] - b[1]).max())}


def _jax_poses(step, state, batches):
    pos, quat = [], []
    for b in batches:
        jb = jpl.ScanBatch(*(np.asarray(t.numpy()) for t in b))
        state, out = step(state, jb)
        pos.append(np.asarray(out.pos))
        quat.append(np.asarray(out.quat))
    return np.stack(pos), np.stack(quat)


def jax_gaps(n_scans, slots, layouts=((D, 1), (2, 2))):
    """{layout: the JAX sharded step's gap to the JAX single card}."""
    jcfg = _cfg(bench.kitti_like_cfg(), slots)
    batches = _batches(_cfg(_port_cfg(bench.kitti_like_cfg()), slots), n_scans, slots)
    single = _jax_poses(jpl.build_scan_step(jcfg, donate=False), jpl.init_state(jcfg), batches)
    out = {}
    for n_map, n_data in layouts:
        mesh = jsh.make_mesh(n_map) if n_data == 1 else jsh.make_mesh_2d(n_map, n_data)
        poses = _jax_poses(*jsh.build_sharded_scan_step(_per_shard(jcfg, n_map), mesh), batches)
        out[f"map{n_map}" + (f"xdata{n_data}" if n_data > 1 else "")] = (_gap(poses, single),
                                                                         poses)
    return out, batches


def _port_poses(step, state, batches):
    pos, quat = [], []
    for b in batches:
        state, out = step(state, b)
        pos.append(out.pos.numpy())
        quat.append(out.quat.numpy())
    return np.stack(pos), np.stack(quat)


def test_port_gap_within_the_jax_gap(one_thread):  # noqa: F811
    gaps, batches = jax_gaps(SCANS, SLOTS, layouts=((D, 1),))
    jgap, jposes = gaps[f"map{D}"]
    cfg = _cfg(_port_cfg(bench.kitti_like_cfg()), SLOTS)
    single = _port_poses(pl.build_scan_step(cfg, "cpu"), pl.init_state(cfg, "cpu"), batches)
    poses = _port_poses(*sharded.build_sharded_scan_step(_per_shard(cfg, D),
                                                         sharded.make_mesh(D), "cpu"), batches)
    gap = _gap(poses, single)
    print(f"corridor, {SCANS} scans at {SLOTS} slots, 'map' = {D}: gap to the single card "
          f"port {gap}, JAX {jgap}")
    assert gap["pos"] <= max(3e-4, 1.25 * jgap["pos"])
    assert gap["quat"] <= max(3e-5, 1.25 * jgap["quat"])
    np.testing.assert_allclose(poses[0], jposes[0], rtol=0, atol=1e-3)
    assert torch.isfinite(torch.tensor(poses[1])).all()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=24)
    ap.add_argument("--slots", type=int, default=32768)
    a = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    res, _ = jax_gaps(a.scans, a.slots)
    print(json.dumps({"scans": a.scans, "slots": a.slots, "jax_gap_to_single_card":
                      {k: v[0] for k, v in res.items()}}))
