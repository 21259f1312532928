"""Batched multi-session LIO on one card (port of
fast_limo_tpu/parallel/batched.py): S independent odometry sessions — S
robots, or S map-reprocessing jobs — advance in lockstep, one tick at a
time, with their states stacked on a leading session axis.

The JAX package ``jax.vmap``s its scan step over that axis.
``torch.func.vmap`` cannot reach the port's ctypes kernels, so the port's
step runs the per-scan step (``pipeline.build_scan_step``) on each
session's slice in turn and keeps or drops the result on the device with a
select (``pipeline._select``), as ``build_scan_chunk_step`` does for
padding: nothing is read on the host, and each session runs exactly the
code its own single-session step runs, in the same order, so its poses are
bit-equal to that step's on the same batches (``tests/test_torch_batched.py``,
``chip_smoke.py``).  A tick launches every kernel of the step once a
session.

Sessions advance together; a session with no scan ready this tick feeds a
placeholder batch (``noop_batch``) with ``active`` False, which carries its
state over bit for bit.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.ops import dispatch
from fast_limo_tpu_torch.utils.config import Config


def build_batched_scan_step(cfg: Config, device="cuda"):
    """The per-scan step over a session axis with a per-session activity mask.

    Returns ``step(states, batches, active) -> (states', outs)`` where every
    tensor carries a leading session axis and ``active (S,) bool`` (a
    device tensor, never read on the host) selects, per session, the stepped
    state (True) or an exact carry-over of the previous state (False) — so
    idle sessions lose nothing, not even carried clocks.  ``outs`` stacks
    every session's ``ScanOutput``; an idle session's is that of its
    placeholder step."""
    device = dispatch.resolve_device(device)
    inner = pl.build_scan_step(cfg, device)

    def step(states: pl.LIOState, batches: pl.ScanBatch, active):
        new, outs = [], []
        for i in range(active.shape[0]):
            s = select_session(states, i)
            s2, out = inner(s, select_session(batches, i))
            new.append(pl._select(active[i], s2, s))
            outs.append(out)
        return pl._stack(new), pl._stack(outs)

    return step


def init_batched_state(cfg: Config, n_sessions: int, device="cuda") -> pl.LIOState:
    """S independent initial states stacked on a leading session axis."""
    s = pl.init_state(cfg, device)
    return pl._stack([s] * n_sessions)


def stack_batches(batches) -> pl.ScanBatch:
    """Stack per-session ScanBatches along the session axis."""
    return pl._stack(list(batches))


def noop_batch(cfg: Config, device="cuda") -> pl.ScanBatch:
    """A batch that leaves a session's state unchanged (idle tick).

    All validity masks are false: the predict consumes no IMU (dt=0
    passthrough), the update is skipped by the NULL-ITERATION guard
    (pipeline.py: ``do_update``), nothing is inserted, and
    ``epoch_shift=0`` keeps the carried clocks fixed.  The step's select on
    ``active`` False then keeps the session's state bit for bit.
    """
    device = dispatch.resolve_device(device)
    N, K = cfg.tpu.max_points_per_scan, cfg.tpu.imu_batch
    f32 = torch.float32
    return pl.ScanBatch(
        points=torch.zeros((N, 3), dtype=f32, device=device),
        t_raw=torch.zeros(N, dtype=f32, device=device),
        valid=torch.zeros(N, dtype=torch.bool, device=device),
        stamp=torch.zeros((), dtype=f32, device=device),
        epoch_shift=torch.zeros((), dtype=f32, device=device),
        imu_acc=torch.zeros((K, 3), dtype=f32, device=device),
        imu_gyro=torch.zeros((K, 3), dtype=f32, device=device),
        imu_stamp=torch.zeros(K, dtype=f32, device=device),
        imu_valid=torch.zeros(K, dtype=torch.bool, device=device),
    )


def batch_from_packs(cfg: Config, scan_pack, imu_pack, device="cuda") -> pl.ScanBatch:
    """One session's ScanBatch from the host packs a Localizer dispatches
    (``scan_pack`` (N,4) and ``imu_pack`` (K,8), the arguments of its
    ``on_dispatch`` hook; int16 or float32 payload per
    ``tpu.quantize_transfer``), dequantized as the step dequantizes them:
    how a fleet takes its sessions' scans from Localizers' host packing.
    The packs are copied (the hook's buffers are the Localizer's)."""
    device = dispatch.resolve_device(device)
    read = pl._pack_reader(cfg, device, 4)
    return read(torch.tensor(scan_pack, device=device),
                torch.tensor(imu_pack, dtype=torch.float32, device=device))


def select_session(tree, i: int):
    """Session ``i``'s slice of a stacked (nested) NamedTuple (e.g. to hand
    its state to a Localizer): views, no copy."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(select_session(t, i) for t in tree))
    return tree[i]
