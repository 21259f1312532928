"""Multi-rank scan step (port of fast_limo_tpu/parallel/sharded.py).

The voxel-hash map is partitioned over the mesh axis ``"map"`` by block
ownership (each rank owns the global hash groups whose high part equals
its index, models/mapper.py), queries are replicated, each rank's top-k
over its owned candidates merges with an all-gather, and the small iEKF
algebra runs replicated on every rank.  A second axis ``"data"``
(``make_mesh_2d``) additionally splits the matching work (query slices,
HᵀH psum).  The collectives go through parallel/collectives.py.

A ``Mesh`` names its axes and its backend:

* ``"inprocess"`` — every rank in this process, one thread a rank, on one
  device (one card, one CUDA stream).  The state is GLOBAL, in the
  single-card layout: one ``table`` / ``ptable`` of ``G·D`` rows (``G =
  cfg.tpu.map_capacity`` / 16 a shard), of which map rank m works on the
  view of rows ``[m·G, (m+1)·G)``; the global table is the single-card
  table of capacity ``G·D`` after the same inserts, so checkpoints and
  the parameter carry-over need no reshuffle.
* ``"gloo"`` — one rank a process over ``torch.distributed`` (initialised
  with parallel/distributed.initialize; CPU tensors), 1-D meshes only.  Each process holds
  only its own shard: a state of ``cfg.tpu.map_capacity`` entries;
  distributed.fetch / save_checkpoint / load_checkpoint convert to and
  from the global layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fast_limo_tpu_torch.models import mapper
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.parallel import collectives
from fast_limo_tpu_torch.utils.config import Config

AXIS = "map"
QUERY_AXIS = "data"
BACKENDS = ("inprocess", "gloo")


class Mesh:
    """Named axes (row-major rank layout) and the backend that runs them;
    ``comms`` holds the handles of the ranks in this process (all of them
    in-process, this process's one over gloo)."""

    def __init__(self, axes: Dict[str, int], backend: str = "inprocess"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.axes = dict(axes)
        self.backend = backend
        if backend == "inprocess":
            self._group = collectives.InProcessGroup(self.axes)
            self.comms = self._group.comms
        else:
            self._group = None
            self.comms = [collectives.DistComm(self.axes)]
        self.size = self.comms[0].size

    @property
    def rank(self) -> int:
        """This process's first rank (0 in-process)."""
        return self.comms[0].rank

    def run(self, fn) -> list:
        """``fn(comm)`` on every rank of this process, results in rank
        order (in-process: all ranks, in threads; gloo: this one)."""
        if self._group is not None:
            return self._group.run(fn)
        return [fn(self.comms[0])]

    def received(self, rank: int = None) -> Dict[str, int]:
        """The bytes ``rank`` (default: this process's first) received so
        far, by tag."""
        c = self.comms[0] if rank is None else self.comms[rank]
        return {k: int(v) for k, v in c.received.items()}

    def reset_received(self) -> None:
        for c in self.comms:
            c.received.clear()


def make_mesh(n_ranks: int, backend: str = "inprocess") -> Mesh:
    return Mesh({AXIS: n_ranks}, backend)


def make_mesh_2d(n_map: int, n_data: int, backend: str = "inprocess") -> Mesh:
    """2-D mesh: 'map' (hash-sharded map memory) × 'data' (query slices)."""
    return Mesh({AXIS: n_map, QUERY_AXIS: n_data}, backend)


def _state_specs(cfg: Config = None) -> pl.LIOState:
    """Which leaves are sharded: the map's table rows over AXIS, the rest
    replicated (None)."""
    return pl.LIOState(
        x=st.NavState(*([None] * len(st.NavState._fields))), P=None,
        map=mapper.VoxelHashMap(table=AXIS, ptable=AXIS, num_points=None, last_time=None),
        prev_scan_stamp=None, last_prop_time=None, last_w_raw_bl=None, last_w=None,
        last_a=None, bias_gyro_corr=None, bias_accel_corr=None, pinned_grav=None)


def comm_volume(cfg: Config, n_map: int, n_data: int = 1) -> dict:
    """Analytic per-scan, per-rank collective payloads (bytes) of the JAX
    sharded step, a copy of the JAX package's function (ring accounting:
    an all-gather receives (D−1)/D of the global payload; an all-reduce
    moves 2(D−1)/D of it).  It counts the STATIC collectives of the
    compiled JAX program: one frozen top-W window resolve, and per
    evaluation the stale patch and the full re-gather (both cond branches)
    and the cap and gate collectives of all three branches.  The port
    computes both re-gathers every evaluation and finishes the selected
    branch once (parallel/collectives.py counts what it moves), so its
    count equals every term but ``cap_allgather_bytes`` and
    ``gate_psum_bytes``, of which it moves one third
    (tests/test_torch_sharded.py)."""
    from fast_limo_tpu_torch.models.measurement import STALE_BUDGET, window_size

    k = cfg.ikfom.mapping.NUM_MATCH_POINTS
    n_q = cfg.ikfom.mapping.MAX_NUM_PC2MATCH // max(n_data, 1)
    itemsize = np.dtype(cfg.tpu.dtype).itemsize
    evals = cfg.ikfom.MAX_NUM_ITERS + 1

    def per_resolve(kk, nq):   # nbrs (Nq,kk,3) + sq (Nq,kk) from D_m−1 peers
        return (n_map - 1) * nq * kk * 4 * itemsize

    knn_gather = (per_resolve(window_size(k), n_q)
                  + (per_resolve(k, n_q) + per_resolve(k, STALE_BUDGET)) * evals)
    stats_psum = (2 * (n_data - 1) / max(n_data, 1)) * 156 * itemsize * evals
    cap_gather = (n_data - 1) * 4 * 3 * evals if n_data > 1 else 0
    cert_psum = (2 * (n_data - 1) / n_data * 4 * 2 * evals if n_data > 1 else 0)
    count_psum = 2 * (n_map - 1) / n_map * 4 if n_map > 1 else 0
    gate = cfg.ikfom.mapping.DYNAMIC_GATE
    gate_psum = (2 * (n_data - 1) / n_data * 4 * itemsize * 3 * evals
                 if (gate > 0 and n_data > 1) else 0)
    executed = (per_resolve(window_size(k), n_q) + stats_psum + cert_psum
                + count_psum + (cap_gather + gate_psum) / 3)
    return {
        "knn_allgather_bytes": int(knn_gather),
        "cap_allgather_bytes": int(cap_gather),
        "hstats_psum_bytes": int(stats_psum),
        "gate_psum_bytes": int(gate_psum),
        "cert_psum_bytes": int(cert_psum),
        "num_points_psum_bytes": int(count_psum),
        "total_bytes": int(knn_gather + cap_gather + stats_psum + gate_psum
                           + cert_psum + count_psum),
        "executed_typical_bytes": int(executed),
    }


def init_global_state(cfg: Config, n_map_shards: int, device="cuda") -> pl.LIOState:
    """Initial LIOState with the map at the GLOBAL capacity
    (``cfg.tpu.map_capacity`` entries a 'map' shard); also the template
    of a global checkpoint."""
    s = pl.init_state(cfg, device)
    m = mapper.create(cfg.tpu.map_capacity * n_map_shards, cfg.map_points_per_voxel,
                      s.P.device)
    return s._replace(map=m)


def map_shard(m: mapper.VoxelHashMap, index: int, n_map: int) -> mapper.VoxelHashMap:
    """Shard ``index`` of a global map: the views of its table rows."""
    G = m.groups // n_map
    rows = slice(index * G, (index + 1) * G)
    return m._replace(table=m.table[rows], ptable=m.ptable[rows])


def shard_view(state: pl.LIOState, index: int, n_map: int) -> pl.LIOState:
    """Map shard ``index``'s state: its map rows, every other leaf as it is."""
    return state._replace(map=map_shard(state.map, index, n_map))


def build_sharded_scan_step(cfg: Config, mesh: Mesh, device="cuda"):
    """Returns (sharded scan_step, initial state) on ``device``.

    ``cfg.tpu.map_capacity`` is the PER-SHARD capacity.  Works on a 1-D
    ('map',) or 2-D ('map','data') mesh.  In-process the step takes and
    returns the global state (see the module docstring) and rank 0's
    ScanOutput (every output is replicated); over gloo, this process's
    shard state and output."""
    n = mesh.axes[AXIS]
    has_query = QUERY_AXIS in mesh.axes
    inners = {c.rank: pl.build_scan_step(
        cfg, device, shard_axis=AXIS, num_shards=n,
        query_axis=QUERY_AXIS if has_query else None,
        num_query_shards=mesh.axes.get(QUERY_AXIS, 1), comm=c) for c in mesh.comms}
    if mesh.backend != "inprocess":
        return inners[mesh.rank], pl.init_state(cfg, device)

    # the rank that carries map shard m's new table (its data-axis index 0)
    owners = [mesh.comms[0].rank_of({**mesh.comms[0].coords(0), AXIS: m}) for m in range(n)]

    def step(state: pl.LIOState, batch: pl.ScanBatch):
        res = mesh.run(lambda c: inners[c.rank](shard_view(state, c.axis_index(AXIS), n), batch))
        s0, out0 = res[0]
        maps = [res[r][0].map for r in owners]
        m = s0.map._replace(table=torch.cat([mm.table for mm in maps]),
                            ptable=torch.cat([mm.ptable for mm in maps]))
        return s0._replace(map=m), out0

    return step, init_global_state(cfg, n, device)
