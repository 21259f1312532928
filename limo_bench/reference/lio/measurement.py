"""Point-to-plane measurement model for the iterated update (port of
fast_limo_tpu/models/measurement.py; reference Mapper::match
Mapper.cpp:59-114 + Localizer::calculate_H Localizer.cpp:537-577).

The CERTIFIED EXACT WINDOW RE-MATCH of the JAX package: the candidate
neighbourhood is resolved ONCE at the predicted pose x0 as a top-W window
per query (K2); every iteration re-matches exactly over that window, and
per-query staleness certificates prove a full re-gather could not differ.
The whole loop over the window runs in the K6 kernel (``loop_pack``); the
exact per-iteration path here (``stats``) is its fallback: window match
when no query is stale, the stale queries re-resolved in a patch of at
most ``stale_budget`` queries (K2 at k), or a full re-match (K2 at k).
The branch is chosen on the device from the stale count: ONE K2 launch
(``knn_rows.topk_from_table_select``) resolves the patch or every query
as the count selects, and ONE K3 launch (``plane_kernel.fit_planes_select``)
fits every query on the row of that branch (``_rematch_counted``).  K2
runs on the map table's rows by index, so no block-row gather is
materialised.

Sharded (``comm``, a rank's handle of parallel/collectives.py), as the
JAX package's ``shard_axis`` / ``query_axis`` branches:

* ``shard_axis``: the map is sharded by block ownership.  Every top-k —
  the window resolve, and each evaluation's stale patch and full
  re-gather — decodes this shard's owned candidates (gather →
  ``mapper.cands_from_rows`` with ``owned``) into K7's dense entry, then
  all-gathers (nbrs, sq) over the axis and keeps the k smallest of the
  D·k with a stable sort (ties to the lower shard, then the lower column:
  ``lax.top_k``'s order).  K2 has no owned mask and serves only the
  unsharded path.  Both re-gathers are computed every evaluation and the
  branch is selected on the device (K3's select entry), so the sequence of
  collectives is the same on every rank.  K6 still runs the loop on the
  replicated window.
* ``query_axis``: each rank matches its contiguous slice of the queries;
  the dynamic gate's sums, the stale count and the HᵀH / Hᵀh statistics
  are psum-reduced, the worst shard's stale count (pmax) picks the patch,
  and the match cap adds the keep-counts of the lower shards
  (all-gather).  There is no ``loop_pack``: the exact per-iteration loop
  runs every scan, since the psum stays outside any kernel.
"""

from __future__ import annotations

import torch

from reference.lio import mapper as mp
from reference.lio import state as st
from reference.lio import hstats as hstats_op
from reference.lio import knn_rows
from reference.lio import plane as plane_op
from reference.lio import plane_kernel
from reference.lio import so3
from reference.lio import update_loop as ul_op

STALE_BUDGET = 128


def window_size(k: int) -> int:
    """Frozen re-match WINDOW per query."""
    return k + 7


class HModel:
    """Measurement closures over baselink-frame pc2match points ``pc``."""

    def __init__(self, m: mp.VoxelHashMap, pc, pc_valid, *, voxel_size: float,
                 k: int, max_dist_plane: float, plane_threshold: float,
                 max_num_matches: int, estimate_extrinsics: bool,
                 x0: st.NavState, dynamic_gate: float = 0.0,
                 stale_budget: int = STALE_BUDGET, shard_axis: str = None,
                 num_shards: int = 1, query_axis: str = None, num_query_shards: int = 1,
                 comm=None):
        if (shard_axis or query_axis) and comm is None:
            raise ValueError("a sharded measurement model needs its rank's comm")
        if query_axis and not shard_axis:
            raise ValueError("the query axis is split beside a map axis (a 2-D mesh)")
        self.comm = comm
        self.shard_axis, self.num_shards = shard_axis, int(num_shards)
        self.query_axis = query_axis
        self.shard_index = comm.axis_index(shard_axis) if shard_axis else 0
        if query_axis is not None:
            # this rank's contiguous slice of the queries
            nq = pc.shape[0] // num_query_shards
            q0 = comm.axis_index(query_axis) * nq
            pc, pc_valid = pc[q0:q0 + nq], pc_valid[q0:q0 + nq]
        self.m, self.pc, self.pc_valid = m, pc, pc_valid
        self.voxel_size, self.k = float(voxel_size), int(k)
        self.max_dist_plane = float(max_dist_plane)
        self.plane_threshold = float(plane_threshold)
        self.max_num_matches = int(max_num_matches)
        self.estimate_extrinsics = bool(estimate_extrinsics)
        self.dynamic_gate = float(dynamic_gate)
        self.budget = min(int(stale_budget), int(pc.shape[0]))
        self._viol = None         # the last re-match's stale count

        # ---- ONE frozen resolve at the predicted pose ----
        W = window_size(k)
        self.W = W
        glob0 = so3.quat_rotate(x0.rot, pc) + x0.pos
        self.glob0 = glob0
        self.nbrs_w, sq_w, self.vld_w = self._topk(glob0, W, self._rows(glob0))
        self.cnt_w = torch.sum(self.vld_w, dim=-1)
        inf = torch.full_like(sq_w[:, 0], float("inf"))
        self.d_wmax = torch.where(self.cnt_w >= W, torch.sqrt(sq_w[:, W - 1]), inf)
        self.b0_frozen = (mp.voxel_coords(glob0, voxel_size) - 1) >> 1
        self.band_lo = (self.b0_frozen * 2 + 1).to(glob0.dtype) * self.voxel_size
        self.band_hi = self.band_lo + 2.0 * self.voxel_size

        # the whole masked loop incl. the window re-match is one K6 launch;
        # with query sharding the HᵀH psum stays outside it: no pack
        self.loop_pack = None if query_axis else ul_op.pack_window(
            pc, pc_valid, self.nbrs_w, self.vld_w, self.cnt_w)
        self.loop_window = ul_op.Window(
            k=self.k, W=W, voxel_size=self.voxel_size,
            max_dist_plane=self.max_dist_plane,
            plane_threshold=self.plane_threshold,
            max_num_matches=self.max_num_matches,
            dynamic_gate=self.dynamic_gate)

    # ------------------------------------------------------------ pieces
    @property
    def sharded(self) -> bool:
        """The map is sharded: every top-k goes through ``_topk_merged``."""
        return self.shard_axis is not None

    def _rows(self, glob):
        """Each query's block rows of the map: (row_idx (N,V), ncb (N,V,3),
        owned (N,V) or None)."""
        return mp.block_rows(self.m, glob, voxel_size=self.voxel_size,
                             num_shards=self.num_shards, shard_index=self.shard_index)

    def _topk(self, glob, kk, rows, active=None):
        """K2 over the queries' block rows (table form: the kernel reads
        the rows, they are never gathered); sharded, ``_topk_merged``."""
        if self.sharded:
            return self._topk_merged(glob, kk, rows)
        return knn_rows.topk_from_table(self.m.ptable, *rows[:2], glob, E=mp.E,
                                        B=self.m.bucket, k=kk, active=active)

    def _topk_merged(self, glob, kk, rows):
        """This shard's top-kk over its owned candidates (K7's dense
        entry), merged over the map axis into the global top-kk."""
        row_idx, ncb, owned = rows
        cand_pts, cand_valid = mp.cands_from_rows(self.m.ptable[row_idx.long()], ncb, owned,
                                                  self.m.bucket)
        nbrs, sq, _ = mp.topk_from_candidates(cand_pts, cand_valid, glob, k=kk)
        return merge_topk(self.comm.all_gather(nbrs, self.shard_axis, "knn_allgather_bytes"),
                          self.comm.all_gather(sq, self.shard_axis, "knn_allgather_bytes"), kk)

    def _psum(self, x, tag):
        return x if self.query_axis is None else self.comm.psum(x, self.query_axis, tag)

    def _dyn_gate(self, good, n_abcd, glob):
        """Robust residual gate: reject matches beyond gate·(two-pass robust
        mean |residual|), floored at 5 cm."""
        if self.dynamic_gate <= 0:
            return good
        ad = torch.abs(plane_op.point_to_plane(n_abcd, glob))
        gf = good.to(ad.dtype)

        def mean(w):
            s, n = self._psum(torch.sum(ad * w), "gate_psum_bytes"), \
                self._psum(torch.sum(w), "gate_psum_bytes")
            return s / torch.clamp(n, min=1.0)

        m1 = mean(gf)
        m2v = mean(gf * (ad <= 3.0 * m1 + 0.05).to(ad.dtype))
        return good & (ad <= torch.clamp(self.dynamic_gate * m2v, min=0.05))

    def _finish(self, n_abcd, good, glob):
        good = self._dyn_gate(good & self.pc_valid, n_abcd, glob)
        cum = torch.cumsum(good.to(torch.int32), dim=0)
        if self.query_axis is not None:
            # the cap in point order: add the keep-counts of the lower shards
            totals = self.comm.all_gather(cum[-1].to(torch.int32), self.query_axis,
                                          "cap_allgather_bytes")
            lower = torch.arange(totals.shape[0], device=cum.device) \
                < self.comm.axis_index(self.query_axis)
            cum = cum + torch.sum(torch.where(lower, totals, torch.zeros_like(totals)))
        return n_abcd, good & (cum <= self.max_num_matches)

    def _window_rank(self, glob):
        """Exact top-k over the frozen window at the current pose (stable
        sort: ties to the lowest slot, like lax.top_k)."""
        diff = glob[:, None, :] - self.nbrs_w
        d2 = torch.where(self.vld_w, torch.sum(diff * diff, -1),
                         torch.full_like(diff[..., 0], float("inf")))
        sel_sq, order = torch.sort(d2, dim=1, stable=True)
        sel_sq, order = sel_sq[:, :self.k], order[:, :self.k]
        sel_nbrs = torch.gather(self.nbrs_w, 1, order[..., None].expand(-1, -1, 3))
        return sel_nbrs, sel_sq

    def _stale_mask(self, glob, sel_sq):
        """Per-query certificate FAILURES (cert_a: outside-window entry;
        cert_b: block crossing keeps coverage)."""
        kth_d = torch.sqrt(sel_sq[:, self.k - 1])
        delta = torch.linalg.norm(glob - self.glob0, dim=-1)
        cert_a = (self.cnt_w < self.W) | (kth_d < self.d_wmax - delta)
        b0_same = torch.all(((mp.voxel_coords(glob, self.voxel_size) - 1) >> 1)
                            == self.b0_frozen, dim=-1)
        leave = torch.max(torch.maximum(self.band_lo - glob, glob - self.band_hi), dim=-1).values
        cert_b = kth_d < self.voxel_size - torch.clamp(leave, min=0.0)
        return self.pc_valid & ~(cert_a & (b0_same | cert_b))

    def _rematch_counted(self, glob, active=None):
        """``rematch`` plus the stale count (() int32) that chose its branch.

        The JAX ``cond`` chain, decided on the device: one K2 launch (its
        select entry, flag ``active``) reads the stale count and resolves
        the ``budget`` first queries by staleness (``0 < viol ≤ budget``),
        every query (``viol > budget``) or nothing.  Then one K3 launch
        (flag ``active``) fits each query on its window row, its patched
        row if it is stale and the patch is taken, or its full row."""
        ranked = self._window_rank(glob)
        stale = self._stale_mask(glob, ranked[1])
        viol = torch.sum(stale, dtype=torch.int32)
        # the stale queries first, in query order, as lax.top_k picks them
        idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:self.budget]
        if self.sharded:
            patch, full, viol, branch = self._rematch_sharded(glob, idx, viol)
        else:
            patch, full = knn_rows.topk_from_table_select(
                self.m.ptable, *self._rows(glob)[:2], glob, idx, viol, E=mp.E,
                B=self.m.bucket, k=self.k, active=active)
            branch = viol
        n_abcd, good = plane_kernel.fit_planes_select(
            ranked, patch, idx, stale, full, branch, num_match_points=self.k,
            max_dist_plane=self.max_dist_plane, plane_threshold=self.plane_threshold,
            active=active)
        self._viol = branch
        return (*self._finish(n_abcd, good, glob), viol)

    def _rematch_sharded(self, glob, idx, viol):
        """Both re-gathers (the stale patch of ``idx``, every query) through
        ``_topk_merged``, and the branch code for K3's select entry: 0
        window, 1 patch, ``budget + 1`` full.  With query sharding the
        stale count is the axis' sum and the patch needs the worst shard's
        count within the budget (the JAX cond's predicates)."""
        over = viol
        if self.query_axis is not None:
            over = self.comm.pmax(viol, self.query_axis, "cert_psum_bytes")
            viol = self.comm.psum(viol, self.query_axis, "cert_psum_bytes")
        qg = glob[idx]
        patch = self._topk(qg, self.k, self._rows(qg))
        full = self._topk(glob, self.k, self._rows(glob))
        branch = torch.where(viol == 0, 0, torch.where(over <= self.budget, 1, self.budget + 1))
        return patch, full, viol, branch.to(torch.int32)

    @property
    def last_branch(self):
        """The last re-match's branch as a () int32 code on the device: 0
        window, 1 patched, 2 full (None before any re-match)."""
        if self._viol is None:
            return None
        v = self._viol
        return torch.where(v > 0, torch.where(v <= self.budget, 1, 2), 0).to(torch.int32)

    def rematch(self, glob, active=None):
        """Per-iteration exact re-match: window fast path, stale patch, or a
        full re-gather when the stale count exceeds the budget."""
        return self._rematch_counted(glob, active)[:2]

    # -------------------------------------------------------------- API
    def stats(self, x: st.NavState, active=None):
        """(HᵀH (12,12), Hᵀh (12,)) at the iterate x (K4 statistics);
        ``active`` (() bool) is the re-match's and K4's flag (unspecified
        results on the card where it is clear)."""
        glob = so3.quat_rotate(x.rot, self.pc) + x.pos
        n_abcd, keep = self.rematch(glob, active)
        X = hstats_op.pack_inputs(self.pc, n_abcd, keep)
        HTH, HTh = hstats_op.hstats(X, hstats_op.pack_scalars(x),
                                    estimate_extrinsics=self.estimate_extrinsics, active=active)
        return self._psum(HTH, "hstats_psum_bytes"), self._psum(HTh, "hstats_psum_bytes")

    def debug(self, x: st.NavState):
        """Match telemetry at the iterate x (the JAX ``h_debug``): the
        re-matched planes ``n_abcd (Q,4)``, the final gate mask ``keep
        (Q,)``, the signed point-to-plane distances ``(Q,)`` and the number
        of queries whose window certificates fail there ``() int32``."""
        glob = so3.quat_rotate(x.rot, self.pc) + x.pos
        n_abcd, keep, viol = self._rematch_counted(glob)
        dist = plane_op.point_to_plane(n_abcd, glob)
        if self.query_axis is not None:
            # the shards' contiguous slices, reassembled in query order
            def unshard(a):
                g = self.comm.all_gather(a, self.query_axis, "debug_allgather_bytes")
                return g.reshape((-1,) + tuple(g.shape[2:]))

            n_abcd, keep, dist = unshard(n_abcd), unshard(keep), unshard(dist)
        return n_abcd, keep, dist, viol


def merge_topk(nbrs_g, sq_g, kk: int):
    """The global top-kk from the shards' all-gathered top-kk: ``nbrs_g``
    (D,N,kk,3), ``sq_g`` (D,N,kk) → (nbrs (N,kk,3), sq (N,kk), valid
    (N,kk)), ascending; a stable sort over the D·kk columns (shard-major),
    so ties keep the lower shard and, within it, the shard's order — the
    indices ``lax.top_k`` picks on the same columns."""
    D, N = sq_g.shape[0], sq_g.shape[1]
    sq_cat = sq_g.permute(1, 0, 2).reshape(N, D * kk)
    nbr_cat = nbrs_g.permute(1, 0, 2, 3).reshape(N, D * kk, 3)
    sq, order = torch.sort(sq_cat, dim=1, stable=True)
    sq, order = sq[:, :kk], order[:, :kk]
    nbrs = torch.gather(nbr_cat, 1, order[..., None].expand(-1, -1, 3))
    return nbrs, sq, torch.isfinite(sq)


def make_h_model(m: mp.VoxelHashMap, pc, pc_valid, **kw) -> HModel:
    """The measurement model (see HModel and the module docstring)."""
    return HModel(m, pc, pc_valid, **kw)
