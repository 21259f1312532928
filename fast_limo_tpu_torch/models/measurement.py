"""Point-to-plane measurement model for the iterated update (port of
fast_limo_tpu/models/measurement.py without its sharded/query-sharded
branches; reference Mapper::match Mapper.cpp:59-114 +
Localizer::calculate_H Localizer.cpp:537-577).

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
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import hstats as hstats_op
from fast_limo_tpu_torch.ops import knn_rows
from fast_limo_tpu_torch.ops import plane as plane_op
from fast_limo_tpu_torch.ops import plane_kernel
from fast_limo_tpu_torch.ops import so3
from fast_limo_tpu_torch.ops import update_loop as ul_op

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
                 stale_budget: int = STALE_BUDGET):
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

        # the whole masked loop incl. the window re-match is one K6 launch
        self.loop_pack = ul_op.pack_window(pc, pc_valid, self.nbrs_w, self.vld_w,
                                           self.cnt_w)
        self.loop_window = ul_op.Window(
            k=self.k, W=W, voxel_size=self.voxel_size,
            max_dist_plane=self.max_dist_plane,
            plane_threshold=self.plane_threshold,
            max_num_matches=self.max_num_matches,
            dynamic_gate=self.dynamic_gate)

    # ------------------------------------------------------------ pieces
    def _rows(self, glob):
        """Each query's block rows of the map: (row_idx (N,V), ncb (N,V,3))."""
        return mp.block_rows(self.m, glob, voxel_size=self.voxel_size)

    def _topk(self, glob, kk, rows, active=None):
        """K2 over the queries' block rows (table form: the kernel reads
        the rows, they are never gathered)."""
        return knn_rows.topk_from_table(self.m.ptable, *rows, glob, E=mp.E, B=self.m.bucket,
                                        k=kk, active=active)

    def _dyn_gate(self, good, n_abcd, glob):
        """Robust residual gate: reject matches beyond gate·(two-pass robust
        mean |residual|), floored at 5 cm."""
        if self.dynamic_gate <= 0:
            return good
        ad = torch.abs(plane_op.point_to_plane(n_abcd, glob))
        gf = good.to(ad.dtype)
        m1 = torch.sum(ad * gf) / torch.clamp(torch.sum(gf), min=1.0)
        w2 = gf * (ad <= 3.0 * m1 + 0.05).to(ad.dtype)
        m2v = torch.sum(ad * w2) / torch.clamp(torch.sum(w2), min=1.0)
        return good & (ad <= torch.clamp(self.dynamic_gate * m2v, min=0.05))

    def _finish(self, n_abcd, good, glob):
        good = self._dyn_gate(good & self.pc_valid, n_abcd, glob)
        cum = torch.cumsum(good.to(torch.int32), dim=0)
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
        patch, full = knn_rows.topk_from_table_select(
            self.m.ptable, *self._rows(glob), glob, idx, viol, E=mp.E, B=self.m.bucket,
            k=self.k, active=active)
        n_abcd, good = plane_kernel.fit_planes_select(
            ranked, patch, idx, stale, full, viol, num_match_points=self.k,
            max_dist_plane=self.max_dist_plane, plane_threshold=self.plane_threshold,
            active=active)
        self._viol = viol
        return (*self._finish(n_abcd, good, glob), viol)

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
        return hstats_op.hstats(X, hstats_op.pack_scalars(x),
                                estimate_extrinsics=self.estimate_extrinsics, active=active)

    def debug(self, x: st.NavState):
        """Match telemetry at the iterate x (the JAX ``h_debug``): the
        re-matched planes ``n_abcd (Q,4)``, the final gate mask ``keep
        (Q,)``, the signed point-to-plane distances ``(Q,)`` and the number
        of queries whose window certificates fail there ``() int32``."""
        glob = so3.quat_rotate(x.rot, self.pc) + x.pos
        n_abcd, keep, viol = self._rematch_counted(glob)
        return n_abcd, keep, plane_op.point_to_plane(n_abcd, glob), viol


def make_h_model(m: mp.VoxelHashMap, pc, pc_valid, **kw) -> HModel:
    """The measurement model (see HModel and the module docstring)."""
    return HModel(m, pc, pc_valid, **kw)
