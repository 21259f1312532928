"""Incremental block-addressed voxel-hash map (port of
fast_limo_tpu/models/mapper.py — see its module docstring for the design).

Same twin layout, so the same arrays mean the same map (``layout_version``):
``table`` (G, ROW_E·EW) entry-major rows ``[vx, vy, vz, count | B × (x,y,z,0)]``
per entry, and ``ptable`` (G, WP) its planar mirror
``[vx×E | vy×E | vz×E | cnt×E | x slot-major E·B | y | z]`` that the kNN
kernel decodes.  The hash key is the 2×2×2-voxel BLOCK coordinate; a kNN
gathers the 8 block rows spanning the query's 27-voxel cube.

The map maintenance (insert, evict) is plain tensor work (gathers, one
scatter) around one K9 sort in ``insert``; after the same inserts and
evictions ``table``/``ptable`` equal the JAX package's bit for bit.  The queries end in kernels: ``knn``
and the narrow ``radius_search`` branches in K2 (``ops/knn_rows``), the
wide ``radius_search`` branch in K7's table entry (``ops/knn``).

A map sharded over D ranks (``num_shards``/``shard_index``/``owned``, as
in the JAX package) hashes a block over the GLOBAL group count ``G·D``:
the global group's high part names the owner rank, its low part the group
in that rank's G-row table (``_shard_split``).  With probing retired,
global group ``owner·G + local`` is the single-card group ``_hash(bc,
G·D)``, so the shards' tables concatenated in rank order are the
single-card table of capacity ``G·D`` after the same inserts, bit for bit.
A shard stores only the blocks it owns (``insert`` ands ``valid`` with
``owned``), and its queries mask the blocks it does not (``owned`` from
``block_rows`` into ``cands_from_rows``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fast_limo_tpu_torch.ops import knn as knn_op
from fast_limo_tpu_torch.ops import knn_rows, sort, voxel

E = 16       # entries per planar subgroup
SUB = 1      # planar subgroups per hash-group row
ROW_E = E * SUB


def _entry_width(bucket: int) -> int:
    return 4 + 4 * bucket


def _row_width(bucket: int) -> int:
    return ROW_E * _entry_width(bucket)


def _sub_width(bucket: int) -> int:
    return 4 * E + 3 * E * bucket


def _planar_width(bucket: int) -> int:
    return SUB * _sub_width(bucket)


# block-offset tables, built once per (radius, device): an upload from a
# host list on every scan would block the host
_OFFSETS = {}


def _block_offsets(mb: int, device, lo: int = None):
    """((2mb+1)³, 3) block offsets in [-mb, mb]³, x-major (mb = 1 is the
    JAX package's ``_BLOCK_OFFSETS27``); with ``lo = 0`` the 8 corners
    {0, 1}³ (mb = 1)."""
    lo = -mb if lo is None else lo
    key = (mb, lo, torch.device(device))
    t = _OFFSETS.get(key)
    if t is None:
        r = range(lo, mb + 1)
        t = torch.tensor([[dx, dy, dz] for dx in r for dy in r for dz in r],
                         dtype=torch.int64, device=device)
        _OFFSETS[key] = t
    return t


def _corners(device):
    return _block_offsets(1, device, lo=0)


class VoxelHashMap(NamedTuple):
    table: torch.Tensor       # (G, W) float32 entry-major rows
    ptable: torch.Tensor      # (G, WP) float32 planar rows
    num_points: torch.Tensor  # () int32
    last_time: torch.Tensor   # () float32

    @property
    def groups(self):
        return self.table.shape[0]

    @property
    def bucket(self):
        return (self.table.shape[1] // ROW_E - 4) // 4

    @property
    def capacity(self):
        """Total entry count (G·ROW_E)."""
        return self.groups * ROW_E

    @property
    def _entries(self):
        """(G·ROW_E, EW) flat entry-block view."""
        return self.table.reshape(self.capacity, _entry_width(self.bucket))

    @property
    def coords(self):
        """(G·ROW_E, 3) int32 voxel coords per entry (garbage where count == 0)."""
        return self._entries[:, :3].to(torch.int32)

    @property
    def counts(self):
        """(G·ROW_E,) int32 stored-point count per entry (0 = free)."""
        return self._entries[:, 3].to(torch.int32)

    @property
    def points(self):
        """(G·ROW_E, B, 3) stored points per entry."""
        return self._entries[:, 4:].reshape(self.capacity, self.bucket, 4)[:, :, :3]

    @property
    def meta(self):
        """(G·ROW_E, 4) int32 [vx, vy, vz, count]."""
        return torch.cat([self.coords, self.counts[:, None]], dim=1)


def layout_version(bucket: int) -> str:
    return f"block2x2x2/E{E}/SUB{SUB}/B{int(bucket)}"


def create(capacity: int, bucket: int, device=None) -> VoxelHashMap:
    if capacity & (capacity - 1) or not ROW_E <= capacity <= ROW_E << 24:
        raise ValueError(f"map capacity {capacity} must be a power of two in "
                         f"[{ROW_E}, {ROW_E << 24}] (group ids stay f32-exact)")
    G = capacity // ROW_E
    return VoxelHashMap(
        table=torch.zeros((G, _row_width(bucket)), dtype=torch.float32, device=device),
        ptable=torch.zeros((G, _planar_width(bucket)), dtype=torch.float32, device=device),
        num_points=torch.zeros((), dtype=torch.int32, device=device),
        last_time=torch.full((), -1.0, dtype=torch.float32, device=device))


def _planar_src(bucket: int, device):
    """Entry-major lane feeding each planar lane (a pure permutation)."""
    B = bucket
    EW = _entry_width(B)
    t = torch.arange(_sub_width(B), device=device)
    plane, e_of_t = t // E, t % E
    meta_src = e_of_t * EW + plane
    pt = t - 4 * E
    c_of_t = pt // (E * B)
    s_of_t = (pt % (E * B)) // E
    pt_src = (pt % E) * EW + 4 + 4 * s_of_t + c_of_t
    return torch.where(t < 4 * E, meta_src, pt_src)


def _planarize(table, bucket: int):
    """Rebuild the planar mirror from the entry-major table (one gather; the
    JAX package does the same permutation as a one-hot matmul)."""
    G = table.shape[0]
    W0 = E * _entry_width(bucket)
    sub = table.reshape(G * SUB, W0)[:, _planar_src(bucket, table.device)]
    return sub.reshape(G, SUB * _sub_width(bucket)).contiguous()


def _hash(coords, groups: int):
    """Spatial hash of integer BLOCK coords → group in [0, groups).  Computed
    in int64; the masked low bits equal the JAX package's int32 wrap-around
    products, on CPU and CUDA alike."""
    c = coords.to(torch.int64)
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349669) ^ (c[..., 2] * 83492791)
    return h & (groups - 1)


def voxel_coords(pts, voxel_size: float):
    return voxel.floor_div(pts, voxel_size).to(torch.int64)


def block_coords(vc):
    return vc >> 1


def _shard_split(h_full, groups: int, num_shards: int, shard_index):
    """Global group ids (over ``groups·num_shards``) → (owned by
    ``shard_index``, the group in the owner's ``groups``-row table)."""
    return h_full // groups == shard_index, h_full % groups


def _groups(bc, groups: int, num_shards: int, shard_index):
    """(owned or None, local group) of block coords on one shard."""
    if num_shards > 1:
        return _shard_split(_hash(bc, groups * num_shards), groups, num_shards, shard_index)
    return None, _hash(bc, groups)


def _seg_sum(flags, reset):
    """Inclusive segmented sum of ``flags`` restarting where ``reset``."""
    f = flags.to(torch.int64)
    pre = torch.cumsum(f, dim=0)
    base = torch.cummax(torch.where(reset, pre - f, torch.full_like(pre, -(2 ** 30))),
                        dim=0).values
    return pre - base


def insert(m: VoxelHashMap, pts, valid, *, voxel_size: float, num_shards: int = 1,
           shard_index=0) -> VoxelHashMap:
    """Insert a masked batch of world-frame points (Mapper::add): one sort,
    one group-row gather, one entry-block scatter (see the JAX docstring).
    With ``num_shards > 1`` ``m`` is shard ``shard_index``'s table and only
    the points of the blocks it owns are inserted."""
    G, B = m.groups, m.bucket
    EW = _entry_width(B)
    N = pts.shape[0]
    dev = pts.device
    pts = pts.to(torch.float32)
    vc0 = voxel_coords(pts, voxel_size)
    owned, g0 = _groups(block_coords(vc0), G, num_shards, shard_index)
    if owned is not None:
        valid = valid & owned

    # group-major sort on (group, packed voxel, index): int32 triples (K9);
    # the index operand makes the order that of the stable 2-key sort
    key_g = torch.where(valid, g0, torch.full_like(g0, 0x7FFFFFFF)).to(torch.int32)
    order = sort.sort3(key_g, voxel.pack_key(vc0).to(torch.int32),
                       torch.arange(N, dtype=torch.int32, device=dev))[2].long()
    vc = vc0[order]
    pts = pts[order]
    valid = valid[order]
    g_raw = g0[order]
    g = torch.where(valid, g_raw, torch.zeros_like(g_raw))
    g_s = torch.where(valid, g_raw, torch.full_like(g_raw, 0x7FFFFFFF))

    # resolve each point's voxel against its group (pre-insert state)
    ent = m.table[g].reshape(N, ROW_E, EW)
    counts_e = ent[..., 3]
    match_e = (counts_e > 0) & torch.all(ent[..., :3] == vc[:, None, :].to(torch.float32), dim=-1)
    has_match = torch.any(match_e, dim=-1)
    entry_m = torch.argmax(match_e.to(torch.uint8), dim=-1)
    base_m = torch.sum(torch.where(match_e, counts_e, torch.zeros_like(counts_e)), dim=-1).to(torch.int64)
    free_e = counts_e == 0

    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same_voxel = torch.cat([false1, torch.all(vc[1:] == vc[:-1], dim=-1) & valid[1:] & valid[:-1]])
    is_leader = valid & ~same_voxel
    new_group = torch.cat([~false1, g_s[1:] != g_s[:-1]])
    r_new = _seg_sum(is_leader & ~has_match, new_group) - 1

    # free-entry election: the new voxel of group-rank r takes the (r+1)-th free entry
    freecum = torch.cumsum(free_e.to(torch.int64), dim=-1)
    want = free_e & (freecum == (r_new + 1)[:, None])
    assigned = torch.any(want, dim=-1)
    entry_n = torch.argmax(want.to(torch.uint8), dim=-1)

    resolved = valid & (has_match | assigned)
    entry = torch.where(has_match, entry_m, entry_n)
    base = torch.where(has_match, torch.clamp(base_m, max=B), torch.zeros_like(base_m))

    # leader-row merge: existing bucket ∪ this run's new points (cap B).
    # Slot s takes the run's point j = s - base while the run lasts (left:
    # the points from n to its run's end), else the bucket of the matched
    # entry (the last match), else zero
    pts4 = torch.cat([pts, torch.zeros((N, 1), dtype=torch.float32, device=dev)], dim=1)
    lane = torch.arange(N, device=dev)
    run_id = torch.cumsum(~same_voxel, dim=0)
    left = torch.searchsorted(run_id, run_id, right=True) - lane
    j_of_s = torch.arange(B, device=dev)[None, :] - base[:, None]
    use_new = (j_of_s >= 0) & (j_of_s < left[:, None])
    e_last = torch.amax(torch.where(match_e, torch.arange(ROW_E, device=dev), 0), dim=-1)
    exist = torch.where(has_match[:, None, None], ent[lane, e_last, 4:].reshape(N, B, 4), 0.0)
    # each 16-byte row as one complex128 element, so the gather runs a thread
    # an element (indexing the float32 rows took ~0.95 ms at N = 262 144 on an
    # H100, this ~0.015 ms)
    rows = pts4.view(torch.complex128)[:, 0]
    new_pts = rows[torch.clamp(lane[:, None] + j_of_s, 0, N - 1)].view(torch.float32)
    merged = torch.where(use_new[..., None], new_pts.reshape(N, B, 4), exist)

    n_placed = torch.sum(use_new, dim=-1)
    final_count = (base + n_placed).to(torch.float32)

    # one entry-block scatter: leaders write, others land in dropped rows
    writer = is_leader & resolved
    erow = torch.where(writer, g * ROW_E + entry, G * ROW_E + lane)
    evals = torch.cat([vc.to(torch.float32), final_count[:, None],
                       merged.reshape(N, 4 * B)], dim=1)
    flat = torch.cat([m.table.reshape(G * ROW_E, EW),
                      torch.zeros((N, EW), dtype=torch.float32, device=dev)])
    flat.index_copy_(0, erow, evals)
    table = flat[:G * ROW_E].reshape(G, ROW_E * EW)

    total = torch.sum(torch.where(writer, n_placed, torch.zeros_like(n_placed)))
    return VoxelHashMap(table, _planarize(table, B),
                        (m.num_points + total).to(torch.int32), m.last_time)


def block_rows(m: VoxelHashMap, queries, *, voxel_size: float, neighborhood: int = 8,
               num_shards: int = 1, shard_index=0):
    """The kNN gather's table rows: ``(row_idx (N,V) int32 rows of
    m.ptable, ncb (N,V,3) int32 block coords, owned (N,V) bool or None)``;
    ``owned`` (with ``num_shards > 1``) marks the blocks shard
    ``shard_index`` owns, whose rows ``row_idx`` names in its table.

    ``neighborhood`` 4, 8 and 27 all take the 8 blocks {b0, b0+1}³,
    b0 = floor((v−1)/2), which span the query's 27-voxel cube (coverage
    radius voxel_size); -27 takes the 27 blocks around the query's own
    block (coverage radius 2·voxel_size, for ``radius_search``)."""
    if neighborhood not in (4, 8, 27, -27):
        raise ValueError(f"neighborhood must be 4, 8, 27 or -27, got {neighborhood}")
    qc = voxel_coords(queries, voxel_size)
    if neighborhood == -27:
        ncb = block_coords(qc)[:, None, :] + _block_offsets(1, queries.device)[None]
    else:
        ncb = ((qc - 1) >> 1)[:, None, :] + _corners(queries.device)[None]
    owned, g = _groups(ncb, m.groups, num_shards, shard_index)
    return g.to(torch.int32), ncb.to(torch.int32), owned


def gather_rows(m: VoxelHashMap, queries, *, voxel_size: float, neighborhood: int = 8,
                num_shards: int = 1, shard_index=0):
    """The kNN gather: ``(rows (N,V,WP) f32, ncb (N,V,3) int32 block
    coords, owned)``, the rows of ``block_rows`` materialised."""
    row_idx, ncb, owned = block_rows(m, queries, voxel_size=voxel_size,
                                     neighborhood=neighborhood, num_shards=num_shards,
                                     shard_index=shard_index)
    return m.ptable[row_idx.long()], ncb, owned


def cands_from_rows(rows, ncb, owned, bucket: int):
    """Block-match + bucket extraction from planar rows →
    (cand_pts (N,V·SUB,B,E,3), cand_valid (N,V·SUB,B,E)); ``owned``
    (N,V) bool, or None, masks the blocks of other shards."""
    N, V, WP = rows.shape
    B = bucket
    sub = rows.reshape(N, V * SUB, _sub_width(B))
    ncf = torch.repeat_interleave(ncb.to(torch.float32), SUB, dim=1)
    vx, vy, vz = sub[..., 0:E], sub[..., E:2 * E], sub[..., 2 * E:3 * E]
    cnt = sub[..., 3 * E:4 * E]
    sel = ((cnt > 0) & (torch.floor(vx * 0.5) == ncf[..., 0:1])
           & (torch.floor(vy * 0.5) == ncf[..., 1:2])
           & (torch.floor(vz * 0.5) == ncf[..., 2:3]))
    if owned is not None:
        sel = sel & torch.repeat_interleave(owned, SUB, dim=1)[..., None]
    EB = E * B
    xs = sub[..., 4 * E:4 * E + EB].reshape(N, V * SUB, B, E)
    ys = sub[..., 4 * E + EB:4 * E + 2 * EB].reshape(N, V * SUB, B, E)
    zs = sub[..., 4 * E + 2 * EB:4 * E + 3 * EB].reshape(N, V * SUB, B, E)
    cand_pts = torch.stack([xs, ys, zs], dim=-1)
    slot = torch.arange(B, dtype=torch.float32, device=rows.device)[None, None, :, None]
    cand_valid = sel[:, :, None, :] & (slot < cnt[:, :, None, :])
    return cand_pts, cand_valid


def gather_neighborhood(m: VoxelHashMap, queries, *, voxel_size: float,
                        neighborhood: int = 8):
    """Gather each query's block neighborhood and decode its buckets →
    (cand_pts (N,V·SUB,B,E,3), cand_valid (N,V·SUB,B,E))."""
    return cands_from_rows(*gather_rows(m, queries, voxel_size=voxel_size,
                                        neighborhood=neighborhood), m.bucket)


def topk_from_candidates(cand_pts, cand_valid, queries, *, k: int):
    """The k smallest squared distances among decoded candidates
    (``cands_from_rows``), ascending: K7's dense entry on the flattened
    (N, V·SUB·B·E) columns, ties to the lowest column as ``lax.top_k``."""
    N = queries.shape[0]
    return knn_op.masked_topk(cand_pts.reshape(N, -1, 3), cand_valid.reshape(N, -1),
                              queries, k=k)


def knn(m: VoxelHashMap, queries, *, voxel_size: float, k: int, neighborhood: int = 8):
    """Bounded kNN over the block neighborhood: K2 on the table rows of
    ``block_rows`` (the rows are not gathered)."""
    row_idx, ncb, _ = block_rows(m, queries, voxel_size=voxel_size, neighborhood=neighborhood)
    return knn_rows.topk_from_table(m.ptable, row_idx, ncb, queries, E=E, B=m.bucket, k=k)


def evict_far(m: VoxelHashMap, center, radius: float, *, voxel_size: float) -> VoxelHashMap:
    """Rolling-origin eviction: free every voxel whose centre lies farther
    than ``radius`` from ``center`` (world frame) by zeroing its count in
    ``table`` and in the count plane of ``ptable`` (a zero count is the free
    state).  Returns a new map; ``m`` is left as it was."""
    G, EW = m.groups, _entry_width(m.bucket)
    ent = m.table.reshape(G * ROW_E, EW)
    counts = ent[:, 3]
    cvox = torch.as_tensor(center, dtype=torch.float32, device=ent.device) / voxel_size
    d = ent[:, :3] + 0.5 - cvox
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    keep = (d2 * (voxel_size * voxel_size)) <= radius * radius
    zero = torch.zeros_like(counts)
    removed = torch.sum(torch.where((counts > 0) & ~keep, counts, zero)).to(torch.int32)
    table = ent.clone()
    table[:, 3] = torch.where(keep, counts, zero)
    WP0 = _sub_width(m.bucket)
    psub = m.ptable.reshape(G * SUB, WP0).clone()
    pcnt = psub[:, 3 * E:4 * E]
    psub[:, 3 * E:4 * E] = torch.where(keep.reshape(G * SUB, E), pcnt, torch.zeros_like(pcnt))
    return m._replace(table=table.reshape(G, ROW_E * EW), ptable=psub.reshape(G, SUB * WP0),
                      num_points=(m.num_points - removed).to(torch.int32))


def radius_search(m: VoxelHashMap, queries, radius: float, *, voxel_size: float,
                  max_results: int = 16):
    """All stored points within ``radius`` of each query, ascending by
    distance, capped at ``max_results`` → (pts (N,R,3), sq (N,R), valid
    (N,R)); invalid lanes carry +inf.

    ``radius ≤ voxel_size`` takes the 8-block gather and ``≤ 2·voxel_size``
    the 27-block one, both through K2; larger radii read the (2mb+1)³
    blocks around the query's block, mb = ceil(radius / (2·voxel_size))
    ≤ 6, through K7's table entry: one launch for all queries, the rows
    read by index and decoded in the kernel (on CPU tensors its plain
    version gathers and decodes them in query chunks)."""
    r2 = radius * radius
    if radius <= 2 * voxel_size + 1e-6:
        nbh = 8 if radius <= voxel_size + 1e-6 else -27
        nbrs, sq, valid = knn(m, queries, voxel_size=voxel_size, k=max_results,
                              neighborhood=nbh)
    else:
        mb = int(math.ceil(radius / (2 * voxel_size) - 1e-9))
        if mb > 6:
            raise ValueError(f"radius {radius} needs a {2 * mb + 1}³-block gather (at most 13³)")
        ncb = (block_coords(voxel_coords(queries, voxel_size))[:, None, :]
               + _block_offsets(mb, queries.device)[None])
        nbrs, sq, valid = knn_op.masked_topk_from_table(
            m.ptable, _hash(ncb, m.groups).to(torch.int32), ncb.to(torch.int32), queries,
            E=E, B=m.bucket, k=max_results)
    inside = valid & (sq <= r2)
    return nbrs, torch.where(inside, sq, torch.full_like(sq, float("inf"))), inside
