"""K9 — lexicographic sort of int32 triples (port of fast_limo_tpu/ops/sort.py).

``sort3(k1, k2, v)`` sorts three int32 (N,) tensors ascending by the key
``(k1, k2, v)``.  With a unique ``v`` (the callers pass an arange) the
order is total, so the result is the stable 2-key sort by ``(k1, k2)``
with ties in original order.  ``sort_key_val(key, val)`` is
``sort3(key, val, val)`` with the middle output dropped.

On CUDA tensors both launch ``csrc/sort3.cu``, one kernel a call, the
route chosen here by N: up to ``CLUSTER_MAXN`` = 4096 elements one
16-block thread-block cluster (a stable LSD radix sort over 8-bit digits
with the triples in the blocks' shared memory, passes that cannot move
anything skipped on the device; it holds at most ``CLUSTER_CAP`` = 2^17),
above it one cooperative launch of one 512-thread block an SM
(``fl_sort3_grid_kernel``: the same radix sort, digits and skip rule in
the Onesweep style — all twelve digits' counts from one read of the input,
tiles of 2048 ranked and reordered in shared memory, each tile's offsets
from a decoupled look-back over the lower tiles' counts, digit runs written
contiguously, one grid barrier a pass).  The switch is the largest N
measured at which the cluster kernel wins both of the callers' forms on an
H100 (PERF.md §6).  It is a single point: the grid kernel wins both forms
at 1024, where one tile holds the whole input, and from 10 000 up, so both
sorts of every scan take it; at 4096 the insert form's margin is a few per
cent either way from run to run.  On CPU tensors they run
``sort3_plain``, an exact lexicographic sort for any ``v``.  The kernels take contiguous int32
tensors of 1 to 2^31 - 1 elements and raise on anything else; a grid
whose blocks cannot all be resident raises too.  There is no fallback.
The grid route's scratch comes from the torch allocator: one more
``(3, N)`` buffer and a table of ``fl_sort3_grid_table(N)`` ints (the
digit totals, the skip words and a 64-bit look-back status word a tile
and digit), both sized by what the library reports.  ``sort3.launches``
counts every launch, ``sort3.grid_launches`` those of the grid route.
The callers, ``ops/voxel.voxel_downsample`` and ``models/mapper.insert``,
run on every scan at the scan's width (262 144 points for a 128-beam
lidar, ``utils/presets.ouster128_cfg``); the SLAM engine's map rebuild
inserts ``rebuild_batch × rebuild_points`` points a call.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

CLUSTER_CAP = 1 << 17    # FL_SORT_MAXN of csrc/sort3.cu: the most the cluster kernel holds
CLUSTER_MAXN = 4096      # the switch: above it, the grid kernel (see the module docstring)
MAXN = 2 ** 31 - 1       # an int32 index, the JAX package's own limit

_grid_blocks = None


def grid_blocks() -> int:
    """The grid kernel's resident block count (one a streaming
    multiprocessor), asked of the library once; raises if its blocks cannot
    all be resident.  A launch takes at most one block a tile of 2048."""
    global _grid_blocks
    if _grid_blocks is None:
        g = dispatch.library().fl_sort3_grid_blocks()
        dispatch.check(-g if g < 0 else 0, "sort3 (grid)")
        _grid_blocks = g
    return _grid_blocks


def sort3_plain(k1, k2, v):
    """Exact lexicographic sort by (k1, k2, v): stable sorts by v, then k2,
    then k1."""
    order = torch.sort(v, stable=True)[1]
    order = order[torch.sort(k2[order], stable=True)[1]]
    order = order[torch.sort(k1[order], stable=True)[1]]
    return k1[order], k2[order], v[order]


def _launch(k1, k2, v, grid=None):
    """One launch of the route N picks, or of the one ``grid`` names (a
    measurement of both routes at one size)."""
    N = k1.shape[0]
    for name, t in (("k1", k1), ("k2", k2), ("v", v)):
        dispatch.require(t, name, dtype=torch.int32, shape=(N,))
    if not 1 <= N <= MAXN:
        raise ValueError(f"the sort3 kernel takes 1 to {MAXN} elements, got {N}")
    grid = N > CLUSTER_MAXN if grid is None else grid
    if not grid and N > CLUSTER_CAP:
        raise ValueError(f"the sort3 cluster kernel takes at most {CLUSTER_CAP} elements, got {N}")
    out = torch.empty((3, N), dtype=torch.int32, device=k1.device)
    G, scratch = 0, (None,) * 4
    if grid:   # freed after the launch: the allocator reuses it in stream order
        G = grid_blocks()
        buf = torch.empty((3, N), dtype=torch.int32, device=k1.device)
        table = torch.empty(dispatch.library().fl_sort3_grid_table(N), dtype=torch.int32,
                            device=k1.device)
        scratch = (*map(dispatch.ptr, buf), dispatch.ptr(table))
    err = dispatch.library().fl_sort3(
        dispatch.ptr(k1), dispatch.ptr(k2), dispatch.ptr(v), N, dispatch.ptr(out[0]),
        dispatch.ptr(out[1]), dispatch.ptr(out[2]), *scratch, G, dispatch.stream())
    dispatch.check(err, "sort3 (grid)" if grid else "sort3")
    sort3.launches += 1
    sort3.grid_launches += int(grid)
    return out[0], out[1], out[2]


def sort3(k1, k2, v):
    """(k1, k2, v) int32 (N,) → the three sorted ascending by (k1, k2, v)."""
    if not dispatch.on_cuda(k1):
        return sort3_plain(k1, k2, v)
    return _launch(k1, k2, v)


sort3.launches = 0
sort3.grid_launches = 0


def sort_key_val(key, val):
    """Sort ``val`` by ``key`` (ties by ``val``) → (key_sorted, val_sorted);
    one launch of the same kernels, counted in ``sort3.launches``."""
    k, _, v = sort3(key, val, val)
    return k, v
