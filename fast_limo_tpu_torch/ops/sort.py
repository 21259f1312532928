"""K9 — lexicographic sort of int32 triples (port of fast_limo_tpu/ops/sort.py).

``sort3(k1, k2, v)`` sorts three int32 (N,) tensors ascending by the key
``(k1, k2, v)``.  With a unique ``v`` (the callers pass an arange) the
order is total, so the result is the stable 2-key sort by ``(k1, k2)``
with ties in original order.  ``sort_key_val(key, val)`` is
``sort3(key, val, val)`` with the middle output dropped.

On CUDA tensors both launch ``csrc/sort3.cu``, one kernel a call chosen by
N: up to ``CLUSTER_MAXN`` = 2^17 elements one 16-block thread-block
cluster (a stable LSD radix sort over 8-bit digits with the triples in the
blocks' shared memory, passes that cannot move anything skipped on the
device), above it one cooperative launch of one block a streaming
multiprocessor (``fl_sort3_grid_kernel``: the same radix sort, digits and
skip rule, the triples in device memory, grid barriers between the
phases of a pass).  On CPU tensors they run ``sort3_plain``, an exact
lexicographic sort for any ``v``.  The kernels take contiguous int32
tensors of 1 to 2^31 - 1 elements and raise on anything else; a grid
whose blocks cannot all be resident raises too.  There is no fallback.
The grid route's scratch (one more ``(3, N)`` buffer and a ``G × 264``
table of counts) comes from the torch allocator.  ``sort3.launches``
counts every launch, ``sort3.grid_launches`` those of the grid route.
The callers, ``ops/voxel.voxel_downsample`` and ``models/mapper.insert``,
run on every scan at the scan's width (262 144 points for a 128-beam
lidar, ``utils/presets.ouster128_cfg``); the SLAM engine's map rebuild
inserts ``rebuild_batch × rebuild_points`` points a call.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

CLUSTER_MAXN = 1 << 17   # FL_SORT_MAXN of csrc/sort3.cu: above it, the grid kernel
MAXN = 2 ** 31 - 1       # an int32 index, the JAX package's own limit
TABLE = 256 + 8          # ints of the grid kernel's table a block

_grid_blocks = None


def grid_blocks() -> int:
    """The grid kernel's block count (one a streaming multiprocessor),
    asked of the library once; raises if its blocks cannot all be resident."""
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


def _launch(k1, k2, v):
    N = k1.shape[0]
    for name, t in (("k1", k1), ("k2", k2), ("v", v)):
        dispatch.require(t, name, dtype=torch.int32, shape=(N,))
    if not 1 <= N <= MAXN:
        raise ValueError(f"the sort3 kernel takes 1 to {MAXN} elements, got {N}")
    out = torch.empty((3, N), dtype=torch.int32, device=k1.device)
    grid = N > CLUSTER_MAXN
    G, scratch = 0, (None,) * 4
    if grid:   # freed after the launch: the allocator reuses it in stream order
        G = grid_blocks()
        buf = torch.empty((3, N), dtype=torch.int32, device=k1.device)
        table = torch.empty(G * TABLE, dtype=torch.int32, device=k1.device)
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
