"""K9 — lexicographic sort of int32 triples (port of fast_limo_tpu/ops/sort.py).

``sort3(k1, k2, v)`` sorts three int32 (N,) tensors ascending by the key
``(k1, k2, v)``.  With a unique ``v`` (the callers pass an arange) the
order is total, so the result is the stable 2-key sort by ``(k1, k2)``
with ties in original order.  ``sort_key_val(key, val)`` is
``sort3(key, val, val)`` with the middle output dropped.

On CUDA tensors both launch ``csrc/sort3.cu``'s one kernel, one launch a
call for every N: one cooperative grid of one 512-thread block an SM
(``fl_sort3_grid_kernel``: a stable LSD radix sort over 8-bit digits in the
Onesweep style — all twelve digits' counts from one read of the input,
passes that cannot move anything skipped on the device, tiles of 2048
ranked and reordered in shared memory, each tile's offsets from a decoupled
look-back over the lower tiles' counts, digit runs written contiguously,
one grid barrier a pass; below one tile a single block sorts the whole
input).  On CPU tensors they run ``sort3_plain``, an exact lexicographic
sort for any ``v``.  The kernel takes contiguous int32 tensors of 1 to
2^31 - 1 elements and raises on anything else; a grid whose blocks cannot
all be resident raises too.  There is no fallback.  Its scratch comes from
the torch allocator: one more ``(3, N)`` buffer and a table of
``fl_sort3_grid_table(N)`` ints (the digit totals, the skip words and a
64-bit look-back status word a tile and digit), sized by what the library
reports.  ``sort3.launches`` counts every launch.
The callers, ``ops/voxel.voxel_downsample`` and ``models/mapper.insert``,
run on every scan at the scan's width (262 144 points for a 128-beam
lidar, ``utils/presets.ouster128_cfg``); the SLAM engine's map rebuild
inserts ``rebuild_batch × rebuild_points`` points a call.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

MAXN = 2 ** 31 - 1       # an int32 index, the JAX package's own limit


def sort3_plain(k1, k2, v):
    """Exact lexicographic sort by (k1, k2, v): stable sorts by v, then k2,
    then k1."""
    order = torch.sort(v, stable=True)[1]
    order = order[torch.sort(k2[order], stable=True)[1]]
    order = order[torch.sort(k1[order], stable=True)[1]]
    return k1[order], k2[order], v[order]


def _launch(k1, k2, v):
    """One launch of the kernel."""
    N = k1.shape[0]
    for name, t in (("k1", k1), ("k2", k2), ("v", v)):
        dispatch.require(t, name, dtype=torch.int32, shape=(N,))
    if not 1 <= N <= MAXN:
        raise ValueError(f"the sort3 kernel takes 1 to {MAXN} elements, got {N}")
    lib = dispatch.library()
    out = torch.empty((3, N), dtype=torch.int32, device=k1.device)
    # freed after the launch: the allocator reuses them in stream order
    buf = torch.empty((3, N), dtype=torch.int32, device=k1.device)
    table = torch.empty(lib.fl_sort3_grid_table(N), dtype=torch.int32, device=k1.device)
    err = lib.fl_sort3(*map(dispatch.ptr, (k1, k2, v)), N, *map(dispatch.ptr, out),
                       *map(dispatch.ptr, buf), dispatch.ptr(table), dispatch.stream())
    dispatch.check(err, "sort3")
    sort3.launches += 1
    return out[0], out[1], out[2]


def sort3(k1, k2, v):
    """(k1, k2, v) int32 (N,) → the three sorted ascending by (k1, k2, v)."""
    if not dispatch.on_cuda(k1):
        return sort3_plain(k1, k2, v)
    return _launch(k1, k2, v)


dispatch.counted(sort3)


def sort_key_val(key, val):
    """Sort ``val`` by ``key`` (ties by ``val``) → (key_sorted, val_sorted);
    one launch of the same kernel, counted in ``sort3.launches``."""
    k, _, v = sort3(key, val, val)
    return k, v
