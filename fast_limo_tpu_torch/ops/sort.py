"""K9 — lexicographic sort of int32 triples (port of fast_limo_tpu/ops/sort.py).

``sort3(k1, k2, v)`` sorts three int32 (N,) tensors ascending by the key
``(k1, k2, v)``.  With a unique ``v`` (the callers pass an arange) the
order is total, so the result is the stable 2-key sort by ``(k1, k2)``
with ties in original order.  ``sort_key_val(key, val)`` is
``sort3(key, val, val)`` with the middle output dropped.

On CUDA tensors both launch ``csrc/sort3.cu`` (a bitonic network padded to
the next power of two with INT32_MAX); on CPU tensors they run
``sort3_plain``, an exact lexicographic sort for any ``v``.  The kernel
takes contiguous int32 tensors of 1 to ``MAXN`` elements and raises on
anything else.  The two callers, ``ops/voxel.voxel_downsample`` and
``models/mapper.insert``, run on every scan.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

MAXN = 1 << 24      # FL_SORT_MAXN of csrc/sort3.cu


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
    Np = 1 << (N - 1).bit_length()
    w = torch.empty((3, Np), dtype=torch.int32, device=k1.device)
    err = dispatch.library().fl_sort3(
        dispatch.ptr(k1), dispatch.ptr(k2), dispatch.ptr(v), N, Np, dispatch.ptr(w[0]),
        dispatch.ptr(w[1]), dispatch.ptr(w[2]), dispatch.stream())
    dispatch.check(err, "sort3")
    sort3.launches += 1
    return w[0, :N], w[1, :N], w[2, :N]


def sort3(k1, k2, v):
    """(k1, k2, v) int32 (N,) → the three sorted ascending by (k1, k2, v)."""
    if not dispatch.on_cuda(k1):
        return sort3_plain(k1, k2, v)
    return _launch(k1, k2, v)


sort3.launches = 0


def sort_key_val(key, val):
    """Sort ``val`` by ``key`` (ties by ``val``) → (key_sorted, val_sorted);
    one launch of the same kernel, counted in ``sort3.launches``."""
    k, _, v = sort3(key, val, val)
    return k, v
