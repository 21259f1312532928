"""K9 — lexicographic sort of int32 triples (port of fast_limo_tpu/ops/sort.py).

``sort3(k1, k2, v)`` sorts three int32 (N,) tensors ascending by the key
``(k1, k2, v)``.  With a unique ``v`` (the callers pass an arange) the
order is total, so the result is the stable 2-key sort by ``(k1, k2)``
with ties in original order.  ``sort_key_val(key, val)`` is
``sort3(key, val, val)`` with the middle output dropped.

On CUDA tensors both launch ``csrc/sort3.cu`` (one launch of one 16-block
thread-block cluster: a stable LSD radix sort over 8-bit digits with the
triples in the blocks' shared memory, passes that cannot move anything
skipped on the device); on CPU tensors they run ``sort3_plain``, an exact
lexicographic sort for any ``v``.  The kernel takes contiguous int32
tensors of 1 to ``MAXN`` elements and raises on anything else: ``MAXN`` =
2^17 is what 16 blocks hold double-buffered in their shared memory (8192
triples of 12 bytes, twice, in each block's 227 KB), enough for the voxel
sort of an HDL-64 scan (~125 000 points); there is no fallback beyond it.
The callers, ``ops/voxel.voxel_downsample`` and ``models/mapper.insert``,
run on every scan; the SLAM engine's map rebuild inserts 65 536 points a
call.
"""

from __future__ import annotations

import torch

from fast_limo_tpu_torch.ops import dispatch

MAXN = 1 << 17      # FL_SORT_MAXN of csrc/sort3.cu


def require_fits(n: int, what: str) -> None:
    """Raise unless the kernel takes a sort of ``n`` elements.  The step and
    the SLAM engine call this when they are built on the card, so a
    configuration whose sorts exceed ``MAXN`` (a 128-beam scan of 262 144
    points, say) fails there and not at its first scan."""
    if n > MAXN:
        raise ValueError(f"{what} = {n}: the sort3 kernel sorts at most {MAXN} elements "
                         f"on the card (ops/sort.py MAXN)")


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
    err = dispatch.library().fl_sort3(
        dispatch.ptr(k1), dispatch.ptr(k2), dispatch.ptr(v), N, dispatch.ptr(out[0]),
        dispatch.ptr(out[1]), dispatch.ptr(out[2]), dispatch.stream())
    dispatch.check(err, "sort3")
    sort3.launches += 1
    return out[0], out[1], out[2]


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
