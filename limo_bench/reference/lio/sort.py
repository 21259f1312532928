"""K9's plain version (the port's ``ops/sort``): the stable lexicographic sort of
int32 triples, in PyTorch."""

from __future__ import annotations

import torch


CLUSTER_CAP = 1 << 17    # FL_SORT_MAXN of csrc/sort3.cu: the most the cluster kernel holds
CLUSTER_MAXN = 4096      # the switch: above it, the grid kernel (see the module docstring)
MAXN = 2 ** 31 - 1       # an int32 index, the JAX package's own limit

_grid_blocks = None


def sort3_plain(k1, k2, v):
    """Exact lexicographic sort by (k1, k2, v): stable sorts by v, then k2,
    then k1."""
    order = torch.sort(v, stable=True)[1]
    order = order[torch.sort(k2[order], stable=True)[1]]
    order = order[torch.sort(k1[order], stable=True)[1]]
    return k1[order], k2[order], v[order]


def sort3(k1, k2, v):
    """(k1, k2, v) int32 (N,) → the three sorted ascending by (k1, k2, v)."""
    return sort3_plain(k1, k2, v)




def sort_key_val(key, val):
    """Sort ``val`` by ``key`` (ties by ``val``) → (key_sorted, val_sorted);
    one launch of the same kernels, counted in ``sort3.launches``."""
    k, _, v = sort3(key, val, val)
    return k, v
