"""K9's grid kernel (csrc/sort3.cu, ``fl_sort3_grid_kernel``: the sorts
above 2^17 elements) on the CPU.

A NumPy emulation of the kernel's exact schedule — the array cut into G
contiguous tiles of ceil(N / G); the skip rule's AND / OR and out-of-order
flags taken per tile (each tile's first element against the previous
tile's last) and reduced over the grid; a pass's per-tile digit counts, the
grid's digit totals and the lower tiles' counts in tile order; the tile
ranked and scattered a chunk of 4096 at a time (16 warps of 256 elements,
each ranking its segment stably, rounds of 32 lanes in order; the warps'
counts scanned in warp order), with a running offset per digit from chunk
to chunk; the
ping-pong between the output and the scratch chosen so that the last pass
lands in the output — is bit-equal to ``sort3_plain`` and to the JAX
package's ``lax.sort`` on adversarial inputs at N = 2^17 + 1, 2^18 + 3 and
2^19 + 5, with G = 132 (one block a streaming multiprocessor of the H100),
7 and 1.  Every destination is written exactly once.  The emulation reads
its block size, rounds and chunk from the kernel's source, so the two
cannot drift apart unnoticed.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.ops import sort as jsort
from fast_limo_tpu_torch.ops import sort

_SRC = os.path.join(os.path.dirname(sort.__file__), os.pardir, "csrc", "sort3.cu")


def _define(name):
    with open(_SRC) as f:
        m = re.search(rf"#define {name} \(?(\d+)", f.read())
    return int(m.group(1))


THREADS = _define("FL_SORTG_THREADS")
ROUNDS = _define("FL_SORTG_ROUNDS")
WARPS = THREADS // 32
SEG = 32 * ROUNDS                 # a warp's segment of a chunk
CHUNK = THREADS * ROUNDS          # elements a block ranks at once
I32 = np.iinfo(np.int32)


def _digit(x, shift):
    return (((x.view(np.uint32) ^ np.uint32(0x80000000)) >> np.uint32(shift)) & 0xFF).astype(np.int32)


def _skip(all_, p):
    """fl_sort_skip: pass p over a constant digit, or over operands the
    input already has in order."""
    op, shift = 2 - p // 4, 8 * (p % 4)
    constant = ((int(all_[op]) ^ int(all_[3 + op])) >> shift) & 0xFF == 0
    in_order = (op == 2 and all_[6] == 0) or (op >= 1 and all_[7] == 0)
    return constant or in_order


def _excl(a, axis=0):
    return np.cumsum(a, axis=axis, dtype=np.int32) - a


def _grouped_excl(a, starts, group):
    """Exclusive cumulative sums of the rows of ``a`` within consecutive
    groups (``starts``: each group's first row; ``group``: a row's group)."""
    e = _excl(a)
    return e - e[starts][group]


def _layout(N, G):
    """The kernel's cut of N elements over G blocks: each element's block,
    its warp segment (a chunk's warp's 256 elements) and its place there;
    each segment's chunk, each chunk's block."""
    per = -(-N // G)
    lo = np.minimum(np.arange(G) * per, N)
    hi = np.minimum(lo + per, N)
    block = np.repeat(np.arange(G), hi - lo)
    i = np.arange(N) - lo[block]                     # index in the tile
    nch = -(-per // CHUNK)
    chunk = block * nch + i // CHUNK                 # the grid's chunk number
    sk = chunk * WARPS + (i % CHUNK) // SEG          # the grid's segment number (ascending)
    first = np.r_[True, sk[1:] != sk[:-1]]
    seg = np.cumsum(first) - 1
    seg_chunk = chunk[first]
    cfirst = np.r_[True, seg_chunk[1:] != seg_chunk[:-1]]
    seg_group = np.cumsum(cfirst) - 1                # a segment's chunk, numbered densely
    chunk_block = seg_chunk[cfirst] // nch
    bfirst = np.r_[True, chunk_block[1:] != chunk_block[:-1]]
    seg = seg.astype(np.int32)
    return dict(lo=lo, hi=hi, block=block, seg=seg, pidx=seg * SEG + i % SEG,
                nseg=int(seg[-1]) + 1, seg_starts=np.flatnonzero(cfirst), seg_group=seg_group,
                elem_chunk=seg_group[seg].astype(np.int32), chunk_starts=np.flatnonzero(bfirst),
                chunk_block=chunk_block, chunk_bgroup=np.cumsum(bfirst) - 1)


def _skip_words(k1, k2, v, L):
    """The grid's AND ×3, OR ×3 and out-of-order flags ×2: each tile's
    words (its first element against the previous tile's last), then AND /
    OR over the tiles."""
    u = [a.view(np.uint32) for a in (k1, k2, v)]
    live = L["hi"] > L["lo"]
    lo = L["lo"][live]
    words = [np.bitwise_and.reduceat(x, lo) for x in u] + \
            [np.bitwise_or.reduceat(x, lo) for x in u]
    bad_v = np.r_[False, v[:-1] > v[1:]]             # element g against g - 1
    bad_kv = np.r_[False, (k2[:-1] > k2[1:]) | ((k2[:-1] == k2[1:]) & (v[:-1] > v[1:]))]
    words += [np.logical_or.reduceat(bad_v, lo), np.logical_or.reduceat(bad_kv, lo)]
    return ([int(np.bitwise_and.reduce(w)) for w in words[:3]]
            + [int(np.bitwise_or.reduce(w.astype(np.uint32))) for w in words[3:]])


def grid_sort3(k1, k2, v, G, L=None):
    """The grid kernel's schedule with G blocks → (o1, o2, o3, passes)."""
    N = k1.shape[0]
    L = L or _layout(N, G)
    all_ = _skip_words(k1, k2, v, L)
    taken_passes = [p for p in range(12) if not _skip(all_, p)]
    P = len(taken_passes)
    if P == 0:
        return k1.copy(), k2.copy(), v.copy(), 0
    seg, nseg, pidx = L["seg"], L["nseg"], L["pidx"]
    rows = 257 * np.arange(nseg, dtype=np.int32)[:, None]
    src = [k1, k2, v]
    out = [np.empty(N, np.int32) for _ in range(3)]
    tmp = [np.empty(N, np.int32) for _ in range(3)]
    for taken, p in enumerate(taken_passes):
        op, shift = 2 - p // 4, 8 * (p % 4)
        dst = tmp if (P - 1 - taken) & 1 else out
        d = _digit(src[op], shift)
        # a warp's stable rank of each element among its segment's of its
        # digit (the rounds of 32 in order, the lower lanes first)
        sd = seg * 256 + d
        wc = np.bincount(sd, minlength=nseg * 256).astype(np.int32).reshape(nseg, 256)
        dp = np.full(nseg * SEG, 256, np.uint16)
        dp[pidx] = d
        dp = dp.reshape(nseg, SEG)
        order = np.argsort(dp, axis=1, kind="stable")
        smaller = np.c_[_excl(wc, 1), np.zeros(nseg, np.int32)].reshape(-1)
        ranked = np.arange(SEG, dtype=np.int32)[None, :] - smaller[rows + np.take_along_axis(dp, order, 1)]
        rank = np.empty_like(ranked)
        np.put_along_axis(rank, order, ranked, 1)
        rank = rank.reshape(-1)[pidx]
        # the warps' offsets in their chunk, the chunks' in their tile, the
        # tiles' first destination of each digit (all tiles' counts, summed
        # in tile order)
        wo = _grouped_excl(wc, L["seg_starts"], L["seg_group"])
        cc = np.add.reduceat(wc, L["seg_starts"], axis=0)
        co = _grouped_excl(cc, L["chunk_starts"], L["chunk_bgroup"])
        cnt = np.zeros((G, 256), np.int32)
        cnt[L["chunk_block"][L["chunk_starts"]]] = np.add.reduceat(cc, L["chunk_starts"], axis=0)
        run = _excl(cnt.sum(0))[None, :] + _excl(cnt)
        cr = co + run[L["chunk_block"]]
        pos = cr.reshape(-1)[L["elem_chunk"] * 256 + d] + wo.reshape(-1)[sd] + rank
        assert np.array_equal(np.bincount(pos, minlength=N), np.ones(N, np.int64)), \
            "a destination written twice"
        for j in range(3):
            dst[j][pos] = src[j]
        src = dst
    return out[0], out[1], out[2], P


@functools.lru_cache(maxsize=1)
def _cases(N):
    """(name, k1, k2, v, plain sort) — the adversarial inputs, each with
    ``sort3_plain``'s three outputs (kept for the next G)."""
    return [(name, *ops, [t.numpy() for t in sort.sort3_plain(*map(torch.from_numpy, ops))])
            for name, *ops in _inputs(N)]


def _inputs(N):
    rng = np.random.default_rng(N)

    def full():
        return rng.integers(I32.min, I32.max, N, endpoint=True).astype(np.int32)

    ar = np.arange(N, dtype=np.int32)
    perm = rng.permutation(N).astype(np.int32)
    ext = full()
    ext[rng.random(N) < 0.3] = I32.max
    ext[rng.random(N) < 0.3] = I32.min
    four = np.array([-7, 0, 3, 1 << 30], np.int32)
    voxel = full() & 0x3FFFFFFF
    voxel[rng.random(N) < 0.2] = I32.max
    group = rng.integers(0, 8192, N).astype(np.int32)
    group[rng.random(N) < 0.2] = I32.max
    return [
        ("full range", full(), full(), full()),
        ("INT32_MIN / INT32_MAX", ext, rng.choice([I32.min, I32.max], N).astype(np.int32), perm),
        ("four values", four[rng.integers(0, 4, N)], four[rng.integers(0, 4, N)], perm),
        ("all equal", np.full(N, -5, np.int32), np.full(N, -5, np.int32),
         np.full(N, -5, np.int32)),
        ("k1's top digit", ((rng.integers(0, 256, N) << 24) | 0x00123456).astype(np.int32),
         np.full(N, 9, np.int32), ar),
        ("repeated v", four[rng.integers(0, 4, N)], rng.integers(-3, 3, N).astype(np.int32),
         rng.integers(-2, 2, N).astype(np.int32)),
        ("voxel sort (key, arange, arange)", voxel, ar, ar),
        ("insert sort (group, packed voxel, arange)", group, full() & 0x3FFFFFFF, ar),
    ]


@pytest.mark.parametrize("G", [132, 7, 1])
@pytest.mark.parametrize("N", [(1 << 17) + 1, (1 << 18) + 3, (1 << 19) + 5])
def test_grid_schedule_equals_the_plain_sort(N, G):
    passes, L = {}, _layout(N, G)
    for name, k1, k2, v, want in _cases(N):
        *got, passes[name] = grid_sort3(k1, k2, v, G, L)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the skip rule's reach: no pass, one pass, the callers' forms, all twelve
    assert passes["all equal"] == 0 and passes["k1's top digit"] == 1
    assert passes["voxel sort (key, arange, arange)"] == 4 and passes["full range"] == 12


def test_grid_schedule_equals_lax_sort():
    """The emulation against the JAX package's sort (the XLA sort its
    callers run by default) on the insert's and the voxel sort's forms."""
    for name, k1, k2, v in _inputs((1 << 17) + 1)[6:]:
        got = grid_sort3(k1, k2, v, 132)[:3]
        want = jsort.sort3(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
