"""K9's grid kernel (csrc/sort3.cu, ``fl_sort3_grid_kernel``: the sorts
above the cluster/grid switch) on the CPU.

A NumPy emulation of the kernel's schedule — min(G, tiles) blocks, block b
taking tiles b, b + G, ... of THREADS × ITEMS elements; one read of the
input up front for the skip rule's AND / OR and out-of-order flags and all
twelve digits' counts, each block's summed into the table; per pass, each
warp's stable rank of its contiguous segment (rounds of 32 lanes in
order), the warps' counts scanned in warp order, the tile reordered by digit
in shared memory (every slot written once); the tile's digit counts
published as "aggregate" (tile 0: "inclusive prefix"), then each tile's
look-back over the lower tiles' words, a window of LOOK at a time, through
a status table that carries each word's pass code over from pass to pass
as the kernel's does, the tiles of a wave ready in a seeded random order
(so a walk meets words not ready: the launch's zeros or an earlier pass's,
and long runs of aggregates); the digit-run write (thread i
writes element i of the reordered tile to its digit's base + the lower
tiles' count + its place in the run), every destination written exactly
once; the ping-pong between the output and the scratch that lands the last
pass in the output — is bit-equal to ``sort3_plain`` and to the JAX
package's ``lax.sort`` on adversarial inputs.  The emulation reads its
block size, elements a thread and look-back window from the kernel's
source, so the two cannot drift apart unnoticed.
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
ITEMS = _define("FL_SORTG_ITEMS")
LOOK = _define("FL_SORTG_LOOK")
WARPS = THREADS // 32
SEG = 32 * ITEMS                  # a warp's contiguous segment of a tile
TILE = THREADS * ITEMS
GRID = 132                        # the kernel's resident grid on an H100: one block an SM
I32 = np.iinfo(np.int32)


def _digit(x, shift):
    return (((x.view(np.uint32) ^ np.uint32(0x80000000)) >> np.uint32(shift)) & 0xFF).astype(np.int64)


def _skip(words, p):
    """fl_sort_skip: pass p over a constant digit, or over operands the
    input already has in order."""
    op, shift = 2 - p // 4, 8 * (p % 4)
    constant = ((int(words[op]) ^ int(words[3 + op])) >> shift) & 0xFF == 0
    in_order = (op == 2 and words[6] == 0) or (op >= 1 and words[7] == 0)
    return constant or in_order


def _excl(a, axis=0):
    return np.cumsum(a, axis=axis) - a


def _prologue(ops, G):
    """The up-front read: each block's skip words (its elements against
    their predecessors) and digit counts over its tiles b, b + G, ..., then
    the grid's (AND / OR over the blocks, counts summed)."""
    N = ops[0].shape[0]
    k2, v = ops[1], ops[2]
    bad_v = np.r_[False, v[:-1] > v[1:]]             # element e against e - 1
    bad_kv = np.r_[False, (k2[:-1] > k2[1:]) | ((k2[:-1] == k2[1:]) & (v[:-1] > v[1:]))]
    block = (np.arange(N) // TILE) % G
    order = np.argsort(block, kind="stable")
    cuts = np.flatnonzero(np.r_[True, block[order][1:] != block[order][:-1]])
    u = [a.view(np.uint32)[order] for a in ops]
    words = [int(np.bitwise_and.reduce(np.bitwise_and.reduceat(x, cuts))) for x in u]
    words += [int(np.bitwise_or.reduce(np.bitwise_or.reduceat(x, cuts))) for x in u]
    words += [int(np.logical_or.reduceat(f[order], cuts).any()) for f in (bad_v, bad_kv)]
    totals = np.zeros((12, 256), np.int64)
    for p in range(12):
        per_block = np.bincount(block * 256 + _digit(ops[2 - p // 4], 8 * (p % 4)),
                                minlength=G * 256).reshape(G, 256)
        totals[p] = per_block.sum(axis=0)
    return words, totals


def _look_back(own, G, look, status, taken, rng):
    """Every tile's exclusive prefix over the lower tiles' digit counts, as
    the kernel's look-back reads it from ``status``: per tile a word's pass
    code (uint32: 2·taken + 1 "aggregate", 2·taken + 2 "inclusive prefix";
    anything else — the zero the launch starts from, an earlier pass's code
    — is not ready) and its 256 counts, carried over from pass to pass and
    never cleared.  Per wave (the G tiles that the blocks take together) the
    tiles' counts become ready in a seeded random order of rounds; a tile
    publishes its aggregate (tile 0 its inclusive prefix) in its round and
    starts its walk there.  In each round every walking tile reads a window
    of ``look`` words, nearest first, adds the counts of the ready words up
    to the first inclusive prefix, stops at a word not ready (read again the
    next round) and moves on by the words it used; a tile that has met an
    inclusive prefix publishes its own after the round.  The prefix is the
    sum of the words the walk read, nothing else.  The codes advance alike
    for the 256 digits of a tile, so they are kept once a tile."""
    code, count = status
    ntiles = own.shape[0]
    agg, inc = np.uint32(2 * taken + 1), np.uint32(2 * taken + 2)
    prefix = np.zeros((ntiles, 256), np.int64)
    for w0 in range(0, ntiles, G):
        wave = np.arange(w0, min(w0 + G, ntiles))
        ready = rng.integers(0, 4, len(wave))       # the round a tile's counts are in
        done = np.zeros(len(wave), bool)
        j = wave - 1                                # the next word a walk reads
        for rnd in range(10 * ntiles + 8):
            new = ready == rnd
            code[wave[new]] = np.where(wave[new] == 0, inc, agg)
            count[wave[new]] = own[wave[new]]
            done |= new & (wave == 0)
            live = (ready <= rnd) & ~done
            if not live.any():
                if done.all():
                    break
                continue
            used = np.zeros(len(wave), np.int64)
            met = np.zeros(len(wave), bool)
            for k in range(look):
                at = j - k
                f = np.where(at >= 0, code[np.maximum(at, 0)], 0).astype(np.uint32) \
                    - np.uint32(2 * taken)
                live &= (f == 1) | (f == 2)         # a word not ready ends the window
                prefix[wave[live]] += count[at[live]]
                used = np.where(live, k + 1, used)
                met |= live & (f == 2)
                live &= f != 2
                if not live.any():
                    break
            j -= used
            t = wave[met]                           # after the round: the inclusive prefixes
            code[t] = inc
            count[t] = prefix[t] + own[t]
            done |= met
        assert done.all(), "a look-back made no progress"
    return prefix


def grid_sort3(k1, k2, v, G):
    """The grid kernel's schedule with G resident blocks → (o1, o2, o3, passes)."""
    N = k1.shape[0]
    ntiles = -(-N // TILE)
    G = min(G, ntiles)
    words, totals = _prologue((k1, k2, v), G)
    for p in range(12):
        direct = np.bincount(_digit((k1, k2, v)[2 - p // 4], 8 * (p % 4)), minlength=256)
        assert np.array_equal(totals[p], direct), "the blocks' counts do not sum to the input's"
    taken_passes = [p for p in range(12) if not _skip(words, p)]
    status = (np.zeros(ntiles, np.uint32), np.zeros((ntiles, 256), np.int64))   # zeroed at launch
    rng = np.random.default_rng(N * 1009 + G)
    P = len(taken_passes)
    if P == 0:
        return k1.copy(), k2.copy(), v.copy(), 0
    e = np.arange(N)
    tile, seg = e // TILE, e // SEG                   # an element's tile and warp segment
    src = [k1, k2, v]
    out = [np.empty(N, np.int32) for _ in range(3)]
    tmp = [np.empty(N, np.int32) for _ in range(3)]
    for taken, p in enumerate(taken_passes):
        op, shift = 2 - p // 4, 8 * (p % 4)
        dst = tmp if (P - 1 - taken) & 1 else out
        d = _digit(src[op], shift)
        # a warp's stable rank of each element among its segment's of its
        # digit: the rounds of 32 in order, the lower lanes first
        key = seg * 256 + d
        order = np.argsort(key, kind="stable")
        first = np.r_[True, key[order][1:] != key[order][:-1]]
        rank = np.empty(N, np.int64)
        rank[order] = e - np.maximum.accumulate(np.where(first, e, 0))
        # the warps' counts, the lower warps' in the tile, the tile's counts
        wc = np.bincount(key, minlength=ntiles * WARPS * 256).reshape(ntiles, WARPS, 256)
        lower_warps = (np.cumsum(wc, axis=1) - wc).reshape(-1)
        own = wc.sum(axis=1)
        start = _excl(own, axis=1)                    # each digit's run in the reordered tile
        td = tile * 256 + d
        at = start.reshape(-1)[td] + lower_warps[key] + rank
        slot = tile * TILE + at
        assert (np.bincount(slot, minlength=N) == 1).all(), \
            "the shared-memory reorder wrote a slot twice"
        prefix = _look_back(own, G, LOOK, status, taken, rng)
        assert np.array_equal(prefix, _excl(own, axis=0)), "the look-back missed a tile"
        # thread i writes element i of the reordered tile to its digit's
        # run: base + the lower tiles' count + its place in the run
        to = (_excl(totals[p])[None, :] + prefix - start).reshape(-1)
        reordered = np.empty(N, np.int64)
        reordered[slot] = e
        pos = to[td[reordered]] + (e - tile * TILE)
        assert np.array_equal(np.bincount(pos, minlength=N), np.ones(N, np.int64)), \
            "a destination written twice"
        for j in range(3):
            dst[j][pos] = src[j][reordered]
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


@pytest.mark.parametrize("N, G", [
    (N, G) for N in ((1 << 17) + 1, (1 << 18) + 3, (1 << 19) + 5) for G in (GRID, 7, 1)]
    + [(10000, GRID), (32768, GRID)])
def test_grid_schedule_equals_the_plain_sort(N, G):
    passes = {}
    for name, k1, k2, v, want in _cases(N):
        *got, passes[name] = grid_sort3(k1, k2, v, G)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the skip rule's reach: no pass, one pass, the callers' forms, all twelve
    assert passes["all equal"] == 0 and passes["k1's top digit"] == 1
    assert passes["voxel sort (key, arange, arange)"] == 4 and passes["full range"] == 12


def test_grid_schedule_equals_lax_sort():
    """The emulation against the JAX package's sort (the XLA sort its
    callers run by default) on the insert's and the voxel sort's forms."""
    for name, k1, k2, v in _inputs((1 << 17) + 1)[6:]:
        got = grid_sort3(k1, k2, v, GRID)[:3]
        want = jsort.sort3(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
