"""K3's branch-selecting entry (``plane_kernel.fit_planes_select``): the
exact update loop's re-match fit — window, stale patch or full re-match,
chosen by the device's stale count — in one launch.

On the CPU the wrapper runs ``fit_planes_select_plain``.  Two properties
are held here, bit for bit, on numpy-seeded neighbour sets:

- the plain version equals the composition the measurement model ran
  before the one-launch entry existed (three one-set fits, the patch
  written into a copy of the window fit by an indexed write, then the
  nested ``torch.where`` over the branch);
- an emulation of the kernel's per-thread write rule (``csrc/plane.cu``:
  threads 0..N-1 write their query's window or full row and skip a stale
  query in the patched branch; threads N..N+B-1 write the patch row r to
  query idx[r] where that query is stale) gives the same arrays and writes
  every query exactly once, or nothing under a clear active flag.

The per-row fit itself is held to the JAX kernel in
``test_torch_measurement.py``, and the whole re-match (all three branches)
to the JAX ``_rematch`` in ``test_make_h_model_branches_match_jax``.
"""

import numpy as np
import pytest
import torch

from fast_limo_tpu_torch.ops import plane_kernel

N, K, B = 300, 5, 40
KW = dict(num_match_points=5, max_dist_plane=1.0, plane_threshold=0.1)


def _set(rng, rows, *, invalid_rows=(), nan_rows=()):
    """(nbrs (rows,K,3), sq (rows,K) ascending, valid (rows,K)): noisy
    planar neighbourhoods, ~10 % invalid slots (inf distance), some rows
    wholly invalid, some with NaN distances."""
    centre = rng.uniform(-20.0, 20.0, (rows, 1, 3))
    nrm = rng.normal(size=(rows, 1, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    off = rng.normal(0.0, 0.3, (rows, K, 3))
    off -= (off * nrm).sum(-1, keepdims=True) * nrm
    nbrs = centre + off + rng.normal(0.0, 0.01, (rows, K, 1)) * nrm
    sq = np.sort(rng.uniform(0.0, 1.2, (rows, K)), axis=1)
    valid = rng.random((rows, K)) > 0.1
    valid[list(invalid_rows)] = False
    sq = np.where(valid, sq, np.inf)
    sq[list(nan_rows), 2:] = np.nan
    return (torch.tensor(nbrs, dtype=torch.float32), torch.tensor(sq, dtype=torch.float32),
            torch.tensor(valid))


CASES = {
    "window": dict(n_stale=0),
    "patched_viol_1": dict(n_stale=1),
    "patched_viol_budget": dict(n_stale=B),
    "full_viol_budget_plus_1": dict(n_stale=B + 1),
    "all_invalid_rows": dict(n_stale=7, invalid_rows=(0, 3, 17, 250)),
    "nan_distances": dict(n_stale=B + 5, nan_rows=(1, 4, 30, 299)),
    "inactive_flag": dict(n_stale=9, active=False),
}


def _inputs(name):
    c = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    bad = dict(invalid_rows=c.get("invalid_rows", ()), nan_rows=c.get("nan_rows", ()))
    nbrs_w, sq_w, vld_w = _set(rng, N, **bad)
    win = (nbrs_w, torch.where(vld_w, sq_w, torch.full_like(sq_w, float("inf"))))
    stale = torch.zeros(N, dtype=torch.bool)
    stale[torch.tensor(rng.choice(N, c["n_stale"], replace=False), dtype=torch.int64)] = True
    idx = torch.sort(stale.to(torch.int8), descending=True, stable=True)[1][:B]
    patch = _set(rng, B, invalid_rows=[r for r in bad["invalid_rows"] if r < B],
                 nan_rows=[r for r in bad["nan_rows"] if r < B])
    full = _set(rng, N, **bad)
    viol = torch.sum(stale, dtype=torch.int32)
    active = torch.tensor(c.get("active", True))
    return win, patch, idx, stale, full, viol, active


def _old_composition(win, patch, idx, stale, full, viol):
    """The re-match's merge as the measurement model ran it with three
    one-set K3 launches."""
    fit_w = plane_kernel.fit_planes(win[0], win[1], torch.isfinite(win[1]), **KW)
    n_w, good_w = fit_w
    sel_ok = stale[idx]
    n_s, good_s = plane_kernel.fit_planes(*patch, **KW)
    n_m = n_w.clone()
    good_m = good_w.clone()
    n_m[idx] = torch.where(sel_ok[:, None], n_s, n_w[idx])
    good_m[idx] = torch.where(sel_ok, good_s, good_w[idx])
    fit_p = (n_m, good_m)
    fit_f = plane_kernel.fit_planes(*full, **KW)
    some, few = viol > 0, viol <= B
    return tuple(torch.where(some, torch.where(few, p, f), w)
                 for w, p, f in zip(fit_w, fit_p, fit_f))


def _kernel_emulation(win, patch, idx, stale, full, viol, active):
    """csrc/plane.cu's grid, thread by thread: (n_abcd, good, writes a
    query).  The kernel runs the same device function on a row whichever
    set it comes from, so a thread's result is that row of the set's fit."""
    rows_w = plane_kernel.fit_planes_plain(win[0], win[1], torch.isfinite(win[1]), **KW)
    rows_p = plane_kernel.fit_planes_plain(*patch, **KW)
    rows_f = plane_kernel.fit_planes_plain(*full, **KW)
    n_abcd = torch.full((N, 4), float("nan"))
    good = torch.zeros(N, dtype=torch.bool)
    writes = np.zeros(N, dtype=np.int64)
    if not bool(active):
        return n_abcd, good, writes
    v = int(viol)
    branch = 0 if v == 0 else (1 if v <= B else 2)
    for t in range(N + B):
        if t < N:
            if branch == 1 and bool(stale[t]):
                continue
            src, q, r = (rows_f if branch == 2 else rows_w), t, t
        elif branch == 1:
            r = t - N
            q = int(idx[r])
            if not bool(stale[q]):
                continue
            src = rows_p
        else:
            continue
        n_abcd[q], good[q] = src[0][r], src[1][r]
        writes[q] += 1
    return n_abcd, good, writes


def _bits(t):
    return t.numpy().tobytes()


@pytest.mark.parametrize("name", list(CASES))
def test_select_plain_equals_the_old_composition(name):
    win, patch, idx, stale, full, viol, active = _inputs(name)
    want = _old_composition(win, patch, idx, stale, full, viol)
    plain = plane_kernel.fit_planes_select_plain(win, patch, idx, stale, full, viol, **KW)
    wrapped = plane_kernel.fit_planes_select(win, patch, idx, stale, full, viol, **KW,
                                             active=active)
    for got in (plain, wrapped):
        assert [_bits(g) for g in got] == [_bits(w) for w in want]
    n = CASES[name]["n_stale"]
    assert int(viol) == n and n <= N
    assert plane_kernel.fit_planes_select.launches == 0   # the CPU runs no kernel


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_write_rule_gives_the_plain_arrays(name):
    win, patch, idx, stale, full, viol, active = _inputs(name)
    n_abcd, good, writes = _kernel_emulation(win, patch, idx, stale, full, viol, active)
    if not bool(active):
        assert not writes.any()   # a clear flag returns before any load
        return
    assert (writes == 1).all()
    want = plane_kernel.fit_planes_select_plain(win, patch, idx, stale, full, viol, **KW)
    assert _bits(n_abcd) == _bits(want[0]) and _bits(good) == _bits(want[1])
    assert bool(good.any()) and not bool(good.all())
