"""K8's plain version and the split-body update against the JAX package.

The same numpy inputs from a seed go through both packages.  ``gain.gain``
on CPU tensors is ``gain_math``, the plain version of the CUDA kernel
(csrc/gain.cu); it is held to the JAX Pallas kernel in interpret mode
(``gain_tpu(interpret=True)``, the same algebra in the same order) within
rtol 1e-3 + 1e-3 of the largest entry on the cases of up to three decades,
and on every case, like tests/test_gain.py, to float64 truth within 12× the
float32 library solve's error + 2e-5 of the largest entry (the 4.5-decade
case is ill-conditioned in float32: two float32 algorithms differ there by
more than either differs from truth's scale).  ``gain_reference`` of both
packages (LAPACK solve) agrees within rtol 2e-3 + 2e-3 of the largest entry
on the same cases.

``update_iterated(split_body=True)`` is the JAX package's program with its
fused body off, which is what the JAX package runs on the CPU: equal
iteration counts, states within rtol 1e-3 / atol 1e-4 (P atol 1e-3), and
the diagnostics (gersh_min, min_eig, guard_fired, loop_fallback) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import iekf as jiekf
from fast_limo_tpu.ops import gain as jgain
from fast_limo_tpu_torch.models import iekf
from fast_limo_tpu_torch.ops import gain

from test_torch_iekf import _ConstModel, _js, _spd, _state_np, _ts, _vec

R = 1e-3
CASES = {"full_rank": {}, "zero_extrinsic_dims": {"zero_dims": range(6, 12)},
         "all_zero_measurements": {"zero": True}, "wide_dynamic_range": {"scale_decades": 4.5}}


def _case(rng, n_rows=400, zero_dims=(), scale_decades=3.0, zero=False):
    """The statistics and covariance of tests/test_gain.py's cases."""
    col_scale = np.geomspace(1.0, 10.0 ** scale_decades, gain.M)
    H = rng.standard_normal((n_rows, gain.M)) * col_scale[None, :]
    for z in zero_dims:
        H[:, z] = 0.0
    r = rng.standard_normal(n_rows) * 0.1
    Q = rng.standard_normal((gain.NS, gain.NS))
    P = Q @ Q.T * 1e-4 + np.diag(np.geomspace(1e-6, 1.0, gain.NS))
    P = P + rng.standard_normal((gain.NS, gain.NS)) * 1e-9
    if zero:
        H, r, P = H * 0, r * 0, np.diag(np.geomspace(1e-6, 1.0, gain.NS))
    return np.float32(H.T @ H), np.float32(H.T @ r), np.float32(P)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.mark.parametrize("name", list(CASES))
def test_gain_plain_matches_jax_kernel_and_truth(rng, name):
    HTH, HTh, P = _case(rng, **CASES[name])
    n0 = gain.gain.launches
    got = gain.gain(torch.tensor(HTH), torch.tensor(HTh), torch.tensor(P), R)
    assert gain.gain.launches == n0            # CPU tensors: the plain version
    kern = jgain.gain_tpu(jnp.asarray(HTH), jnp.asarray(HTh), jnp.asarray(P), R, interpret=True)
    lib = gain.gain_reference(torch.tensor(HTH), torch.tensor(HTh), torch.tensor(P), R)
    truth = gain.gain_reference(*(torch.tensor(np.float64(a)) for a in (HTH, HTh, P)), R)
    for g, k, l, t in zip(got, kern, lib, truth):
        g, k = g.numpy(), np.asarray(k)
        assert g.shape == k.shape and g.dtype == np.float32
        if name == "all_zero_measurements":
            assert not g.any() and not k.any()
            continue
        s = float(t.abs().max()) + 1e-12
        e_lib = float((l.double() - t).abs().max()) / s
        assert float(np.abs(g - t.numpy()).max()) / s <= 12.0 * e_lib + 2e-5
        if name != "wide_dynamic_range":
            np.testing.assert_allclose(g, k, rtol=1e-3, atol=1e-3 * np.abs(k).max())


@pytest.mark.parametrize("name", ["full_rank", "zero_extrinsic_dims", "all_zero_measurements"])
def test_gain_reference_matches_jax(rng, name):
    HTH, HTh, P = _case(rng, **CASES[name])
    got = gain.gain_reference(torch.tensor(HTH), torch.tensor(HTh), torch.tensor(P), R)
    want = jgain.gain_reference(jnp.asarray(HTH), jnp.asarray(HTh), jnp.asarray(P), R)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=2e-3 * np.abs(w).max() + 1e-30)


def test_gain_math_has_one_rule():
    """``gain`` chooses by the tensor's device alone: CPU tensors of any
    float dtype go through the plain version, nothing else is consulted."""
    HTH, HTh, P = _case(np.random.default_rng(0))
    a = gain.gain(*(torch.tensor(np.float64(v)) for v in (HTH, HTh, P)), R)
    b = gain.gain_math(torch.tensor(np.float64(HTH)), torch.tensor(np.float64(HTh)),
                       torch.tensor(np.float64(P))[:, :12], torch.tensor(1.0 / R, dtype=torch.float64))
    for x, y in zip(a, b):
        assert x.dtype == torch.float64 and torch.equal(x, y)


@pytest.mark.parametrize("limit", [1e-9, 1e-3])
def test_update_iterated_split_body_matches_jax(rng, limit):
    xp = _state_np(rng)
    H = rng.normal(size=(400, 12)) * 3
    HTH, HTh = np.float32(H.T @ H), np.float32(H.T @ (rng.normal(size=400) * 0.05))
    P = _spd(rng)
    model = _ConstModel(torch.tensor(HTH), torch.tensor(HTh))
    model.loop_pack = object()                 # must be ignored by the split body
    n0, e0 = iekf.counters.host_syncs, iekf.counters.guard_eighs
    xt, Pt, nt, dt = iekf.update_iterated(_ts(xp), torch.tensor(P), model, R=R, D=5.0,
                                          max_iters=3, limit=limit, split_body=True,
                                          with_diag=True)
    # one host read of the Gershgorin bound per evaluation, counted
    assert iekf.counters.host_syncs - n0 == 4
    xj, Pj, nj, dj = jiekf.update_iterated(
        _js(xp), jnp.asarray(P), lambda x: (jnp.asarray(HTH), jnp.asarray(HTh)),
        R=R, D=5.0, max_iters=3, limit=limit, with_diag=True)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(_vec(xt), _vec(xj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dt["gersh_min"].numpy(), np.asarray(dj["gersh_min"]), rtol=1e-6)
    np.testing.assert_allclose(dt["min_eig"].numpy(), np.asarray(dj["min_eig"]), rtol=1e-4)
    assert bool(dt["guard_fired"]) == bool(dj["guard_fired"])
    assert not bool(dt["loop_fallback"]) and not bool(dj["loop_fallback"])
    assert (iekf.counters.guard_eighs - e0 > 0) == bool(np.isfinite(np.asarray(dj["min_eig"])))
    # without diagnostics: the same state, nothing more returned
    out = iekf.update_iterated(_ts(xp), torch.tensor(P), model, R=R, D=5.0, max_iters=3,
                               limit=limit, split_body=True)
    assert len(out) == 3 and torch.equal(out[1], Pt)


def test_guard_fires_alike_on_a_degenerate_direction(rng):
    """A pose direction without information: both packages' guards zero it
    (min_eig < D) and report it."""
    xp = _state_np(rng)
    H = rng.normal(size=(400, 12)) * 3
    H[:, 0] = 0.0
    HTH, HTh = np.float32(H.T @ H), np.float32(H.T @ (rng.normal(size=400) * 0.05))
    P = _spd(rng)
    out_t = iekf.update_iterated(_ts(xp), torch.tensor(P),
                                 _ConstModel(torch.tensor(HTH), torch.tensor(HTh)), R=R, D=5.0,
                                 max_iters=3, limit=1e-3, split_body=True, with_diag=True)
    out_j = jiekf.update_iterated(
        _js(xp), jnp.asarray(P), lambda x: (jnp.asarray(HTH), jnp.asarray(HTh)),
        R=R, D=5.0, max_iters=3, limit=1e-3, with_diag=True)
    assert bool(out_t[3]["guard_fired"]) and bool(out_j[3]["guard_fired"])
    np.testing.assert_allclose(_vec(out_t[0]), _vec(out_j[0]), rtol=1e-3, atol=1e-4)
    assert float(out_t[0].pos[0]) == pytest.approx(float(_ts(xp).pos[0]), abs=1e-6)
