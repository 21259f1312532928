"""fast_limo_tpu_torch models/iekf against the JAX package (same inputs,
from numpy seeds) and against the float64 oracle (tests/oracle.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import oracle
from fast_limo_tpu.models import iekf as jiekf
from fast_limo_tpu.models import process as jproc
from fast_limo_tpu.models import state as jst
from fast_limo_tpu_torch.models import iekf
from fast_limo_tpu_torch.models import process as proc
from fast_limo_tpu_torch.models import state as st


def _state_np(rng):
    q = rng.normal(size=4)
    qe = np.array([1.0, *(rng.normal(size=3) * 0.01)])
    g = np.array([0.05, -0.1, -9.8])
    return {"pos": rng.normal(size=3) * 5, "rot": q / np.linalg.norm(q),
            "rot_LI": qe / np.linalg.norm(qe), "t_LI": rng.normal(size=3) * 0.1,
            "vel": rng.normal(size=3), "bg": rng.normal(size=3) * 0.01,
            "ba": rng.normal(size=3) * 0.05,
            "grav": g / np.linalg.norm(g) * oracle.S2_LEN}


def _ts(d):
    return st.NavState(**{k: torch.tensor(np.float32(v)) for k, v in d.items()})


def _js(d):
    return jst.NavState(**{k: jnp.asarray(np.float32(v)) for k, v in d.items()})


def _vec(x):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in x])


def _imu(rng, K=9, n_valid=7):
    return {"acc": np.float32(rng.normal(size=(K, 3)) * 0.5 + [0, 0, 9.8]),
            "gyro": np.float32(rng.normal(size=(K, 3)) * 0.2),
            "dt": np.float32(rng.uniform(0.008, 0.012, K)),
            "stamp": np.float32(np.cumsum(rng.uniform(0.008, 0.012, K))),
            "valid": np.arange(K) < n_valid}


def _spd(rng, n=23, s=0.05):
    Q = rng.normal(size=(n, n)) * s
    return np.float32(Q @ Q.T + np.eye(n) * 0.01)


def test_predict_scan_matches_jax_and_oracle(rng):
    """The port folds the quaternion chain and the covariance maps
    sequentially, JAX by associative scans; both are float32 evaluations of
    the same algebra, so each is held to the float64 oracle's sequential
    chain (rtol 2e-4 on the means, atol 2e-5 on P ~ 1e-2) and to each other
    (rtol 1e-4, atol 1e-5)."""
    s = _state_np(rng)
    P = _spd(rng)
    imu = _imu(rng)
    Q = proc.process_noise_Q(6e-4, 1e-2, 1e-5, 3e-4)
    x_t, P_t, xs_t = iekf.predict_scan(_ts(s), torch.tensor(P),
                                       {k: torch.tensor(v) for k, v in imu.items()}, Q)
    Qj = jproc.process_noise_Q(6e-4, 1e-2, 1e-5, 3e-4, jnp.float32)
    x_j, P_j, xs_j = jax.jit(jiekf.predict_scan)(_js(s), jnp.asarray(P),
                                        {k: jnp.asarray(v) for k, v in imu.items()}, Qj)
    np.testing.assert_allclose(_vec(x_t), _vec(x_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xs_t.pos.numpy(), np.asarray(xs_j.pos), rtol=1e-4, atol=1e-5)

    xo, Po = dict(s), np.float64(P)
    for k in range(len(imu["dt"])):
        if imu["valid"][k]:
            xo, Po = oracle.predict(xo, Po, np.float64(imu["acc"][k]),
                                    np.float64(imu["gyro"][k]), float(imu["dt"][k]),
                                    np.asarray(Q, np.float64))
    np.testing.assert_allclose(_vec(x_t), _vec(xo[k] for k in st.NavState._fields),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(P_t.numpy(), Po, rtol=2e-4, atol=2e-5)


def test_body_jnp_matches_jax(rng):
    """One update body (on CPU tensors its gain is K8's plain version, the
    JAX side's the library solve): same algebra, float32 rounding only
    (rtol 1e-4, atol 1e-5; P atol 1e-4)."""
    xp = _state_np(rng)
    dx = rng.normal(size=23) * 1e-3
    x = oracle.state_boxplus(xp, dx)
    H = rng.normal(size=(300, 12))
    HTH, HTh = np.float32(H.T @ H), np.float32(H.T @ rng.normal(size=300))
    P = _spd(rng)
    got = iekf._body_jnp(_ts(x), _ts(xp), torch.tensor(P), torch.tensor(HTH),
                         torch.tensor(HTh), 1e-3, 5.0)
    want = jax.jit(lambda *a: jiekf._body_jnp(*a, 1e-3, 5.0))(
        _js(x), _js(xp), jnp.asarray(P), jnp.asarray(HTH), jnp.asarray(HTh))
    np.testing.assert_allclose(_vec(got[0]), _vec(want[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5)


class _ConstModel:
    def __init__(self, HTH, HTh):
        self.HTH, self.HTh = HTH, HTh

    def stats(self, x):
        return self.HTH, self.HTh


def test_update_iterated_matches_jax(rng):
    """The exact per-iteration loop (K5's plain body: Gauss-Jordan gain +
    spectral guard) against the JAX loop (reference-style gain on CPU):
    equal iteration counts; states within the update-body tolerance of
    tests/test_update_body.py (rtol 1e-3, atol 1e-4; P atol 1e-3)."""
    xp = _state_np(rng)
    H = rng.normal(size=(400, 12)) * 3
    HTH, HTh = np.float32(H.T @ H), np.float32(H.T @ (rng.normal(size=400) * 0.05))
    P = _spd(rng)
    for limit in (1e-9, 1e-3):
        xt, Pt, nt = iekf.update_iterated(_ts(xp), torch.tensor(P),
                                          _ConstModel(torch.tensor(HTH), torch.tensor(HTh)),
                                          R=1e-3, D=5.0, max_iters=3, limit=limit)
        xj, Pj, nj = jiekf.update_iterated(
            _js(xp), jnp.asarray(P), lambda x: (jnp.asarray(HTH), jnp.asarray(HTh)),
            R=1e-3, D=5.0, max_iters=3, limit=limit)
        assert int(nt) == int(nj)
        np.testing.assert_allclose(_vec(xt), _vec(xj), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-3, atol=1e-3)


def test_init_P_matches_jax():
    np.testing.assert_array_equal(iekf.init_P().numpy(), np.asarray(jiekf.init_P(jnp.float32)))
