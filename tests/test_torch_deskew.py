"""K1 deskew: the port's plain version (ops/deskew_kernel.deskew on CPU
tensors) against the JAX kernel in interpret mode (deskew_tpu) and the JAX
jnp chain (models/deskew.deskew), on the same numpy-seeded inputs.

Tolerance rtol 1e-4 / atol 2e-4 on metre-scale coordinates, as
tests/test_deskew_kernel.py: the formulas are the same, float32
association and the cos/sinc branch differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_limo_tpu.models import deskew as jdsk
from fast_limo_tpu.models import state as jst
from fast_limo_tpu.ops import deskew_kernel as jdk
from fast_limo_tpu.ops import s2 as js2
from fast_limo_tpu_torch.models import deskew as dsk
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import deskew_kernel

TOL = dict(rtol=1e-4, atol=2e-4)


def _case(rng, N=600, K=17, n_valid=None, regress=False, nan=False):
    n_valid = K if n_valid is None else n_valid
    times = np.sort(rng.uniform(0.0, 0.1, K)).astype(np.float32)
    if regress:
        times[5] = times[2] - 0.005          # a regressed IMU stamp
    q = rng.standard_normal((K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f = {"time": times, "pos": rng.uniform(-5, 5, (K, 3)), "rot": q,
         "vel": rng.uniform(-2, 2, (K, 3)), "bg": rng.normal(0, 0.01, (K, 3)),
         "ba": rng.normal(0, 0.05, (K, 3)),
         "grav": np.tile([0.0, 0.0, -9.81], (K, 1)),
         "w": rng.normal(0, 0.3, (K, 3)), "a": rng.normal(0, 1.0, (K, 3)) + [0, 0, 9.81]}
    f = {k: np.float32(v) for k, v in f.items()}
    fvalid = np.arange(K) < n_valid
    pts = np.float32(rng.uniform(-30, 30, (N, 3)))
    t = np.float32(rng.uniform(-0.01, 0.12, N))
    t[:K] = times                             # exact frame-time ties
    valid = rng.random(N) < 0.9
    if nan:
        bad = np.zeros(N, bool)
        bad[::17] = True
        pts[bad] = np.nan
        t[bad] = np.nan
        valid &= ~bad
    q_ext = np.float32([1.0, 0.02, -0.01, 0.03])
    q_ext /= np.linalg.norm(q_ext)
    t_ext = np.float32([0.1, -0.05, 0.2])
    rot = np.float32(rng.standard_normal(4))
    rot /= np.linalg.norm(rot)
    pos = np.float32(rng.uniform(-5, 5, 3))
    return f, fvalid, pts, t, valid, q_ext, t_ext, rot, pos


def _port(case):
    f, fvalid, pts, t, valid, q_ext, t_ext, rot, pos = case
    fr = dsk.Frames(**{k: torch.tensor(v) for k, v in f.items()},
                    valid=torch.tensor(fvalid))
    x_last = st.identity()._replace(rot=torch.tensor(rot), pos=torch.tensor(pos))
    return dsk.deskew(torch.tensor(pts), torch.tensor(t), torch.tensor(valid), fr,
                      x_last, torch.tensor(q_ext), torch.tensor(t_ext))


def _sources(case):
    """The frames of a case as the scan step passes them: a carry-in row
    and the window (views of the stacked tensors)."""
    f, fvalid = case[0], case[1]
    fr = dsk.Frames(**{k: torch.tensor(v) for k, v in f.items()}, valid=torch.tensor(fvalid))
    return fr, (dsk.Frames(*[a[:1] for a in fr]), dsk.Frames(*[a[1:] for a in fr]))


def _jax_frames(f, fvalid):
    return jdsk.Frames(**{k: jnp.asarray(v) for k, v in f.items()},
                       valid=jnp.asarray(fvalid))


def _jax_kernel(case):
    f, fvalid, pts, t, valid, q_ext, t_ext, rot, pos = case
    return jdk.deskew_tpu(jnp.asarray(pts), jnp.asarray(t), jnp.asarray(valid),
                          _jax_frames(f, fvalid), jnp.asarray(rot), jnp.asarray(pos),
                          jnp.asarray(q_ext), jnp.asarray(t_ext), interpret=True)


def _jax_chain(case, monotone=False):
    f, fvalid, pts, t, valid, q_ext, t_ext, rot, pos = case
    if monotone:
        f = dict(f, time=np.maximum.accumulate(f["time"]))
    x_last = jst.identity(jnp.float32)._replace(
        rot=jnp.asarray(rot), pos=jnp.asarray(pos),
        grav=js2.project(jnp.asarray([0, 0, -9.81], jnp.float32)))
    return jax.jit(jdsk.deskew)(jnp.asarray(pts), jnp.asarray(t), jnp.asarray(valid),
                       _jax_frames(f, fvalid), x_last, jnp.asarray(q_ext),
                       jnp.asarray(t_ext))


@pytest.mark.parametrize("kw", [{}, {"K": 33, "n_valid": 12}, {"N": 1280},
                                {"regress": True}, {"nan": True},
                                {"K": 33, "n_valid": 27, "regress": True}])
def test_plain_k1_matches_jax(rng, kw):
    case = _case(rng, **kw)
    got = _port(case)
    assert all(np.isfinite(g.numpy()).all() for g in got)
    for g, w in zip(got, _jax_kernel(case)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the jnp chain searches the raw frame times: compare on monotone ones
    for g, w in zip(got, _jax_chain(case, monotone=kw.get("regress", False))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_frame_table_layout(rng):
    case = _case(rng, K=9, n_valid=6, regress=True)
    f, fvalid = case[0], case[1]
    F = deskew_kernel.frame_table(dsk.Frames(**{k: torch.tensor(v) for k, v in f.items()},
                                             valid=torch.tensor(fvalid)))
    assert F.shape == (9, deskew_kernel.FW)
    T = F[:, 0].numpy()
    assert np.all(np.diff(T[:6]) >= 0) and np.all(np.isinf(T[6:]))


def test_two_sources_equal_the_stacked_frames(rng):
    """The carry-in row and the window as two sources give the stacked
    frames' outputs bit for bit (on the CPU both are stacked first)."""
    case = _case(rng, K=33, n_valid=27, regress=True)
    _, _, pts, t, valid, q_ext, t_ext, rot, pos = case
    fr, srcs = _sources(case)
    x_last = st.identity()._replace(rot=torch.tensor(rot), pos=torch.tensor(pos))
    args = (torch.tensor(pts), torch.tensor(t), torch.tensor(valid))
    a = dsk.deskew(*args, fr, x_last, torch.tensor(q_ext), torch.tensor(t_ext))
    b = dsk.deskew(*args, srcs, x_last, torch.tensor(q_ext), torch.tensor(t_ext))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(deskew_kernel.stack_frames(srcs), fr))


def test_frames_from_scan_sources_are_views(rng):
    """frames_from_scan's two sources: the carry-in state as one row and
    the propagated window, stacking to [x0; xs] with the carry-in valid."""
    K = 8
    x0 = st.identity()._replace(pos=torch.tensor(np.float32(rng.normal(size=3))))
    xs = st.NavState(*[torch.tensor(np.float32(rng.normal(size=(K,) + tuple(a.shape))))
                       for a in x0])
    imu = {"stamp": torch.tensor(np.float32(np.sort(rng.uniform(0, 0.1, K)))),
           "gyro": torch.tensor(np.float32(rng.normal(size=(K, 3)))),
           "acc": torch.tensor(np.float32(rng.normal(size=(K, 3)))),
           "valid": torch.tensor(rng.random(K) < 0.8)}
    w0, a0 = (torch.tensor(np.float32(rng.normal(size=3))) for _ in range(2))
    t0 = torch.tensor(np.float32(-0.01))
    head, tail = dsk.frames_from_scan(x0, t0, w0, a0, xs, imu)
    assert head.pos.data_ptr() == x0.pos.data_ptr() and tail.w.data_ptr() == imu["gyro"].data_ptr()
    fr = deskew_kernel.stack_frames((head, tail))
    assert fr.time.shape == (K + 1,) and bool(fr.valid[0])
    np.testing.assert_array_equal(fr.valid[1:].numpy(), imu["valid"].numpy())
    np.testing.assert_array_equal(fr.rot.numpy(), np.concatenate([x0.rot[None], xs.rot]))
    np.testing.assert_array_equal(fr.a.numpy(), np.concatenate([a0[None], imu["acc"]]))
