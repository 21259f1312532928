"""The port's multi-session step (parallel/batched.py) and its ``entry()``
twin, on the CPU.

Two sessions (the bench corridor's weave at seeds 3 and 9, 2048-point
scans at tests/test_pipeline.py's small_cfg) whose ScanBatches are captured
from port Localizers through ``on_dispatch``:

- the batched step equals each session's own single-session steps on the
  same batches bit for bit, in the poses and in every leaf of the final
  states (the same code in the same order);
- a session idle for two ticks (``noop_batch``, ``active`` False) keeps
  its state bit for bit, and when it resumes it continues exactly as its
  single-session steps without the idle ticks;
- against the JAX package's vmapped step on the same batches, the poses
  agree within tests/test_batched.py:86's 0.15 m (vmap alone parts the JAX
  program from its single-session step by centimetres);
- ``entry()`` runs the per-scan step at ``__graft_entry__``'s shapes and
  agrees with the JAX ``entry()`` (1e-4 m, one step from the same state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.parallel import batched as jbatched
from fast_limo_tpu_torch import entry
from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.parallel import batched
from fast_limo_tpu_torch.utils import presets

from test_pipeline import small_cfg
from test_torch_sequence import one_thread, port_cfg  # noqa: F401 (fixture)

N_TICKS = 4


def _cfgs():
    jcfg = small_cfg()
    jcfg.tpu.max_points_per_scan = 2048
    jcfg.ikfom.mapping.MAX_NUM_PC2MATCH = 2048
    return port_cfg(jcfg), jcfg


def _capture(cfg, seed, n):
    seq = synthetic.SyntheticSequence(
        seed=seed, n_scans=n, points_per_scan=cfg.tpu.max_points_per_scan,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=5.0, yaw_amp=0.3))
    loc = Localizer(cfg, device="cpu")
    captured = []
    loc.on_dispatch = lambda sp, ip: captured.append(batched.batch_from_packs(cfg, sp, ip, "cpu"))
    presets.replay(loc, seq)
    assert len(captured) == n
    return captured


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _singles(cfg, batches):
    """One session's single-session steps: (pos per step, final state)."""
    step = pl.build_scan_step(cfg, "cpu")
    s, pos = pl.init_state(cfg, "cpu"), []
    for b in batches:
        s, out = step(s, b)
        pos.append(out.pos)
    return pos, s


@pytest.fixture(scope="module")
def fleet():
    cfg, jcfg = _cfgs()
    a, b = _capture(cfg, 3, N_TICKS), _capture(cfg, 9, N_TICKS)
    step = batched.build_batched_scan_step(cfg, "cpu")
    states = batched.init_batched_state(cfg, 2, "cpu")
    on = torch.ones(2, dtype=torch.bool)
    pos = []
    for k in range(N_TICKS):
        states, outs = step(states, batched.stack_batches([a[k], b[k]]), on)
        pos.append(outs.pos.clone())
    return cfg, jcfg, a, b, torch.stack(pos), states


def test_matches_single_session_bit_for_bit(fleet):
    cfg, _jcfg, a, b, pos, states = fleet
    for i, batches in enumerate((a, b)):
        want_pos, want_state = _singles(cfg, batches)
        assert torch.equal(pos[:, i], torch.stack(want_pos))
        got = _leaves(batched.select_session(states, i))
        want = _leaves(want_state)
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_idle_session_frozen_then_resumes(fleet):
    cfg, _jcfg, a, b, _pos, _states = fleet
    step = batched.build_batched_scan_step(cfg, "cpu")
    noop = batched.noop_batch(cfg, "cpu")
    states = batched.init_batched_state(cfg, 2, "cpu")
    states, _ = step(states, batched.stack_batches([a[0], b[0]]), torch.ones(2, dtype=torch.bool))
    frozen = [t.clone() for t in _leaves(batched.select_session(states, 1))]
    idle = torch.tensor([True, False])
    for k in (1, 2):                           # session 1 idles on ticks 1-2
        states, _ = step(states, batched.stack_batches([a[k], noop]), idle)
        now = _leaves(batched.select_session(states, 1))
        assert all(torch.equal(f, n) for f, n in zip(frozen, now))
    assert int(batched.select_session(states, 0).map.num_points) > int(
        batched.select_session(states, 1).map.num_points) > 0
    states, outs = step(states, batched.stack_batches([a[3], b[1]]),
                        torch.ones(2, dtype=torch.bool))
    want_pos, _s = _singles(cfg, b[:2])
    assert torch.equal(outs.pos[1], want_pos[1])
    want_pos, _s = _singles(cfg, a)
    assert torch.equal(outs.pos[0], want_pos[3])


def test_matches_jax_batched_step(fleet):
    _cfg, jcfg, a, b, pos, _states = fleet

    def to_jax(tb):
        return jpl.ScanBatch(*(jnp.asarray(t.numpy()) for t in tb))

    jstep = jbatched.build_batched_scan_step(jcfg, donate=False)
    jstates = jbatched.init_batched_state(jcfg, 2)
    jpos = []
    for k in range(N_TICKS):
        jb = jbatched.stack_batches([to_jax(a[k]), to_jax(b[k])])
        jstates, jouts = jstep(jstates, jb, jnp.ones(2, bool))
        jpos.append(np.asarray(jouts.pos))
    np.testing.assert_allclose(pos.numpy(), np.stack(jpos), rtol=0, atol=0.15)
    jax.block_until_ready(jstates)


def test_entry_twin_runs_and_matches_jax():
    step, (state, batch) = entry.entry(device="cpu")
    s2, out = step(state, batch)
    assert torch.isfinite(out.pos).all() and torch.isfinite(s2.P).all()
    assert int(s2.map.num_points) > 0
    jstep, (jstate, jbatch) = ge.entry()
    _js2, jout = jax.jit(jstep)(jstate, jbatch)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos), rtol=0, atol=1e-4)
    assert int(out.n_iters) == int(jout.n_iters)
