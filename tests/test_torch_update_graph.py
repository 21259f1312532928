"""The scan step's update stage as one function of tensors, and the graph
runner around it (``models/graphs.StageGraph``), on the CPU.

The lifted function (``build_scan_step``'s ``update``) gives the bits of
the stage's former inline code — ``make_h_model``, ``update_iterated``
and the null-iteration select — on every scan of a replay, with and
without ``cfg.debug``, and K6's fallbacks are counted as often.  A CPU
call, the split body, a shard or query axis and ``cfg.debug`` each run
the function eagerly, and ``update_graph``'s ``eager`` count names the
reason; ``Telemetry.export()["counters"]`` and the board carry the counts.
Capture and replay need a card: ``tests/test_torch_cuda.py``.  Imports
no JAX.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from fast_limo_tpu_torch import entry
from fast_limo_tpu_torch.models import graphs, iekf, measurement
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.parallel import sharded
from fast_limo_tpu_torch.utils import presets
from fast_limo_tpu_torch.utils.telemetry import Spans

N_SCANS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(debug=False, chunk=1):
    cfg = entry._tiny_cfg()
    cfg.tpu.map_voxel_size = 1.2
    cfg.tpu.map_points_per_voxel = 6
    cfg.filters.leafSize = [1.0, 1.0, 1.0]
    cfg.debug, cfg.tpu.scan_chunk = debug, chunk
    return cfg


def _seq():
    return presets.bench_sequence(seed=7, n_scans=N_SCANS, points_per_scan=512)


def _inline(cfg, m, pc2match, pc2_valid, x_t2, P_t2):
    """The update stage as the step ran it inline before it was lifted."""
    mp_cfg = cfg.ikfom.mapping
    h_model = measurement.make_h_model(
        m, pc2match, pc2_valid, voxel_size=cfg.map_voxel_size, k=mp_cfg.NUM_MATCH_POINTS,
        max_dist_plane=mp_cfg.MAX_DIST_PLANE, plane_threshold=mp_cfg.PLANE_THRESHOLD,
        max_num_matches=mp_cfg.MAX_NUM_MATCHES,
        estimate_extrinsics=cfg.ikfom.estimate_extrinsics, x0=x_t2,
        dynamic_gate=mp_cfg.DYNAMIC_GATE, shard_axis=None, num_shards=1,
        query_axis=None, num_query_shards=1, comm=None)
    upd = iekf.update_iterated(
        x_t2, P_t2, h_model, R=cfg.ikfom.lidar_noise, D=cfg.ikfom.degeneracy_thresh,
        max_iters=cfg.ikfom.MAX_NUM_ITERS, limit=cfg.ikfom.LIMITS, split_body=False,
        with_diag=True)
    x_u, P_u, n_iters = upd[:3]
    do_update = torch.sum(pc2_valid) > 1
    x_u = st.where(do_update, x_u, x_t2)
    P_u = torch.where(do_update, P_u, P_t2)
    return x_u, P_u, n_iters, do_update, upd[3], h_model.debug(x_u)


def _tensors(tree):
    return graphs._tensors(pytree.tree_leaves(tree))


def _equal(a, b):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("debug", [False, True])
def test_lifted_update_gives_the_inline_bits(monkeypatch, debug):
    cfg = _cfg(debug)
    seen = []
    call = graphs.StageGraph.__call__

    def both(self, *args):
        out = call(self, *args)
        n0 = iekf.counters.loop_fallbacks
        want = _inline(cfg, *args)
        need = iekf.counters.loop_fallbacks - n0
        x_u, P_u, n_iters, fb, do_update, dbg = out
        _equal((x_u, P_u, n_iters, do_update), want[:4])
        assert bool(fb) == bool(want[4]["loop_fallback"]) == bool(need)
        if debug:
            udiag, hdbg = dbg
            _equal(tuple(udiag[k] for k in sorted(udiag)),
                   tuple(want[4][k] for k in sorted(want[4])))
            _equal(hdbg, want[5])
        else:
            assert dbg is None
        seen.append(bool(fb))
        return out

    monkeypatch.setattr(graphs.StageGraph, "__call__", both)
    n0 = iekf.counters.loop_fallbacks
    loc = Localizer(cfg, device="cpu")
    presets.replay(loc, _seq())
    assert len(seen) == N_SCANS and np.isfinite(loc.positions()).all()
    # the step counted each fallback once, the inline reference once more
    assert iekf.counters.loop_fallbacks - n0 == 2 * sum(seen)


@pytest.mark.parametrize("reason", ["cpu", "split_body", "debug"])
def test_eager_calls_name_their_reason(reason):
    loc = Localizer(_cfg(debug=reason == "debug"), device="cpu",
                    split_body=reason == "split_body")
    presets.replay(loc, _seq())
    c = loc.telemetry.export()["counters"]["update_graph"]
    assert c == {"captures": 0, "replays": 0, "eager": {reason: N_SCANS}}


@pytest.mark.parametrize("mesh", ["map", "map x data"])
def test_sharded_step_runs_eagerly(monkeypatch, mesh):
    recs, build = [], pl.build_scan_step

    def with_recorder(*a, **kw):   # one a rank: the ranks are threads
        recs.append(Spans())
        return build(*a, **{**kw, "spans": recs[-1]})

    monkeypatch.setattr(pl, "build_scan_step", with_recorder)
    m = sharded.make_mesh(2) if mesh == "map" else sharded.make_mesh_2d(2, 2)
    cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
    step, state = sharded.build_sharded_scan_step(cfg, m, "cpu")
    for i in range(2):
        state, out = step(state, entry._example_batch(cfg, seed=i, device="cpu"))
    assert np.isfinite(out.pos.numpy()).all()
    assert len(recs) == len(m.comms)
    for rec in recs:
        assert rec.update_graph.export() == {"captures": 0, "replays": 0,
                                             "eager": {"sharded": 2}}


@pytest.mark.parametrize("chunk", [1, 2])
def test_export_and_board_carry_the_graph_counts(chunk):
    loc = Localizer(_cfg(chunk=chunk), device="cpu")
    presets.replay(loc, _seq())
    loc.flush()
    out = loc.telemetry.export()
    assert out["counters"]["update_graph"]["eager"] == {"cpu": N_SCANS}
    assert {"evictions", "loop_fallbacks", "host_syncs"} <= set(out["counters"])
    assert "Update graph:: 0 captured, 0 replays, eager cpu 4" in loc.board()


def test_steps_without_a_recorder_count_apart():
    """A step built without a recorder counts in one of its own."""
    cfg = _cfg()
    b = entry._example_batch(cfg, seed=0, device="cpu")
    a_step, rec = pl.build_scan_step(cfg, "cpu"), Spans()
    c_step = pl.build_scan_step(cfg, "cpu", spans=rec)
    s = pl.init_state(cfg, "cpu")
    a_step(s, b)
    c_step(s, b)
    c_step(s, b)
    assert rec.update_graph.export() == {"captures": 0, "replays": 0, "eager": {"cpu": 2}}


def test_leaves_and_fill_round_trip():
    """The graph runner's flattening finds every tensor and puts its
    buffers back in place, a NamedTuple as its type and None as None."""
    x = st.identity(torch.float32, gravity=9.81)
    tree = (x, (torch.zeros(2), None), torch.ones(()))
    flat, spec = pytree.tree_flatten(tree)
    leaves = graphs._tensors(flat)
    assert len(leaves) == len(x) + 2
    again = pytree.tree_unflatten(
        [t + 1 if isinstance(t, torch.Tensor) else t for t in flat], spec)
    assert type(again[0]) is st.NavState and again[1][1] is None
    _equal(again, tuple(t + 1 for t in leaves))
    copy = graphs._clone(tree)
    assert type(copy[0]) is st.NavState and copy[1][1] is None
    _equal(copy, tree)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(_tensors(copy), leaves))


def test_every_kernel_wrapper_registers_its_launch_counters():
    """A replay restores the launch counts of every counter registered with
    ``dispatch.counted``: each kernel wrapper is there, with K2's window
    resolves beside its total."""
    from fast_limo_tpu_torch.ops import (deskew_kernel, dispatch, gain, hstats, knn, knn_rows,
                                         plane_kernel, sort, update_body, update_loop)

    got = set(dispatch.counters())
    wrappers = (deskew_kernel.deskew, knn_rows.topk_from_table, plane_kernel.fit_planes,
                plane_kernel.fit_planes_select, hstats.hstats, update_body.update_body,
                update_loop.update_loop, knn.masked_topk, knn.masked_topk_from_table,
                gain.gain, sort.sort3)
    assert {(f, "launches") for f in wrappers} <= got
    assert (knn_rows.topk_from_table, "window_launches") in got
    assert {f for f, _ in got} == set(wrappers)


def test_counted_registers_once_a_name(monkeypatch):
    """``counted`` sets the counters to 0 and a wrapper defined again under
    the same name (its module imported again) takes the old one's place."""
    from fast_limo_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "_COUNTED", {})

    def wrapper():
        pass

    first = wrapper
    assert dispatch.counted(wrapper, "part") is wrapper
    assert (wrapper.launches, wrapper.part) == (0, 0)

    def wrapper():   # noqa: F811
        pass

    dispatch.counted(wrapper)
    assert dispatch.counters() == [(wrapper, "launches")] and wrapper is not first
