"""The port's multi-device layer (parallel/sharded.py, collectives.py,
distributed.py, the sharded arguments of models/) against the JAX package
on the CPU: the JAX sharded step on the 8-device virtual mesh
(tests/conftest.py), the port's on the in-process backend (one thread a
rank), from the same seeded numpy inputs at ``_tiny_cfg``'s shapes (512
points, 1024 entries a shard).

Twins of tests/test_sharded.py:

- the map-sharded step (D = 4): pos, quat and P within 1e-4 of the port's
  single card at the same global capacity and of the JAX sharded step;
  ``num_points`` exact; the shards concatenated equal the single card's
  table bit for bit, and one insert of the points the JAX step inserted
  gives the JAX sharded table bit for bit;
- the 2-D ('map' 2 × 'data' 2) step, its debug leaves over the whole query
  axis, eviction and the checkpoint round trip under sharding (a
  bit-equal continuation; a JAX sharded checkpoint restores on the
  port's mesh and on one card), ``comm_volume``;
- in place of the HLO counts (``hlo_comm_volume`` parses XLA and is not
  ported): the bytes the collective interface counts, term by term
  against ``comm_volume``.

Also: the stable merge of the shards' top-k picks ``lax.top_k``'s indices
on planted ties, the parameter carry-over of a JAX global sharded state,
and the in-process backend under a shortened switch interval, a raising
rank and a rank that skips a collective.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from fast_limo_tpu.models import mapper as jmp
from fast_limo_tpu.models import pipeline as jpl
from fast_limo_tpu.models import state as jst
from fast_limo_tpu.parallel import sharded as jsh
from fast_limo_tpu.utils import checkpoint as jckpt
from fast_limo_tpu_torch import entry
from fast_limo_tpu_torch.models import mapper as mp
from fast_limo_tpu_torch.models import measurement
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.parallel import collectives, distributed, sharded
from fast_limo_tpu_torch.utils import interop

from test_torch_sequence import one_thread, port_cfg  # noqa: F401 (fixture)

N_SCANS = 3
D = 4

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_numpy(s) -> dict:
    """A JAX LIOState as interop's numpy dict (device_get gathers shards)."""
    d = {"x": np.asarray(jst.as_vector(s.x)), "P": np.asarray(s.P)}
    d.update({f"map.{k}": np.asarray(getattr(s.map, k)) for k in interop.MAP_FIELDS})
    d.update({k: np.asarray(getattr(s, k)) for k in interop.CARRIES})
    return {k: np.array(v, copy=True) for k, v in d.items()}


def _jax_run(cfg, mesh, n):
    step, state = jsh.build_sharded_scan_step(cfg, mesh)
    states, outs = [_jax_numpy(state)], []
    for i in range(n):
        state, out = step(state, ge._example_batch(cfg, seed=i))
        states.append(_jax_numpy(state))
        outs.append({f: np.array(getattr(out, f)) for f in
                     ("pos", "quat", "final_scan", "final_valid")})
    return step, state, states, outs


def _port_run(cfg, mesh, n, single_cap=None):
    step, state = sharded.build_sharded_scan_step(cfg, mesh, "cpu")
    runs = {"sharded": [], "single": []}
    s1 = step1 = None
    if single_cap:
        cfg1 = entry._tiny_cfg(n_pts=512, map_cap=single_cap)
        cfg1.debug = cfg.debug
        step1, s1 = pl.build_scan_step(cfg1, "cpu"), pl.init_state(cfg1, "cpu")
    for i in range(n):
        b = entry._example_batch(cfg, seed=i, device="cpu")
        state, out = step(state, b)
        runs["sharded"].append((state, out))
        if step1 is not None:
            s1, o1 = step1(s1, b)
            runs["single"].append((s1, o1))
    return step, runs


@pytest.fixture(scope="module")
def jax_1d():
    cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=D)
    return (cfg, *_jax_run(cfg, jsh.make_mesh(D), N_SCANS))


@pytest.fixture(scope="module")
def port_1d():
    torch.set_num_threads(1)
    cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=D)
    mesh = sharded.make_mesh(D)
    step, runs = _port_run(cfg, mesh, N_SCANS, single_cap=1024 * D)
    return cfg, mesh, step, runs


@pytest.fixture(scope="module")
def jax_2d():
    cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
    return (cfg, *_jax_run(cfg, jsh.make_mesh_2d(2, 2), N_SCANS))


@pytest.fixture(scope="module")
def port_2d():
    torch.set_num_threads(1)
    cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=2)
    cfg.debug = True
    mesh = sharded.make_mesh_2d(2, 2)
    step, runs = _port_run(cfg, mesh, N_SCANS, single_cap=2048)
    return cfg, mesh, step, runs


def _np(t):
    return t.detach().cpu().numpy()


class TestMapSharded:
    def test_matches_single_card_and_jax(self, port_1d, jax_1d):
        _, _, _, runs = port_1d
        _, _, _, jstates, jouts = jax_1d
        for i, ((s, o), (s1, o1)) in enumerate(zip(runs["sharded"], runs["single"])):
            for got, want in ((o.pos, o1.pos), (o.quat, o1.quat), (s.P, s1.P)):
                np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-4)
            assert int(s.map.num_points) == int(s1.map.num_points)
            # with probing retired the shards concatenated ARE the global table
            assert torch.equal(s.map.table, s1.map.table)
            assert torch.equal(s.map.ptable, s1.map.ptable)
            np.testing.assert_allclose(_np(o.pos), jouts[i]["pos"], rtol=0, atol=1e-4)
            np.testing.assert_allclose(_np(o.quat), jouts[i]["quat"], rtol=0, atol=1e-4)
            np.testing.assert_allclose(_np(s.P), jstates[i + 1]["P"], rtol=0, atol=1e-4)
            assert int(s.map.num_points) == int(jstates[i + 1]["map.num_points"])

    def test_insert_bit_equal_to_jax_shards(self, jax_1d):
        """Each scan's insert (the points the JAX step inserted, into the
        JAX map before it), shard by shard: the JAX sharded table after the
        scan bit for bit, and the single-card insert at G·D alike."""
        cfg, _, _, jstates, jouts = jax_1d
        vs = cfg.map_voxel_size
        for i in range(N_SCANS):
            before = interop.lio_state_from_numpy(jstates[i], "cpu").map
            pts = torch.tensor(jouts[i]["final_scan"])
            valid = torch.tensor(jouts[i]["final_valid"])
            parts = [mp.insert(sharded.map_shard(before, r, D), pts, valid, voxel_size=vs,
                               num_shards=D, shard_index=r) for r in range(D)]
            table = torch.cat([p.table for p in parts])
            ptable = torch.cat([p.ptable for p in parts])
            added = sum(int(p.num_points) - int(before.num_points) for p in parts)
            np.testing.assert_array_equal(_np(table), jstates[i + 1]["map.table"])
            np.testing.assert_array_equal(_np(ptable), jstates[i + 1]["map.ptable"])
            assert int(before.num_points) + added == int(jstates[i + 1]["map.num_points"])
            one = mp.insert(before, pts, valid, voxel_size=vs)
            assert torch.equal(one.table, table) and torch.equal(one.ptable, ptable)

    def test_block_rows_owned_matches_jax(self, jax_1d):
        cfg, _, _, jstates, jouts = jax_1d
        m = interop.lio_state_from_numpy(jstates[-1], "cpu").map
        q = torch.tensor(jouts[-1]["final_scan"][:200])
        jm = jmp.VoxelHashMap(*(jnp.asarray(jstates[-1][f"map.{k}"]) for k in interop.MAP_FIELDS))
        G = m.groups // D
        for r in range(D):
            shard = sharded.map_shard(m, r, D)
            jshard = jm._replace(table=jm.table[r * G:(r + 1) * G],
                                 ptable=jm.ptable[r * G:(r + 1) * G])
            rows, ncb, owned = mp.gather_rows(shard, q, voxel_size=cfg.map_voxel_size,
                                              num_shards=D, shard_index=r)
            jrows, jncb, jowned = jmp.gather_rows(jshard, jnp.asarray(q.numpy()),
                                                  voxel_size=cfg.map_voxel_size,
                                                  num_shards=D, shard_index=r)
            np.testing.assert_array_equal(_np(rows), np.asarray(jrows))
            np.testing.assert_array_equal(_np(owned), np.asarray(jowned))
            got = mp.cands_from_rows(rows, ncb, owned, m.bucket)
            want = jmp.cands_from_rows(jrows, jncb, jowned, m.bucket)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_merge_keeps_lax_top_k_order_on_ties():
    """Planted equal distances within and across shards: the per-shard
    top-k (K7's plain version) and the stable merge pick the candidates
    ``lax.top_k`` picks, in its order."""
    rng = np.random.default_rng(3)
    Dn, N, C, kk = 4, 64, 40, 7
    cand = rng.integers(-2, 3, (Dn, N, C, 3)).astype(np.float32)   # many equal distances
    valid = rng.random((Dn, N, C)) < 0.7
    q = np.zeros((N, 3), np.float32)
    per, jper = [], []
    for d in range(Dn):
        per.append(mp.topk_from_candidates(torch.tensor(cand[d]), torch.tensor(valid[d]),
                                           torch.tensor(q), k=kk))
        jper.append(jmp.topk_from_candidates(jnp.asarray(cand[d]), jnp.asarray(valid[d]),
                                             jnp.asarray(q), k=kk))
        for g, w in zip(per[-1], jper[-1]):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    nbrs, sq, vld = measurement.merge_topk(torch.stack([p[0] for p in per]),
                                           torch.stack([p[1] for p in per]), kk)
    # the JAX package's merge (fast_limo_tpu/models/measurement.py:131-145)
    sq_g = jnp.stack([p[1] for p in jper])
    nb_g = jnp.stack([p[0] for p in jper])
    sq_cat = jnp.moveaxis(sq_g, 0, 1).reshape(N, Dn * kk)
    nb_cat = jnp.moveaxis(nb_g, 0, 1).reshape(N, Dn * kk, 3)
    neg, top = jax.lax.top_k(-sq_cat, kk)
    np.testing.assert_array_equal(_np(sq), np.asarray(-neg))
    np.testing.assert_array_equal(_np(nbrs), np.asarray(jnp.take_along_axis(
        nb_cat, top[..., None], axis=1)))
    # the indices themselves: code (shard, column) into the points
    code = np.stack(np.meshgrid(np.arange(Dn), np.arange(N), np.arange(kk), indexing="ij"),
                    -1).astype(np.float32)                   # (D,N,kk,3)
    sq_np = np.asarray(sq_g)
    got = measurement.merge_topk(torch.tensor(code), torch.tensor(sq_np), kk)[0]
    _, top2 = jax.lax.top_k(-jnp.moveaxis(jnp.asarray(sq_np), 0, 1).reshape(N, Dn * kk), kk)
    want = np.moveaxis(code, 0, 1).reshape(N, Dn * kk, 3)[np.arange(N)[:, None], np.asarray(top2)]
    np.testing.assert_array_equal(_np(got), want)
    assert (np.diff(sq_np.reshape(-1)) == 0).mean() > 0.3     # the ties are there


class TestMesh2D:
    def test_2d_matches_single_card_and_jax(self, port_2d, jax_2d):
        _, _, _, runs = port_2d
        _, _, _, jstates, jouts = jax_2d
        for i, ((s, o), (s1, o1)) in enumerate(zip(runs["sharded"], runs["single"])):
            np.testing.assert_allclose(_np(o.pos), _np(o1.pos), rtol=0, atol=1e-4)
            n_s, n_1 = int(s.map.num_points), int(s1.map.num_points)
            assert abs(n_s - n_1) <= 0.05 * max(n_s, n_1)
            np.testing.assert_allclose(_np(s.P), _np(s1.P), rtol=0, atol=1e-3)
            np.testing.assert_allclose(_np(o.pos), jouts[i]["pos"], rtol=0, atol=1e-4)
            np.testing.assert_allclose(_np(s.P), jstates[i + 1]["P"], rtol=0, atol=1e-3)

    def test_2d_debug_leaves_full_query_axis(self, port_2d):
        _, _, _, runs = port_2d
        for (_, o), (_, o1) in zip(runs["sharded"][:2], runs["single"][:2]):
            d, d1 = o.debug, o1.debug
            for f in ("match_planes", "match_keep", "match_dist"):
                assert getattr(d, f).shape == getattr(d1, f).shape, f
            keep, keep1 = _np(d.match_keep), _np(d1.match_keep)
            assert np.mean(keep == keep1) > 0.98
            both = keep & keep1
            np.testing.assert_allclose(_np(d.match_dist)[both], _np(d1.match_dist)[both],
                                       atol=1e-3)
            assert int(d.n_stale) == int(d1.n_stale)


class TestShardedLifecycle:
    def test_evict_far_under_sharding(self, port_1d, jax_1d):
        cfg, _, step, runs = port_1d
        state, out = runs["sharded"][-1]
        n_before = int(state.map.num_points)
        m = mp.evict_far(state.map, out.pos, 5.0, voxel_size=cfg.map_voxel_size)
        assert 0 <= int(m.num_points) < n_before
        # elementwise on the global table: the shards evicted one by one agree
        parts = [mp.evict_far(sharded.map_shard(state.map, r, D), out.pos, 5.0,
                              voxel_size=cfg.map_voxel_size) for r in range(D)]
        assert torch.equal(torch.cat([p.table for p in parts]), m.table)
        # the JAX evict on the JAX sharded map, bit for bit
        jcfg, _, _, jstates, jouts = jax_1d
        js = jstates[-1]
        jm = jmp.VoxelHashMap(*(jnp.asarray(js[f"map.{k}"]) for k in interop.MAP_FIELDS))
        want = jmp.evict_far(jm, jnp.asarray(jouts[-1]["pos"]), 5.0,
                             voxel_size=jcfg.map_voxel_size)
        got = mp.evict_far(interop.lio_state_from_numpy(js, "cpu").map,
                           torch.tensor(jouts[-1]["pos"]), 5.0, voxel_size=cfg.map_voxel_size)
        np.testing.assert_array_equal(_np(got.table), np.asarray(want.table))
        np.testing.assert_array_equal(_np(got.ptable), np.asarray(want.ptable))
        assert int(got.num_points) == int(want.num_points)
        state2, out2 = step(state._replace(map=m), entry._example_batch(cfg, seed=5, device="cpu"))
        assert torch.isfinite(out2.pos).all()

    def test_checkpoint_roundtrip_under_sharding(self, port_1d, tmp_path):
        cfg, mesh, step, runs = port_1d
        state, _ = runs["sharded"][-1]
        path = str(tmp_path / "sharded.npz")
        distributed.save_checkpoint(path, state, mesh)
        restored = distributed.load_checkpoint(path, sharded.init_global_state(cfg, D, "cpu"),
                                               mesh)
        batch = entry._example_batch(cfg, seed=99, device="cpu")
        s_live, o_live = step(state, batch)
        s_rest, o_rest = step(restored, batch)
        assert torch.equal(o_live.pos, o_rest.pos)
        assert torch.equal(s_live.map.table, s_rest.map.table)
        assert int(s_live.map.num_points) == int(s_rest.map.num_points)
        # the same file on one card: a Localizer at the global capacity
        cfg1 = entry._tiny_cfg(n_pts=512, map_cap=1024 * D)
        loc = Localizer(cfg1, device="cpu")
        loc.load_checkpoint(path)
        assert torch.equal(loc.state.map.ptable, state.map.ptable)
        assert torch.equal(loc.state.P, state.P)

    def test_jax_sharded_checkpoint_restores_on_the_port(self, jax_1d, port_1d, tmp_path):
        """A checkpoint of the JAX sharded state (device_get gathers the
        shards) restores on the port's mesh, and the carried-over state
        (interop) steps on it as the JAX step does, within 1e-4."""
        jcfg, jstep, jstate, jstates, _ = jax_1d
        cfg, mesh, step, _ = port_1d
        path = str(tmp_path / "jax_sharded.npz")
        jckpt.save_state(path, jstate)
        restored = distributed.load_checkpoint(path, sharded.init_global_state(cfg, D, "cpu"),
                                               mesh)
        carried = interop.lio_state_from_numpy(jstates[-1], "cpu")
        got, want = (_leaves(distributed.fetch(t)) for t in (restored, carried))
        assert len(got) == len(want) == 21
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        s2, o2 = step(carried, entry._example_batch(cfg, seed=7, device="cpu"))
        _, jo2 = jstep(jstate, ge._example_batch(jcfg, seed=7))
        np.testing.assert_allclose(_np(o2.pos), np.asarray(jo2.pos), rtol=0, atol=1e-4)


def _leaves(node):
    if isinstance(node, tuple):
        return [x for n in node for x in _leaves(n)]
    return [np.asarray(node)]


class TestCommVolume:
    def test_comm_volume_is_the_jax_model(self):
        for n_map, n_data in ((1, 1), (4, 1), (4, 2), (2, 2), (8, 1)):
            cfg = ge._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_map)
            assert sharded.comm_volume(port_cfg(cfg), n_map, n_data) == \
                jsh.comm_volume(cfg, n_map, n_data)

    def test_comm_volume_model(self):
        cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=4)
        v1 = sharded.comm_volume(cfg, 1, 1)
        v4 = sharded.comm_volume(cfg, 4, 1)
        v42 = sharded.comm_volume(cfg, 4, 2)
        assert v1["knn_allgather_bytes"] == 0
        assert v4["knn_allgather_bytes"] > 0
        k = cfg.ikfom.mapping.NUM_MATCH_POINTS
        evals = cfg.ikfom.MAX_NUM_ITERS + 1
        patched = 3 * measurement.STALE_BUDGET * k * 4 * 4 * evals
        assert v42["knn_allgather_bytes"] == \
            (v4["knn_allgather_bytes"] - patched) // 2 + patched
        assert v42["hstats_psum_bytes"] > 0

    @pytest.mark.parametrize("layout", ["1d", "2d"])
    def test_counted_bytes_are_the_model(self, layout, port_1d, port_2d):
        """One scan's received bytes at the collective interface, term by
        term: the kNN gathers, HᵀH psums, certificate reductions and the
        count psum as ``comm_volume``; the cap gather and the gate psums a
        third of it (the JAX program holds them in all three cond branches,
        the port finishes the selected branch once).  With them the sums the
        JAX test asserts against the compiled HLO: all-gathers = kNN + cap,
        all-reduces = HᵀH + gate + certificate + count."""
        if layout == "1d":
            cfg, mesh, step, runs = port_1d
            n_map, n_data = D, 1
        else:
            cfg, mesh, step, runs = port_2d
            n_map, n_data = 2, 2
        state, _ = runs["sharded"][0]
        cfg_nd = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n_map)
        step, _ = sharded.build_sharded_scan_step(cfg_nd, mesh, "cpu")
        mesh.reset_received()
        step(state, entry._example_batch(cfg_nd, seed=1, device="cpu"))
        model = sharded.comm_volume(cfg_nd, n_map, n_data)
        for r in range(mesh.size):
            got = mesh.received(r)
            got = {k: got.get(k, 0) for k in model if k.endswith("_bytes")}
            for key in ("knn_allgather_bytes", "hstats_psum_bytes", "cert_psum_bytes",
                        "num_points_psum_bytes"):
                assert got[key] == model[key], (key, got, model)
            for key in ("cap_allgather_bytes", "gate_psum_bytes"):
                assert 3 * got[key] == model[key], (key, got, model)
            allgather = got["knn_allgather_bytes"] + got["cap_allgather_bytes"]
            allreduce = (got["hstats_psum_bytes"] + got["gate_psum_bytes"]
                         + got["cert_psum_bytes"] + got["num_points_psum_bytes"])
            assert allgather == model["knn_allgather_bytes"] + model["cap_allgather_bytes"] // 3
            assert allreduce == (model["hstats_psum_bytes"] + model["gate_psum_bytes"] // 3
                                 + model["cert_psum_bytes"] + model["num_points_psum_bytes"])


class TestInProcessBackend:
    def test_collectives_under_a_short_switch_interval(self):
        """16 ranks (more than the cores), a 1 µs switch interval: a shared
        counter bumped by every rank between collectives loses no update,
        and psum / pmax / all_gather give the rank-order results."""
        group = collectives.InProcessGroup({"a": 4, "b": 4}, timeout=60)
        counter = {"n": 0}
        rounds = 50

        def body(comm):
            acc = []
            for i in range(rounds):
                n = counter["n"]
                counter["n"] = n + 1
                x = torch.tensor([float(comm.rank + i)])
                acc.append((comm.psum(x, "a"), comm.pmax(x, "b"), comm.all_gather(x, "a")))
            comm.barrier()
            return acc

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            res = group.run(body)
        finally:
            sys.setswitchinterval(old)
        assert counter["n"] == 16 * rounds
        c0 = group.comms[0]
        for r in range(16):
            ga, gb = c0.group("a", r), c0.group("b", r)
            assert ga == [c0.rank_of({**c0.coords(r), "a": i}) for i in range(4)]
            for i, (s, m, g) in enumerate(res[r]):
                assert float(s) == float(sum(q + i for q in ga))
                assert float(m) == float(max(q + i for q in gb))
                assert g.reshape(-1).tolist() == [float(q + i) for q in ga]
        assert group.comms[0].received["other"] == rounds * (3 * 4 + 2 * (2 * 3 / 4 * 4))

    def test_a_raising_rank_aborts_every_rank(self):
        group = collectives.InProcessGroup({"a": 3}, timeout=60)

        def body(comm):
            comm.psum(torch.ones(1), "a")
            if comm.rank == 1:
                raise ValueError("rank 1 fails")
            return comm.psum(torch.ones(1), "a")

        with pytest.raises(ValueError, match="rank 1 fails"):
            group.run(body)
        assert threading.active_count() < 50

    def test_a_skipped_collective_times_out(self):
        group = collectives.InProcessGroup({"a": 2}, timeout=1.0)

        def body(comm):
            if comm.rank == 0:
                comm.psum(torch.ones(1), "a")
            return comm.rank

        with pytest.raises(threading.BrokenBarrierError):
            group.run(body)

    def test_the_query_axis_needs_a_map_axis(self):
        """Every mesh of parallel/sharded.py that splits the queries also
        shards the map; a measurement model with only a query axis is
        refused."""
        comm = collectives.InProcessGroup({"data": 2}).comms[0]
        with pytest.raises(ValueError, match="beside a map axis"):
            measurement.HModel(None, None, None, voxel_size=1.0, k=5, max_dist_plane=1.0,
                               plane_threshold=0.1, max_num_matches=10,
                               estimate_extrinsics=False, x0=None, query_axis="data",
                               num_query_shards=2, comm=comm)
