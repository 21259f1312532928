"""The port's process-spanning backend: 2 CPU processes, one rank each,
over torch.distributed (gloo), run parallel/_dist_worker.py — the
map-sharded step (D = 2, ``_tiny_cfg``'s 512 points, 2 scans) and a
checkpoint saved from both processes and restored onto both.  Held to the
in-process backend in this process on the same batches: the positions
and the received bytes equal, and the gloo-written checkpoint restores on
the in-process mesh and continues bit for bit as the workers did.

The JAX package's twin (tests/test_distributed.py) is marked slow; this
one runs in the suite.  The workers get 240 s (``TIMEOUT``; the case takes
a few seconds), after which they are killed and the test fails, so a hung
rendezvous cannot hold up the run."""

import json

import numpy as np
import pytest
import torch

from fast_limo_tpu_torch import entry
from fast_limo_tpu_torch.parallel import collectives, distributed, sharded

from test_torch_sequence import one_thread  # noqa: F401 (fixture)

TIMEOUT = 240.0
SCANS = 2
D = 2


def _leaves(node):
    if isinstance(node, tuple):
        return [x for n in node for x in _leaves(n)]
    return [node]


def test_two_processes_match_the_in_process_backend(tmp_path, one_thread):  # noqa: F811
    out, ck = str(tmp_path / "w.npz"), str(tmp_path / "ckpt.npz")
    logs = entry.run_workers(D, out, scans=SCANS, checkpoint=ck, timeout=TIMEOUT)
    assert all("roundtrip_ok=True" in log for log in logs), logs
    w = np.load(out)
    assert bool(w["roundtrip_ok"]) and int(w["n_processes"]) == D

    cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=D)
    mesh = sharded.make_mesh(D)
    step, state = sharded.build_sharded_scan_step(cfg, mesh, "cpu")
    pos = []
    for i in range(SCANS):
        state, o = step(state, entry._example_batch(cfg, seed=i, device="cpu"))
        pos.append(o.pos.numpy())
    np.testing.assert_array_equal(np.stack(pos), w["positions"])
    assert json.loads(str(w["received"])) == mesh.received(0)

    # the checkpoint the two processes wrote: the in-process global state
    restored = distributed.load_checkpoint(ck, sharded.init_global_state(cfg, D, "cpu"), mesh)
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert torch.equal(a, b)
    s2, o2 = step(restored, entry._example_batch(cfg, seed=999, device="cpu"))
    np.testing.assert_array_equal(o2.pos.numpy(), w["final_pos"])
    assert int(s2.map.num_points) == int(w["num_points"])


def test_a_process_spanning_mesh_has_one_axis():
    """Over torch.distributed the mesh is one 'map' axis of one rank a
    process; a 2-D mesh runs in-process only."""
    with pytest.raises(ValueError, match="one axis"):
        collectives.DistComm({"map": 2, "data": 2})
