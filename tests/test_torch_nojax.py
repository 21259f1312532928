"""fast_limo_tpu_torch never imports JAX nor the JAX package: a fresh
interpreter in which importing either raises imports the port, runs two tiny CPU scan steps through the
Localizer at the bench's int16 transfer (the native packer), the same
scans chunked (C = 2, flushed) and through AsyncIngest, renders the
board, queries the map (K7's plain version), sorts with K9's plain
version, writes and reads a checkpoint, runs the SLAM engine with GPS
priors, a pose-graph optimisation, a session round trip, the gain through
its wrapper and the CLI, the data readers (the native KITTI parser and
filter chain, a generic sequence exported by ``make-synthetic`` and run by
``sequence``, the packet slicer), one tick of the multi-session step,
the ``entry()`` twin, the multi-device layer (a 2 × 2 in-process sharded
step, its checkpoint round trip, an edge-sharded pose graph; the
process worker imported), and JAX is still absent from sys.modules.
``chip_smoke.py`` imports none of it either, and without a card it exits 2
and prints no result."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import os
import sys
import tempfile


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "fast_limo_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Block())
import numpy as np
import torch
from fast_limo_tpu_torch.io import native, synthetic
from fast_limo_tpu_torch.io.stream import AsyncIngest
from fast_limo_tpu_torch.models import mapper
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.ops import knn, sort
from fast_limo_tpu_torch.utils import checkpoint, presets, telemetry, validation

cfg = presets.kitti_like_cfg()
cfg.tpu.max_points_per_scan = 256
cfg.tpu.map_capacity = 1024
cfg.tpu.imu_batch = 16
cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 128
cfg.tpu.max_insert_points = 128
seq = presets.bench_sequence(n_scans=2, points_per_scan=256)
loc = Localizer(cfg, device="cpu")
presets.replay(loc, seq)
assert loc.positions().shape == (2, 3) and np.isfinite(loc.positions()).all()
assert cfg.tpu.quantize_transfer > 0 and native.get_lib() is not None
cfg.tpu.scan_chunk = 2
chunked = Localizer(cfg, device="cpu")
presets.replay(chunked, seq)
chunked.flush()
assert np.array_equal(chunked.positions(), loc.positions())
fed = Localizer(cfg, device="cpu")
with AsyncIngest(fed) as ingest:
    presets.replay(ingest, seq)
    ingest.flush()
assert np.array_equal(fed.positions(), loc.positions())
assert "Map points" in loc.board() and telemetry.Telemetry().stats()["enqueue_scans_per_s"] == 0.0
k = torch.tensor([2, 0, 1], dtype=torch.int32)
assert sort.sort3(k, k, k)[0].tolist() == [0, 1, 2] and sort.sort3.launches == 0
q = torch.tensor(checkpoint.map_points(loc.state.map)[:16])
_, sq, valid = mapper.radius_search(loc.state.map, q, 3.0, voxel_size=cfg.map_voxel_size)
assert valid[:, 0].all() and knn.masked_topk.launches == 0
path = os.path.join(tempfile.mkdtemp(), "ck.npz")
loc.save_checkpoint(path)
again = Localizer(cfg, device="cpu")
again.load_checkpoint(path)
assert torch.equal(again.state.map.table, loc.state.map.table)
from fast_limo_tpu_torch import cli
from fast_limo_tpu_torch.models import icp, posegraph, relocalize, scancontext, slam
from fast_limo_tpu_torch.ops import gain, geometry, se3
from fast_limo_tpu_torch.utils import evaluation, interop

cfg.tpu.scan_chunk = 1
cfg.debug = True
eng = slam.SLAM(cfg, slam.LoopConfig(kf_dist=0.2, gps_optimize_every=1), device="cpu")
for stamp in seq.imu_stream()[0]:            # buffered until keyframes bracket them
    eng.update_gps(stamp, seq.traj.pos(np.asarray([stamp]))[0])
presets.replay(eng, seq)
eng.flush()
assert len(eng.keyframes) == 2 and eng.gps_factors and eng.loc.last_output.debug is not None
prefix = os.path.join(tempfile.mkdtemp(), "session")
eng.save_session(prefix)
fresh = slam.SLAM(cfg, device="cpu")
fresh.load_session(prefix)
assert len(fresh.keyframes) == 2
g = posegraph.from_arrays([[1, 0, 0, 0]] * 3, [[0, 0, 0], [1, 0, 0], [2.2, 0, 0]], [0, 1], [1, 2],
                          [[1, 0, 0, 0]] * 2, [[1, 0, 0]] * 2, [1.0, 1.0], device="cpu")
g2, costs = posegraph.optimize(g, iters=3)
assert float(costs[-1]) < 1e-6 and abs(float(g2.trans[2, 0]) - 2.0) < 1e-3
K = gain.gain(torch.eye(12), torch.ones(12), torch.eye(23), 1e-3)
assert K[0].shape == (23, 12) and gain.gain.launches == 0
assert cli.main(["--device", "cpu", "--no-loop", "synthetic", "--scans", "2"]) is None
from fast_limo_tpu_torch import entry
from fast_limo_tpu_torch.io import generic, kitti, packets
from fast_limo_tpu_torch.parallel import batched

d = tempfile.mkdtemp()
assert cli.main(["--device", "cpu", "make-synthetic", "--dir", os.path.join(d, "s"),
                 "--scans", "3", "--points", "1024"]) is None
tum = os.path.join(d, "s.tum")
assert cli.main(["sequence", "--data", os.path.join(d, "s"), "--device", "cpu",
                 "--out", tum]) is None
assert np.loadtxt(tum).shape == (3, 8)
bin_path = os.path.join(d, "scan.bin")
np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32).tofile(bin_path)
xyz, _i, t = native.parse_kitti_bin(bin_path)
assert native.preprocess(xyz, t, 128)[3] == 64 and kitti.KittiDrive.scan
assert len(list(packets.PacketSlicer(4).packets(xyz, t, 0.0))) == 4
_step, (_s, b1) = entry.entry(device="cpu")
tiny = entry._tiny_cfg()
fleet = batched.build_batched_scan_step(tiny, "cpu")
_st, outs = fleet(batched.init_batched_state(tiny, 2, "cpu"), batched.stack_batches([b1, b1]),
                  torch.tensor([True, False]))
assert torch.isfinite(outs.pos).all() and generic.HESAI == 2
from fast_limo_tpu_torch.models import posegraph
from fast_limo_tpu_torch.parallel import _dist_worker, collectives, distributed, sharded
mesh = sharded.make_mesh_2d(2, 2)
cfg2 = entry._tiny_cfg(n_pts=128, map_cap=256, n_shards=2)
sstep, sstate = sharded.build_sharded_scan_step(cfg2, mesh, "cpu")
sstate, sout = sstep(sstate, entry._example_batch(cfg2, device="cpu"))
assert torch.isfinite(sout.pos).all() and mesh.received(0)["knn_allgather_bytes"] > 0
with tempfile.TemporaryDirectory() as td:
    distributed.save_checkpoint(os.path.join(td, "s.npz"), sstate, mesh)
    back = distributed.load_checkpoint(os.path.join(td, "s.npz"),
                                       sharded.init_global_state(cfg2, 2, "cpu"), mesh)
assert torch.equal(back.map.table, sstate.map.table)
pgraph = posegraph.create(4, 4, device="cpu")
for k in range(3):
    pgraph = posegraph.add_node(pgraph, torch.tensor([1.0, 0, 0, 0]), torch.tensor([k, 0.0, 0]))
pgraph, pcost = posegraph.optimize_distributed(pgraph, sharded.make_mesh(2), iters=2)
assert torch.isfinite(pcost).all() and callable(_dist_worker.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "fast_limo_tpu" or m.startswith("fast_limo_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"     # small ops; the suite's workers share the cores
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "LEAKED []" in res.stdout


def test_no_jax_imports_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fast_limo_tpu)(\.|\s|$)", re.M)
    srcs = list((REPO / "fast_limo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(p) for p in srcs if pat.search(p.read_text())]
    assert not hits, hits


def test_chip_smoke_needs_a_card():
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and '"ok"' not in res.stdout and "kernels" not in res.stdout
