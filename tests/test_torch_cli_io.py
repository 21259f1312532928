"""The port CLI's data subcommands on the CPU (``--device cpu``):
``make-synthetic`` → ``sequence`` under a small HESAI profile with a
standstill calibration, its TUM held to the JAX CLI's on the same directory
(1e-3 m, tests/test_torch_pipeline.py:156-157's tolerance); ``--async``
bit-equal to the synchronous run (tests/test_cli.py:39-48); ``kitti`` on
the fixture of tests/test_kitti.py; the shared options accepted before and
after each subcommand; and, without a card, every subcommand raises
unless ``--device cpu`` is given."""

import json

import numpy as np
import pytest
import torch

from fast_limo_tpu import cli as jcli
from fast_limo_tpu_torch import cli

from test_kitti import make_drive
from test_torch_sequence import one_thread  # noqa: F401 (fixture)

PROFILE = """
sensor_type: 2
debug: false
verbose: false
estimate_extrinsics: false
time_offset: false
end_of_sweep: false
calibration: { gravity_align: true, accel: true, gyro: true, time: 1.0 }
filters:
  cropBox: { active: true, box: { min: [-1.0, -1.0, -1.0], max: [1.0, 1.0, 1.0] } }
  voxelGrid: { active: true, leafSize: [0.5, 0.5, 0.5] }
  minDistance: { active: true, value: 1.5 }
  FoV: { active: false, value: 360 }
  rateSampling: { active: false, value: 1 }
iKFoM:
  MAX_NUM_ITERS: 3
  MAX_NUM_MATCHES: 2048
  MAX_NUM_PC2MATCH: 2048
  Mapping: { NUM_MATCH_POINTS: 5, MAX_DIST_PLANE: 2.0, PLANES_THRESHOLD: 5.0e-2,
             Octree: { min_extent: 0.25 } }
tpu:
  max_points_per_scan: 2048
  map_capacity: 16384
  map_points_per_voxel: 2
  imu_batch: 32
"""
N_SCANS = 5


def _json(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    yaml = d / "hesai.yaml"
    yaml.write_text(PROFILE)
    data = str(d / "seq")
    assert cli.main(["--device", "cpu", "make-synthetic", "--dir", data, "--scans",
                     str(N_SCANS), "--points", "2048", "--sensor-type", "2",
                     "--standstill", "1.0", "--seed", "3"]) is None
    return d, str(yaml), data


def test_make_synthetic_then_sequence_matches_jax(exported, capsys):
    d, yaml, data = exported
    capsys.readouterr()
    out, jout = str(d / "port.tum"), str(d / "jax.tum")
    # shared options before and after the subcommand
    assert cli.main(["--out", out, "sequence", "--data", data, "--config", yaml,
                     "--device", "cpu"]) is None
    info = _json(capsys.readouterr().out)
    assert info == {"scans": N_SCANS, "loops": 0}
    jcli.main(["--platform", "cpu", "sequence", "--data", data, "--config", yaml,
               "--out", jout])
    assert _json(capsys.readouterr().out)["scans"] == N_SCANS
    got, want = np.loadtxt(out), np.loadtxt(jout)
    assert got.shape == want.shape == (N_SCANS, 8)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0, atol=1e-3)
    assert np.isfinite(got).all()


def test_sequence_async_matches_sync(exported):
    d, yaml, data = exported
    out_s, out_a = str(d / "sync.tum"), str(d / "async.tum")
    cli.main(["--device", "cpu", "sequence", "--data", data, "--config", yaml,
              "--no-loop", "--out", out_s])
    cli.main(["sequence", "--async", "--data", data, "--config", yaml, "--no-loop",
              "--out", out_a, "--device", "cpu"])
    s, a = np.loadtxt(out_s), np.loadtxt(out_a)
    assert s.shape == a.shape == (N_SCANS, 8)
    np.testing.assert_array_equal(a, s)


def test_kitti_runs_the_fixture(tmp_path, capsys):
    drive = make_drive(tmp_path, n_scans=3, n_imu=40)
    yaml = tmp_path / "kitti.yaml"
    yaml.write_text(PROFILE.replace("sensor_type: 2", "sensor_type: 1")
                    .replace("gravity_align: true, accel: true, gyro: true",
                             "gravity_align: false, accel: false, gyro: false"))
    out = str(tmp_path / "kitti.tum")
    assert cli.main(["kitti", "--drive", drive, "--config", str(yaml), "--device", "cpu",
                     "--out", out]) is None
    assert _json(capsys.readouterr().out)["scans"] == 3
    rows = np.loadtxt(out)
    assert rows.shape == (3, 8) and np.isfinite(rows).all()


@pytest.mark.parametrize("argv", [
    ["make-synthetic", "--dir", "{d}/s", "--scans", "2"],
    ["sequence", "--data", "{d}/s"],
    ["kitti", "--drive", "{d}/drive"],
])
def test_subcommands_need_a_card_without_device_cpu(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([a.format(d=tmp_path) for a in argv])
