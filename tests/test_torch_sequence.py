"""The generic sequence layout end to end on the port (twins of
tests/test_generic_io.py:58-160): every profile config runs an exported
sequence, the HESAI profile with its standstill calibration agrees with the
JAX SLAM on the same directory, absolute epoch-scale stamps give the same
trajectory as stamps near zero through both transfers, the standstill
calibration finds the synthetic IMU's zero biases, and GPS fixes reach
SLAM's factors.

Tolerances: the HESAI run against the JAX package holds stamps to 1e-9 s
and positions to 1e-3 m (tests/test_torch_pipeline.py:156-157); the epoch
test keeps tests/test_generic_io.py's (3e-5 on the first two scans, 5e-3
after: f64 stamp rounding at 1.7e9 s feeds back through the filter).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fast_limo_tpu.models.slam import SLAM as JSLAM
from fast_limo_tpu.utils.config import Config as JConfig
from fast_limo_tpu_torch.io import generic, synthetic
from fast_limo_tpu_torch.models.localizer import Localizer
from fast_limo_tpu_torch.models.slam import SLAM, LoopConfig
from fast_limo_tpu_torch.utils.config import Config

from test_pipeline import small_cfg

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's plain versions while this module
    runs: its small tensor ops gain nothing from more, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(src) -> Config:
    """A JAX-package Config copied field by field into the port's."""
    out = Config()
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        setattr(out, f.name, dataclasses.replace(v) if dataclasses.is_dataclass(v) else v)
    return out


def small_synth(n=4, pts=4096):
    return synthetic.SyntheticSequence(
        seed=6, n_scans=n, points_per_scan=pts,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3)


def shrink(cfg):
    """tests/test_generic_io.py:70-78's CPU shapes (calibration left as is)."""
    cfg.tpu.max_points_per_scan = 4096
    cfg.tpu.map_capacity = 2 ** 15
    cfg.tpu.imu_batch = 32
    cfg.filters.rate_active = False      # keep ≥1k points at 4096 test pads
    return cfg


@pytest.mark.parametrize("profile,sensor", [
    ("kitti_tpu.yaml", 1), ("utbm_tpu.yaml", 1),
    ("cat_tpu.yaml", 1), ("ona_tpu.yaml", 2)])
def test_profile_configs_run_end_to_end(tmp_path, profile, sensor):
    cfg = shrink(Config.from_yaml(os.path.join(CONFIG_DIR, profile)))
    assert cfg.sensor_type == sensor
    cfg.gravity_align = cfg.calibrate_accel = cfg.calibrate_gyro = False
    cfg.intrinsics.accel_bias = [0.0] * 3
    cfg.intrinsics.gyro_bias = [0.0] * 3
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, small_synth(), cfg.sensor_type, n_scans=3,
                             end_of_sweep=cfg.end_of_sweep)
    slam = SLAM(cfg, enable_loop_closure=False, device="cpu")
    generic.run_sequence(slam, generic.GenericSequence(root))
    traj = slam.trajectory
    assert len(traj) == 3
    assert all(np.isfinite(t["pos"]).all() for t in traj)
    assert np.linalg.norm(traj[-1]["pos"] - traj[0]["pos"]) > 0.2


def test_hesai_profile_with_calibration_matches_jax(tmp_path):
    """configs/ona_tpu.yaml (HESAI absolute seconds, gravity alignment and
    bias calibration over 3 s) on an export with a 3 s standstill: both
    engines calibrate, fold the post-calibration backlog into the first
    scan, and agree scan by scan."""
    path = os.path.join(CONFIG_DIR, "ona_tpu.yaml")
    cfg, jcfg = shrink(Config.from_yaml(path)), shrink(JConfig.from_yaml(path))
    assert cfg.gravity_align and cfg.calibrate_accel and cfg.calibrate_gyro
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, small_synth(n=5), generic.HESAI, standstill=3.0)
    slam = SLAM(cfg, enable_loop_closure=False, device="cpu")
    jslam = JSLAM(jcfg, enable_loop_closure=False)
    generic.run_sequence(slam, generic.GenericSequence(root))
    generic.run_sequence(jslam, generic.GenericSequence(root))
    assert slam.loc.imu_calibrated and jslam.loc.imu_calibrated
    np.testing.assert_allclose(slam.loc.init_bg, jslam.loc.init_bg, rtol=0, atol=1e-12)
    np.testing.assert_allclose(slam.loc.init_ba, jslam.loc.init_ba, rtol=0, atol=1e-12)
    assert len(slam.trajectory) == len(jslam.trajectory) == 5
    np.testing.assert_allclose(slam.stamps(), jslam.stamps(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(slam.positions(), jslam.positions(), rtol=0, atol=1e-3)
    seq = small_synth(n=5)
    ate = synthetic.ate_rmse(slam.positions(), seq.traj.pos(slam.stamps() - 3.0))
    assert ate < 0.15, ate


@pytest.mark.parametrize("quant", [0.0, 0.004], ids=["float32", "int16"])
def test_hesai_epoch_scale_stamps_time_shift_invariant(quant):
    """Absolute per-point seconds at epoch scale (~1.7e9 s) give the same
    trajectory as the same data near t = 0: the host rebases t_raw to the
    scan epoch in f64 before the f32 cast (and, in int16, before the pack
    at the scan's own time LSB)."""
    EPOCH = 1.7e9
    seq = small_synth(n=4)
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(4)]

    def run(shift):
        cfg = port_cfg(small_cfg())
        cfg.sensor_type = 2
        cfg.tpu.quantize_transfer = quant
        loc = Localizer(cfg, device="cpu")
        si = 0
        for k in range(len(stamps)):
            loc.update_imu(stamps[k] + shift, acc[k], gyro[k])
            while si < 4 and scans[si][0] <= stamps[k]:
                st, pts, t_rel = scans[si]
                t_raw = generic.to_sensor_time(t_rel.astype(np.float64), st + shift, 2)
                loc.update_pointcloud(pts, t_raw, st + shift)
                si += 1
        return loc

    la, lb = run(0.0), run(EPOCH)
    assert len(la.trajectory) == len(lb.trajectory) == 4
    for k, (ta, tb) in enumerate(zip(la.trajectory, lb.trajectory)):
        atol = 3e-5 if k < 2 else 5e-3
        np.testing.assert_allclose(ta["pos"], tb["pos"], atol=atol)
        np.testing.assert_allclose(ta["quat"], tb["quat"], atol=atol)
        assert tb["stamp"] - ta["stamp"] == pytest.approx(EPOCH)


def test_standstill_calibration_export(tmp_path):
    cfg = port_cfg(small_cfg())
    cfg.gravity_align = cfg.calibrate_accel = cfg.calibrate_gyro = True
    cfg.imu_calib_time = 1.0
    cfg.tpu.imu_batch = 128   # post-calibration backlog lands in scan 0
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, small_synth(), 1, n_scans=3, standstill=1.5)
    loc = Localizer(cfg, device="cpu")
    generic.run_sequence(loc, generic.GenericSequence(root))
    assert loc.imu_calibrated
    assert len(loc.trajectory) == 3
    # calibrated biases ≈ 0 (the synthetic IMU is bias-free)
    assert np.linalg.norm(loc.init_bg) < 5e-3
    assert np.linalg.norm(loc.init_ba) < 5e-2


def test_gps_factors_flow_into_slam(tmp_path):
    root = str(tmp_path / "seq")
    generic.export_synthetic(root, small_synth(), 1, n_scans=4, gps_every=1, gps_noise=0.05)
    g = generic.GenericSequence(root)
    assert len(g.gps_stamps) == 4
    slam = SLAM(port_cfg(small_cfg()), loop_cfg=LoopConfig(kf_dist=0.1, kf_angle=0.01),
                device="cpu")
    generic.run_sequence(slam, g)
    assert len(slam.trajectory) == 4
    assert len(slam.gps_factors) >= 2   # fixes attached to keyframes
