"""Named configurations of the port.

``kitti_like_cfg`` is exactly the KITTI-HDL64-shaped configuration of the
JAX package's ``bench.py:59-105`` (32768-point scans, 2^17-entry map,
10000 pc2match points, 3 iterations, window W = 12, int16 scan transfer
at a 4 mm LSB, one scan a dispatch), kept here because ``bench.py``
imports JAX.  The bench's chunked replay sets ``tpu.scan_chunk = 4`` on
top of it (``bench.py:397-398``).

``ouster128_cfg``/``ouster128_sequence`` are the same configuration and
corridor for a 128-beam lidar: 262 144 points a sweep, which both K9
sorts of a scan take whole.

``bench_sequence`` is the bench's "benign" synthetic corridor
(``bench.make_seq``); ``soak_sequence``/``soak_loop_cfg`` are the closed
circuit and loop-closure settings of its long-run soak
(``bench.py:227-274``), ``corridor_gps_loop_cfg`` the settings of its GPS
corridor (``bench.py:190-224``).
"""

from __future__ import annotations

from fast_limo_tpu_torch.io import synthetic
from fast_limo_tpu_torch.utils.config import Config


def kitti_like_cfg() -> Config:
    cfg = Config()
    cfg.sensor_type = 1
    cfg.gravity_align = False
    cfg.calibrate_accel = False
    cfg.calibrate_gyro = False
    cfg.time_offset = False
    cfg.debug = cfg.verbose = False
    cfg.intrinsics.accel_bias = [0.0, 0.0, 0.0]
    cfg.intrinsics.gyro_bias = [0.0, 0.0, 0.0]
    cfg.filters.crop_active = True
    cfg.filters.dist_active = True
    cfg.filters.min_dist = 2.0
    cfg.filters.rate_active = False
    cfg.filters.voxel_active = True
    cfg.filters.leafSize = [1.0, 1.0, 1.0]       # kitti.yaml:61
    cfg.ikfom.MAX_NUM_ITERS = 3                  # kitti.yaml:76
    cfg.ikfom.mapping.MAX_NUM_MATCHES = 5000     # kitti.yaml:77
    cfg.ikfom.mapping.MAX_NUM_PC2MATCH = 10000   # kitti.yaml:78
    cfg.ikfom.mapping.octree.min_extent = 0.2    # kitti.yaml:87
    cfg.ikfom.estimate_extrinsics = True
    cfg.tpu.max_points_per_scan = 32768
    cfg.tpu.map_capacity = 2 ** 17
    cfg.tpu.map_voxel_size = 1.2
    cfg.tpu.map_points_per_voxel = 6
    cfg.tpu.imu_batch = 32
    cfg.tpu.hash_probes = 4
    cfg.tpu.insert_probes = 2
    cfg.tpu.knn_refresh = "first"
    cfg.tpu.quantize_transfer = 0.004           # int16 payload, 4 mm LSB
    cfg.tpu.max_insert_points = 10000
    return cfg


def ouster128_cfg() -> Config:
    """``kitti_like_cfg`` for an Ouster OS1-128 in its 2048 × 10 Hz mode
    (Ouster's OS1 datasheet: 128 channels × 2048 columns = 262 144 points a
    sweep).  ``max_insert_points = 0``, the JAX ``Config`` default
    (``fast_limo_tpu/utils/config.py:166``), gives the map insert the
    scan's own width, so the voxel sort and the insert sort both take
    262 144 elements."""
    cfg = kitti_like_cfg()
    cfg.tpu.max_points_per_scan = 128 * 2048
    cfg.tpu.max_insert_points = 0
    return cfg


def ouster128_sequence(seed: int = 7, n_scans: int = 24, points_per_scan: int = 128 * 2048):
    """The bench's benign corridor seen by an Ouster OS1-128 (Ouster's OS1
    datasheet: 128 channels over a 45° vertical field of view, ±22.5°;
    2048 × 10 Hz mode): returns on 128 rings, azimuth-coupled firing times.
    A ring sensor returns only the world points near its beams, and on
    ``build_world``'s default corridor (150 000 ground and 150 000 wall
    points) a sweep holds ~13 700 returns; the same surfaces are sampled
    ``dense`` times as densely, 20× for a full 262 144-point sweep, so that
    a sweep holds ``points_per_scan`` returns."""
    dense = max(1, -(-20 * points_per_scan // (128 * 2048)))
    return synthetic.SyntheticSequence(
        seed=seed, n_scans=n_scans, points_per_scan=points_per_scan,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5),
        world=synthetic.build_world(seed, n_wall_pts=150_000 * dense,
                                    n_ground_pts=150_000 * dense),
        ring_beams=128, beam_fov=(-0.3927, 0.3927))


def bench_sequence(seed: int = 7, n_scans: int = 24, points_per_scan: int = 32768):
    """The bench's benign corridor: 15 m/s forward, ±0.5 rad yaw weave."""
    return synthetic.SyntheticSequence(
        seed=seed, n_scans=n_scans, points_per_scan=points_per_scan,
        noise_pt=0.01, noise_gyro=5e-4, noise_acc=5e-3,
        traj=synthetic.Trajectory(v_forward=15.0, yaw_amp=0.5))


def soak_sequence(n_scans: int = 192, seed: int = 11):
    """The soak's closed circuit: a 9 m-radius loop at 4 m/s, 16384-point
    scans at 5 Hz, 25 m range (~2.7 laps in 192 scans)."""
    return synthetic.SyntheticSequence(
        seed=seed, n_scans=n_scans, points_per_scan=16384, scan_rate=5.0,
        noise_pt=0.01, noise_gyro=8e-4, noise_acc=8e-3, max_range=25.0,
        traj=synthetic.LoopTrajectory(v_forward=4.0, radius=9.0, ramp_tau=0.8),
        world=synthetic.build_loop_world(seed, radius=9.0))


def soak_loop_cfg():
    from fast_limo_tpu_torch.models.slam import LoopConfig

    return LoopConfig(kf_dist=2.0, exclude_recent=20, sc_dist_thresh=0.28,
                      icp_min_inliers=150, loop_weight=30.0, max_keyframes=64,
                      loop_cooldown=3.0)


def corridor_gps_loop_cfg():
    from fast_limo_tpu_torch.models.slam import LoopConfig

    return LoopConfig(gps_weight=20.0, gps_optimize_every=5)


def replay(loc, seq) -> None:
    """Feed a synthetic sequence through a Localizer or SLAM in arrival order."""
    stamps, acc, gyro = seq.imu_stream()
    scans = [seq.scan(i) for i in range(seq.n_scans)]
    si = 0
    for k in range(len(stamps)):
        loc.update_imu(stamps[k], acc[k], gyro[k])
        while si < len(scans) and scans[si][0] <= stamps[k]:
            loc.update_pointcloud(scans[si][1], scans[si][2], scans[si][0])
            si += 1
