"""Input validation (a copy of fast_limo_tpu/utils/validation.py, which
the port cannot import: it would import JAX) — counterpart of
`debug_limo::checkPointcloudStructure` (ROSutils.hpp:152-210), which
fatal-errors on clouds whose fields don't match the configured sensor
type.  Here we validate the raw arrays fed to the
Localizer: shapes, dtypes, and that the per-point time field is plausible
for the configured sensor's time convention.
"""

from __future__ import annotations

import numpy as np

from fast_limo_tpu_torch.models import preprocess


class PointcloudStructureError(ValueError):
    pass


def check_pointcloud(points, t_raw, sensor_type: int, stamp: float = None) -> None:
    points = np.asarray(points)
    t_raw = np.asarray(t_raw)
    if points.ndim != 2 or points.shape[1] != 3:
        raise PointcloudStructureError(
            f"points must be (N,3), got {points.shape}")
    if t_raw.shape != (points.shape[0],):
        raise PointcloudStructureError(
            f"t_raw must be (N,) matching points, got {t_raw.shape} vs {points.shape}")
    if len(t_raw) == 0:
        return
    finite = t_raw[np.isfinite(t_raw)]
    if len(finite) == 0:
        raise PointcloudStructureError("all point times are non-finite")
    tmin, tmax = float(finite.min()), float(finite.max())

    # plausibility per sensor convention (mirrors the reference's fatal
    # errors for missing/implausible time fields)
    if sensor_type == preprocess.OUSTER:       # relative nanoseconds
        if tmax > 10e9 or tmin < -10e9:
            raise PointcloudStructureError(
                f"OUSTER expects relative nanoseconds; got range [{tmin}, {tmax}]")
    elif sensor_type == preprocess.VELODYNE:   # relative seconds
        if tmax - tmin > 10.0 or abs(tmax) > 1e6:
            raise PointcloudStructureError(
                f"VELODYNE expects relative seconds; got range [{tmin}, {tmax}]")
    elif sensor_type == preprocess.HESAI:      # absolute seconds
        if stamp is not None and len(finite) and abs(tmax - stamp) > 60.0:
            raise PointcloudStructureError(
                f"HESAI expects absolute seconds near the scan stamp "
                f"({stamp}); got max {tmax}")
    elif sensor_type == preprocess.LIVOX:      # absolute nanoseconds
        if stamp is not None and abs(tmax * 1e-9 - stamp) > 60.0:
            raise PointcloudStructureError(
                f"LIVOX expects absolute nanoseconds near the scan stamp; "
                f"got max {tmax}")
    else:
        raise PointcloudStructureError(
            f"unknown sensor type {sensor_type} "
            "(0=OUSTER 1=VELODYNE 2=HESAI 3=LIVOX)")


def check_imu(acc, gyro) -> None:
    acc = np.asarray(acc)
    gyro = np.asarray(gyro)
    if acc.shape != (3,) or gyro.shape != (3,):
        raise ValueError(f"IMU samples must be (3,) accel/gyro, got {acc.shape}/{gyro.shape}")
    if not (np.all(np.isfinite(acc)) and np.all(np.isfinite(gyro))):
        raise ValueError("non-finite IMU sample")
