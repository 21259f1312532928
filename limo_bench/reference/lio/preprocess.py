"""Scan & IMU preprocessing as fixed-shape masked tensor ops (port of
fast_limo_tpu/models/preprocess.py; reference Localizer.cpp:262-321,
696-805)."""

from __future__ import annotations

import math

import torch

from reference.lio import so3

# SensorType enum (Common.hpp:82)
OUSTER, VELODYNE, HESAI, LIVOX = 0, 1, 2, 3

# crop boxes, uploaded once per (box, dtype, device): an upload from a host
# list on every scan would block the host
_BOXES = {}


def _crop_box(crop_min, crop_max, dtype, device):
    key = (tuple(float(v) for v in crop_min), tuple(float(v) for v in crop_max), dtype,
           torch.device(device))
    box = _BOXES.get(key)
    if box is None:
        box = torch.tensor([key[0], key[1]], dtype=dtype, device=device)
        _BOXES[key] = box
    return box


def extract_point_times(t_raw, sweep_ref_time, sensor_type: int, end_of_sweep: bool):
    """Absolute per-point seconds (Localizer.cpp:747-783); works on numpy
    arrays and tensors alike."""
    if sensor_type == OUSTER:
        rel = t_raw * 1e-9
        return sweep_ref_time - rel if end_of_sweep else sweep_ref_time + rel
    if sensor_type == VELODYNE:
        return sweep_ref_time - t_raw if end_of_sweep else sweep_ref_time + t_raw
    if sensor_type == HESAI:
        return t_raw
    if sensor_type == LIVOX:
        return t_raw * 1e-9
    raise ValueError(f"unknown sensor type {sensor_type}")


def preprocess_scan(points, t_raw, valid, scan_stamp, imu_stamp, *,
                    sensor_type: int, end_of_sweep: bool,
                    crop_active: bool, crop_min, crop_max,
                    dist_active: bool, min_dist: float,
                    rate_active: bool, rate_value: int,
                    fov_active: bool, fov_angle: float,
                    time_offset: bool, time_sort: bool = True):
    """Filter (+ optionally time-sort) a raw scan → (points (N,3), t_abs (N,)
    with offset applied and +inf on invalid points, valid (N,), scan_end ())."""
    N = points.shape[0]
    dev = points.device
    valid = valid & torch.all(torch.isfinite(points), dim=-1)
    if crop_active:   # negative crop: REMOVE points inside the box
        lo, hi = _crop_box(crop_min, crop_max, points.dtype, dev)
        valid = valid & ~torch.all((points >= lo) & (points <= hi), dim=-1)
    if dist_active:
        valid = valid & (torch.linalg.norm(points, dim=-1) > min_dist)
    if rate_active:
        valid = valid & (torch.arange(N, device=dev) % rate_value == 0)
    if fov_active:
        valid = valid & (torch.abs(torch.atan2(points[:, 1], points[:, 0])) < fov_angle)

    t_abs = extract_point_times(t_raw, scan_stamp, sensor_type, end_of_sweep)
    inf = torch.full_like(t_abs, math.inf)
    if time_sort:
        order = torch.argsort(torch.where(valid, t_abs, inf), stable=True)
        points_s, t_s, valid_s = points[order], t_abs[order], valid[order]
        n_valid = torch.sum(valid_s)
        last_t = torch.where(n_valid > 0, t_s.index_select(0, torch.clamp(n_valid - 1, min=0).reshape(1))[0],
                             scan_stamp)
    else:
        points_s, t_s, valid_s = points, t_abs, valid
        n_valid = torch.sum(valid_s)
        last_t = torch.where(n_valid > 0, torch.max(torch.where(valid_s, t_s, -inf)),
                             scan_stamp)

    if time_offset:   # automatic IMU/LiDAR sync offset, clamped ≤ 0
        offset = torch.clamp(imu_stamp - last_t - 1e-4, max=0.0)
    else:
        offset = torch.zeros((), dtype=t_s.dtype, device=dev)
    scan_end = last_t + offset
    return points_s, torch.where(valid_s, t_s + offset, inf), valid_s, scan_end


def imu_to_baselink(acc, gyro, stamp, prev_stamp, prev_w_bl, *, R_imu2bl, t_imu2bl):
    """Batched IMU→baselink transform with lever-arm terms
    (Localizer.cpp:696-731) → (acc_bl (K,3), gyro_bl (K,3), dt (K,))."""
    dt = stamp - torch.cat([prev_stamp[None], stamp[:-1]])
    dt = torch.where((dt <= 0.0) | (dt > 0.1), torch.full_like(dt, 1.0 / 200.0), dt)
    w_bl = gyro @ R_imu2bl.T
    w_prev = torch.cat([prev_w_bl[None], w_bl[:-1]], dim=0)
    a_bl = acc @ R_imu2bl.T
    lever = (-t_imu2bl).expand(a_bl.shape)
    a_bl = (a_bl + so3.cross((w_bl - w_prev) / dt[:, None], lever)
            + so3.cross(w_bl, so3.cross(w_bl, lever)))
    return a_bl, w_bl, dt


def apply_intrinsics(acc, gyro, sm, accel_bias, gyro_bias):
    """Static calibration correction (Localizer.cpp:513-518): sm·a − ba, ω − bg."""
    return acc @ sm.T - accel_bias, gyro - gyro_bias
