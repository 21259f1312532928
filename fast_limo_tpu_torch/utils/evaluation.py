"""Trajectory evaluation & export: ATE / RPE, TUM-format IO.

The reference validates by eyeballing rviz (SURVEY.md §4); here we measure.
"""

from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray):
    """Rigid (no-scale) alignment est→gt; returns (R, t)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions)."""
    est = np.atleast_2d(np.asarray(est, dtype=np.float64))
    gt = np.atleast_2d(np.asarray(gt, dtype=np.float64))
    if est.size == 0 or gt.size == 0:
        return float("nan")
    if align and len(est) >= 3:
        R, t = umeyama_align(est, gt)
        est = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 10) -> dict:
    """Relative pose error over a fixed frame delta (translation only).

    Returns {"rmse", "mean", "max"} of per-interval translation drift.
    """
    n = min(len(est), len(gt)) - delta
    if n <= 0:
        return {"rmse": 0.0, "mean": 0.0, "max": 0.0}
    d_est = est[delta:delta + n] - est[:n]
    d_gt = gt[delta:delta + n] - gt[:n]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))),
            "mean": float(np.mean(err)), "max": float(np.max(err))}


def save_tum(path: str, stamps, positions, quats_wxyz) -> None:
    """TUM trajectory format: `t x y z qx qy qz qw` per line (evo-compatible)."""
    with open(path, "w") as f:
        for t, p, q in zip(stamps, positions, quats_wxyz):
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_tum(path: str):
    """Returns (stamps (n,), positions (n,3), quats_wxyz (n,4))."""
    rows = np.loadtxt(path).reshape(-1, 8)
    stamps = rows[:, 0]
    pos = rows[:, 1:4]
    q_xyzw = rows[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    return stamps, pos, q_wxyz
