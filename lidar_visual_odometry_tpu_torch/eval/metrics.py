"""Trajectory evaluation: ATE and KITTI-style relative errors.

The port's own copy of ``lidar_visual_odometry_tpu/eval/metrics.py`` (numpy and
dataclasses only): the port imports nothing from the JAX package, so it
keeps this file verbatim to read the same defaults and scenes.

The reference publishes no quantitative evaluation (SURVEY.md §6); it only
plots paths in rviz next to kittiHelper's ground truth. This module supplies
the missing harness: absolute trajectory error after rigid (Umeyama, scale=1)
alignment, and KITTI odometry relative translational/rotational error averaged
over fixed path lengths.
"""

from __future__ import annotations

import numpy as np


def rigid_align(est: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Umeyama alignment (no scale): R, t minimizing Σ|R·est + t − gt|²."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = (U @ S @ Vt).T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """RMSE of translational ATE over the trajectory (m)."""
    est = np.asarray(est_xyz, dtype=np.float64)
    gt = np.asarray(gt_xyz, dtype=np.float64)
    assert est.shape == gt.shape
    if align:
        R, t = rigid_align(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def _traj_distances(gt_xyz: np.ndarray) -> np.ndarray:
    steps = np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def kitti_relative_errors(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    lengths=(100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
    step: int = 10,
) -> tuple[float, float]:
    """KITTI odometry protocol: average t_rel (%) and r_rel (deg/100m) over
    all sub-trajectories of the given path lengths.

    est_poses, gt_poses: (N, 4, 4) homogeneous world poses.
    """
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    dist = _traj_distances(gt[:, :3, 3])

    t_errs, r_errs = [], []
    for first in range(0, len(gt), step):
        for L in lengths:
            target = dist[first] + L
            last = int(np.searchsorted(dist, target))
            if last >= len(gt):
                continue
            dgt = np.linalg.inv(gt[first]) @ gt[last]
            dest = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(dgt) @ dest
            t_errs.append(np.linalg.norm(err[:3, 3]) / L)
            ang = np.arccos(
                np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            )
            r_errs.append(ang / L)
    if not t_errs:
        return float("nan"), float("nan")
    return (
        100.0 * float(np.mean(t_errs)),                   # %
        float(np.degrees(np.mean(r_errs)) * 100.0),       # deg / 100 m
    )


def poses_to_matrices(qs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(N,4) wxyz quats + (N,3) → (N,4,4)."""
    import numpy as np

    N = qs.shape[0]
    out = np.tile(np.eye(4), (N, 1, 1))
    w, x, y, z = qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3]
    out[:, 0, 0] = 1 - 2 * (y * y + z * z)
    out[:, 0, 1] = 2 * (x * y - w * z)
    out[:, 0, 2] = 2 * (x * z + w * y)
    out[:, 1, 0] = 2 * (x * y + w * z)
    out[:, 1, 1] = 1 - 2 * (x * x + z * z)
    out[:, 1, 2] = 2 * (y * z - w * x)
    out[:, 2, 0] = 2 * (x * z - w * y)
    out[:, 2, 1] = 2 * (y * z + w * x)
    out[:, 2, 2] = 1 - 2 * (x * x + y * y)
    out[:, :3, 3] = ts
    return out
