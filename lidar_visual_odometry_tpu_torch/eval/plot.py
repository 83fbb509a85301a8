"""Trajectory plots (≡ the rviz path displays, headless), a copy of
``lidar_visual_odometry_tpu/eval/plot.py``.

The reference checks runs by watching `nav_msgs::Path` topics in rviz; this
renders the same comparison to a PNG: the estimated and ground-truth paths
from above and the error a frame. matplotlib is imported on the first call,
so the module imports without it.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(
    est_xyz: np.ndarray,
    gt_xyz: np.ndarray | None = None,
    out_path: str = "trajectory.png",
    title: str = "trajectory",
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.asarray(est_xyz)
    fig, axes = plt.subplots(
        1, 2 if gt_xyz is not None else 1,
        figsize=(12 if gt_xyz is not None else 6, 5),
    )
    ax0 = axes[0] if gt_xyz is not None else axes
    ax0.plot(est[:, 0], est[:, 1], "b-", lw=1.2, label="estimate")
    if gt_xyz is not None:
        gt = np.asarray(gt_xyz)
        ax0.plot(gt[:, 0], gt[:, 1], "k--", lw=1.0, label="ground truth")
    ax0.set_aspect("equal")
    ax0.set_xlabel("x [m]")
    ax0.set_ylabel("y [m]")
    ax0.legend()
    ax0.set_title(title)

    if gt_xyz is not None:
        err = np.linalg.norm(est - np.asarray(gt_xyz), axis=1)
        axes[1].plot(err, "r-", lw=1.0)
        axes[1].set_xlabel("frame")
        axes[1].set_ylabel("position error [m]")
        axes[1].set_title(f"ATE rmse {np.sqrt((err**2).mean()):.3f} m")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
