"""Sensor stream alignment (≡ CamLidarProcess::prepare_cam_lidar +
adjustPointCloud).

The port's own copy of ``lidar_visual_odometry_tpu/data/sync.py`` (numpy
only): the port imports nothing from the JAX package.

Host-side utilities pairing asynchronous sensor streams:

* ``match_nearest``: nearest image for each lidar stamp within a tolerance
  (0.227 s in the reference, ``src/vloam/CamLidarProcess.cpp:73-169``).
* ``bundle_imu``: all IMU samples in (t_prev, t_cur] per lidar frame — the
  VINS-style ``getMeasurements`` (``src/adjustPointCloud.cpp:144-204``).
* ``derotate_cloud``: remove roll/pitch using an IMU orientation
  (``src/adjustPointCloud.cpp:224-247``).
"""

from __future__ import annotations

import numpy as np


CAM_LIDAR_TOLERANCE_S = 0.227  # CamLidarProcess.cpp:118


def match_nearest(
    lidar_stamps: np.ndarray,
    image_stamps: np.ndarray,
    tol: float = CAM_LIDAR_TOLERANCE_S,
) -> np.ndarray:
    """Index of the nearest image per lidar stamp, −1 if outside tol."""
    lidar_stamps = np.asarray(lidar_stamps)
    image_stamps = np.asarray(image_stamps)
    pos = np.searchsorted(image_stamps, lidar_stamps)
    pos = np.clip(pos, 0, len(image_stamps) - 1)
    prev = np.clip(pos - 1, 0, len(image_stamps) - 1)
    d_pos = np.abs(image_stamps[pos] - lidar_stamps)
    d_prev = np.abs(image_stamps[prev] - lidar_stamps)
    best = np.where(d_prev <= d_pos, prev, pos)
    dist = np.minimum(d_prev, d_pos)
    return np.where(dist <= tol, best, -1)


def bundle_imu(
    lidar_stamps: np.ndarray, imu_stamps: np.ndarray
) -> list[np.ndarray]:
    """Per lidar frame k: indices of IMU samples in (stamp[k-1], stamp[k]]."""
    out = []
    prev = -np.inf
    for t in np.asarray(lidar_stamps):
        sel = np.nonzero((imu_stamps > prev) & (imu_stamps <= t))[0]
        out.append(sel)
        prev = t
    return out


def derotate_cloud(points: np.ndarray, q_wxyz: np.ndarray) -> np.ndarray:
    """Rotate a cloud so gravity-referenced roll/pitch vanish: keep yaw only
    (adjustPointCloud.cpp:224-247)."""
    w, x, y, z = q_wxyz
    # yaw from quaternion
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    # full rotation
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    # remove roll/pitch: apply R then undo yaw → pts in gravity-aligned frame
    return points @ (R_yaw.T @ R).T
