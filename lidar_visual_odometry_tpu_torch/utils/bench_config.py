"""The JAX package's bench configuration of the cam-lidar mode (``bench.py``
``CAM`` and ``_config()``), copied so that the port's scripts need not import
``bench.py``: a forward-looking 640 × 192 camera rigidly on the lidar with
zero offset (the synthetic renders use ``camera_from_velodyne_pose``), the
tracker scaled to that camera (13 px window, 3 levels, shallow reverse,
4 coarse iterations) and a 768-slot feature table fed by a 25 × 6 grid."""

from __future__ import annotations

import numpy as np

from .config import CameraConfig, ExtrinsicConfig, SystemConfig, VisualConfig

CAM = dict(fx=240.0, fy=240.0, cx=320.0, cy=96.0, width=640, height=192)


def camlidar_config() -> SystemConfig:
    R_sc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    ext = tuple(tuple(float(v) for v in row) + (0.0,) for row in R_sc.T)
    return SystemConfig(
        camera=CameraConfig(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
                            width=CAM["width"], height=CAM["height"]),
        visual=VisualConfig(depth_cloud_cap=16384, lk_window=13, lk_levels=3,
                            lk_reverse_levels=1, lk_iters_coarse=4, max_tracked=768,
                            grid_cols=25),
        extrinsic=ExtrinsicConfig(matrix=ext),
    )
