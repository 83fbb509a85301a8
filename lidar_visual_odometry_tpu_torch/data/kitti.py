"""KITTI odometry dataset reader (host-side, numpy).

The port's own copy of ``lidar_visual_odometry_tpu/data/kitti.py``: the port
imports nothing from the JAX package, so it keeps this file verbatim to read
the same files into the same arrays.

Replaces the reference's kittiHelper ROS node (``src/kittiHelper.cpp:37-181``):
reads ``times.txt``, velodyne ``.bin`` float32 records, grayscale image pairs,
ground-truth poses, and the ``calib.txt`` projection/extrinsic matrices —
yielding numpy arrays instead of publishing ROS topics.

Expected layout (standard KITTI odometry distribution)::

    <root>/sequences/<SS>/velodyne/000000.bin
    <root>/sequences/<SS>/image_0/000000.png
    <root>/sequences/<SS>/times.txt
    <root>/sequences/<SS>/calib.txt
    <root>/poses/<SS>.txt
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 4) float32: x, y, z, reflectance (kittiHelper.cpp:25-35 analog)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """(N, 3, 4) cam0 ground-truth poses (row-major 3x4 per line)."""
    data = np.loadtxt(path, dtype=np.float64)
    return data.reshape(-1, 3, 4)


def read_calib(path: str) -> dict[str, np.ndarray]:
    """Parse calib.txt → {'P0'..'P3': (3,4), 'Tr': (3,4) velo→cam0}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.fromstring(vals, sep=" ").reshape(3, 4)
    return out


def read_image_gray(path: str) -> np.ndarray:
    """(H, W) float32 in [0, 1]. PNG decoding without OpenCV."""
    try:
        from PIL import Image  # pillow ships with the baked torch stack

        img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
    except ImportError:  # pragma: no cover
        import torch
        import torchvision.io as tvio  # type: ignore

        img = tvio.read_image(path).float().mean(0).numpy()
    return img / 255.0


@dataclass
class KittiOdometrySequence:
    """Iterator over one KITTI odometry sequence."""

    root: str
    sequence: int

    def __post_init__(self):
        seq = f"{self.sequence:02d}"
        self.seq_dir = os.path.join(self.root, "sequences", seq)
        self.times = read_times(os.path.join(self.seq_dir, "times.txt"))
        calib = read_calib(os.path.join(self.seq_dir, "calib.txt"))
        self.P0 = calib["P0"]
        self.Tr = calib["Tr"]  # velodyne → cam0
        pose_file = os.path.join(self.root, "poses", seq + ".txt")
        self.gt_poses = read_poses(pose_file) if os.path.exists(pose_file) else None

    def __len__(self) -> int:
        return len(self.times)

    def scan(self, k: int) -> np.ndarray:
        return read_velodyne_bin(
            os.path.join(self.seq_dir, "velodyne", f"{k:06d}.bin")
        )

    def image(self, k: int, cam: int = 0) -> np.ndarray:
        return read_image_gray(
            os.path.join(self.seq_dir, f"image_{cam}", f"{k:06d}.png")
        )

    def gt_pose_velodyne(self, k: int) -> np.ndarray:
        """(4, 4) GT velodyne-frame pose: T_w_velo = T_w_cam · Tr.

        (kittiHelper instead rotates everything into a camera-axis world frame,
        kittiHelper.cpp:78-80; we keep the metric velodyne frame and evaluate
        trajectories after Umeyama-free rigid alignment of the first pose.)
        """
        assert self.gt_poses is not None
        T_w_cam = np.eye(4)
        T_w_cam[:3] = self.gt_poses[k]
        T_cam_velo = np.eye(4)
        T_cam_velo[:3] = self.Tr
        return T_w_cam @ T_cam_velo
