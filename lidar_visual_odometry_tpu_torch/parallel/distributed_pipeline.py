"""The distributed SLAM driver, ported from
``lidar_visual_odometry_tpu/parallel/distributed_pipeline.py``.

Every rank runs this driver on the same scans. Per frame:

* feature extraction runs replicated (one scan, the same on every rank;
  kernel K1),
* the scan-to-scan GN runs parallel over the current frame's features, the
  normal equations all-reduced (``sharded_odometry``; kernel K2 on each
  rank's block),
* the scan-to-map refinement shards the gathered local submap along its
  capacity, and the ranks' 5-NN candidates merge through one all-gather
  (``sharded_mapping``), at the ``map_skip`` cadence
  (``laserOdometry.cpp:274-276``),
* the host ``CubeMap`` archive keeps the cubes as the single-device host
  driver does (``models/lidar_mapping.LidarMapping``).

Collective bytes a frame (float32): the odometry all-reduces one 6 × 6 + 6
system a GN iteration, 168 B; the mapping all-gathers (Q, k, 4) floats a
round, D·Q·k·16 B.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from ..models import lidar_mapping as lm
from ..models.pipeline import _register_raw
from ..ops import se3
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import sharded_mapping as sm
from . import sharded_odometry as so


class DistributedSlamPipeline:
    """scan → features → all-reduced scan-to-scan → submap-sharded
    scan-to-map, on every rank of the job (an initialised process group:
    ``multihost.initialize``)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), n_devices: int | None = None,
                 capacity: int = 131072, device="cuda"):
        self.mesh = so.make_mesh()
        if n_devices is not None and n_devices != self.mesh.size:
            raise ValueError(f"n_devices={n_devices}, but the job has {self.mesh.size} ranks")
        if resolve_device(device).type != self.mesh.device.type:
            raise ValueError(f"device={device!r}, but this rank runs on {self.mesh.device}")
        self.device = self.mesh.device
        self.cfg = cfg
        self.capacity = capacity
        self.mapper = lm.LidarMapping(cfg.mapping, self.device)
        self.pose_w = se3.identity_pose(self.device)
        self.pose_rel = se3.identity_pose(self.device)
        self._step = partial(sm.sharded_mapping_step, self.mesh)
        self._prev = None        # (less_sharp, less_flat), replicated
        self._frame = 0

    def process_scan(self, points: np.ndarray, map_skip: int = 1) -> se3.Pose:
        """Feed one raw (n, ≥3) scan; returns the map-refined world pose."""
        feats = _register_raw(points, self.capacity, self.cfg.lidar, self.device).features
        if self._prev is not None:
            rel = so.sharded_scan_to_scan(self.mesh, feats, *self._prev, self.pose_rel,
                                          self.cfg.odometry)
            self.pose_w = se3.se3_compose(self.pose_w, rel)
            self.pose_rel = rel
        self._prev = (feats.less_sharp, feats.less_flat)
        return self._mapping_update(feats, map_skip)

    def _mapping_update(self, feats, map_skip: int = 1) -> se3.Pose:
        """Scan-to-map at the mapping cadence (the submap sharded over the
        ranks), the host ``CubeMap`` bookkeeping of ``LidarMapping``; shared
        with the cam-lidar driver (``distributed_camlidar``)."""
        refined = self.mapper.process(feats, self.pose_w, step=self._step,
                                      map_frame=self._frame % map_skip == 0)
        self._frame += 1
        return refined

    def run(self, scans, map_skip: int = 1, progress: bool = False):
        """Returns (odometry positions (N, 3), mapped positions (N, 3),
        wall seconds)."""
        t0 = time.perf_counter()
        odom_t, mapped = [], []
        for pts in scans:
            refined = self.process_scan(np.asarray(pts), map_skip=map_skip)
            odom_t.append(self.pose_w.t)
            mapped.append(refined.t)
        odom = torch.stack(odom_t).cpu().numpy()
        mapped_t = torch.stack(mapped).cpu().numpy()
        wall = time.perf_counter() - t0
        if progress:
            print(f"distributed SLAM ({self.mesh.size} ranks): {len(scans)} frames in "
                  f"{wall:.2f} s → {len(scans) / wall:.1f} frames/s")
        return odom, mapped_t, wall
