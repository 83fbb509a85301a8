"""Host-side odometry pipeline driver, ported from
``lidar_visual_odometry_tpu/models/pipeline.py`` (``OdometryPipeline.run_chunked``).

Frame 0 is registered from its raw points (``register_scan``) and seeds the
feature state; every later frame is packed on the host into a polar image
(``ingest="polar2"``: range only, 2 B/cell; ``"polar"``: range and angular
offsets, 4 B/cell), uploaded a chunk at a time, and run through
``odometry_chunk_polar`` on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import pointcloud as pc
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import lidar_odometry as lo
from . import scan_registration as sr


@dataclass
class TrajectoryResult:
    positions: np.ndarray      # (N, 3)
    quaternions: np.ndarray    # (N, 4) wxyz
    per_frame_s: list = field(default_factory=list)


class OdometryPipeline:
    """scan → features → scan-to-scan pose, on ``device`` (default CUDA)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)

    def run_chunked(self, scans, chunk: int = 8, ingest: str = "polar2") -> TrajectoryResult:
        """Run a whole sequence of raw (n_i, ≥3) scans, ``chunk`` frames per
        upload. Returns world positions and quaternions for every frame
        (frame 0 is the identity)."""
        if ingest not in ("polar", "polar2"):
            raise ValueError(f"ingest must be 'polar' or 'polar2', got {ingest!r}")
        lcfg = self.cfg.lidar
        xyz0, mask0 = pc.pad_points(np.asarray(scans[0])[:, :3], self.capacity)
        reg0 = sr.register_scan(xyz0, mask0, lcfg, device=self.device)
        state = lo.init_state(reg0.features)

        # timed from frame 1 on, as the reference pipeline times it
        t0 = time.perf_counter()

        qs = [torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=self.device)]
        ts = [torch.zeros((1, 3), device=self.device)]
        for s in range(1, len(scans), chunk):
            imgs = pc.pack_polar_chunk(
                scans[s:s + chunk], n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
                min_range=lcfg.min_range, max_range=lcfg.max_range,
                channels=1 if ingest == "polar2" else 2,
            )
            state, poses = lo.odometry_chunk_polar(
                state, imgs, lcfg, self.cfg.odometry, device=self.device
            )
            qs.append(poses.q)
            ts.append(poses.t)
        all_q = torch.cat(qs).cpu().numpy()
        all_t = torch.cat(ts).cpu().numpy()
        wall = time.perf_counter() - t0
        n = len(scans)
        return TrajectoryResult(all_t, all_q, per_frame_s=[wall / max(n - 1, 1)] * n)
