"""Host-side pipeline drivers, ported from
``lidar_visual_odometry_tpu/models/pipeline.py``: ``OdometryPipeline.run_chunked``
(lidar odometry) and ``FullPipeline.run_chunked`` (odometry + device-resident
mapping, the bench's "fused SLAM").

Frame 0 is registered from its raw points (``register_scan``) and seeds the
feature state; every later frame is packed on the host into a polar image
(``ingest="polar2"``: range only, 2 B/cell; ``"polar"``: range and angular
offsets, 4 B/cell), uploaded a chunk at a time, and run through
``odometry_chunk_polar`` (or ``device_mapping.slam_chunk_polar``) on the device.
Both ``run_chunked``s take the reference's parameters in its order, with its
defaults; its default ingests (``"float"``, ``"uint16"``) are not ported yet
and raise, so callers pass ``ingest="polar2"`` or ``"polar"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import pointcloud as pc
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import device_mapping as dm
from . import lidar_odometry as lo
from . import scan_registration as sr


@dataclass
class TrajectoryResult:
    positions: np.ndarray      # (N, 3)
    quaternions: np.ndarray    # (N, 4) wxyz
    per_frame_s: list = field(default_factory=list)


def _check_ingest(ingest: str, unported=("float", "uint16")) -> None:
    """Raise for an ingest the port does not run: the reference's
    ``unported`` ones are not ported yet, anything else is no ingest."""
    if ingest in unported:
        raise NotImplementedError(
            f"ingest={ingest!r} is not ported yet (ROADMAP A.7: the 'float' / 'uint16' "
            "ingests); pass ingest='polar2' or 'polar'")
    if ingest not in ("polar", "polar2"):
        raise ValueError(f"ingest must be 'polar' or 'polar2', got {ingest!r}")


def _check_no_checkpoint(checkpoint_path, checkpoint_every, resume, stop_after) -> None:
    if checkpoint_path is not None or checkpoint_every or resume or stop_after is not None:
        raise NotImplementedError("checkpoint and resume are not ported yet (ROADMAP A.7)")


class OdometryPipeline:
    """scan → features → scan-to-scan pose, on ``device`` (default CUDA)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)

    def run_chunked(self, scans, chunk: int = 8, progress: bool = False,
                    quantize: bool = False, ingest: str | None = None,
                    checkpoint_path: str | None = None, checkpoint_every: int = 0,
                    resume: bool = False, stop_after: int | None = None) -> TrajectoryResult:
        """Run a whole sequence of raw (n_i, ≥3) scans, ``chunk`` frames per
        upload. Returns world positions and quaternions for every frame
        (frame 0 is the identity). The parameters are the reference's:
        ``ingest`` None means ``"uint16"`` with ``quantize``, else ``"float"``;
        only ``"polar2"`` and ``"polar"`` are ported, the others and the
        checkpoint arguments raise ``NotImplementedError`` (ROADMAP A.7).
        ``progress`` prints the frame rate at the end."""
        if ingest is None:
            ingest = "uint16" if quantize else "float"
        _check_ingest(ingest)
        _check_no_checkpoint(checkpoint_path, checkpoint_every, resume, stop_after)
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
        done = max(n - 1, 1)
        if progress:
            print(f"{n} frames ({done} computed) in {wall:.2f}s → {done / wall:.1f} fps")
        return TrajectoryResult(all_t, all_q, per_frame_s=[wall / done] * n)


class FullPipeline:
    """Odometry + scan-to-map refinement on ``device`` (default CUDA): the
    scanRegistration → laserOdometry → laserMapping chain, with the map
    resident on the device (``models/device_mapping.py``)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device_map: bool = True, device="cuda"):
        if not device_map:
            raise NotImplementedError(
                "device_map=False (the host CubeMap driver) is not ported yet "
                "(ROADMAP A.7)")
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)

    def run(self, scans, progress: bool = False):
        raise NotImplementedError(
            "FullPipeline.run (the per-frame driver) is not ported yet (ROADMAP A.7); "
            "use run_chunked")

    def run_chunked(self, scans, chunk: int = 8, progress: bool = False,
                    map_skip: int | None = None, ingest: str = "uint16",
                    checkpoint_path: str | None = None, checkpoint_every: int = 0,
                    resume: bool = False, stop_after: int | None = None):
        """Run a whole sequence of raw (n_i, ≥3) scans, ``chunk`` frames per
        upload, mapping every ``map_skip``-th frame (default
        ``cfg.odometry.skip_frame_num``). Returns (odometry, mapped)
        ``TrajectoryResult``s; frame 0 is the identity in both. The
        parameters are the reference's: only ``"polar2"`` and ``"polar"`` are
        ported, the default ``"uint16"`` and the checkpoint arguments raise
        ``NotImplementedError`` (ROADMAP A.7). ``progress`` prints the run's
        time at the end."""
        _check_ingest(ingest)
        _check_no_checkpoint(checkpoint_path, checkpoint_every, resume, stop_after)
        if map_skip is None:
            map_skip = self.cfg.odometry.skip_frame_num
        lcfg = self.cfg.lidar
        xyz0, mask0 = pc.pad_points(np.asarray(scans[0])[:, :3], self.capacity)
        reg0 = sr.register_scan(xyz0, mask0, lcfg, device=self.device)
        odo_state = lo.init_state(reg0.features)
        map_state = dm.init_state(self.cfg.mapping, self.device)

        # timed from frame 1 on, as the reference pipeline times it
        start = time.perf_counter()
        q0 = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=self.device)
        t0 = torch.zeros((1, 3), device=self.device)
        odom_q, odom_t, map_q, map_t = [q0], [t0], [q0], [t0]
        for s in range(1, len(scans), chunk):
            imgs = pc.pack_polar_chunk(
                scans[s:s + chunk], n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
                min_range=lcfg.min_range, max_range=lcfg.max_range,
                channels=1 if ingest == "polar2" else 2,
            )
            odo_state, map_state, op, mp = dm.slam_chunk_polar(
                odo_state, map_state, imgs, lcfg, self.cfg.odometry, self.cfg.mapping,
                start_idx=s, map_skip=map_skip, device=self.device,
            )
            odom_q.append(op.q)
            odom_t.append(op.t)
            map_q.append(mp.q)
            map_t.append(mp.t)
        odom_q, odom_t, map_q, map_t = (torch.cat(x).cpu().numpy()
                                        for x in (odom_q, odom_t, map_q, map_t))
        wall = time.perf_counter() - start
        n = len(scans)
        if progress:
            print(f"odom+map: {n} frames in {wall:.2f}s")
        per = [wall / max(n - 1, 1)] * n
        return (TrajectoryResult(odom_t, odom_q, per_frame_s=per),
                TrajectoryResult(map_t, map_q, per_frame_s=per))
