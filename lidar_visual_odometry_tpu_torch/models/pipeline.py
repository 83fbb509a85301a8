"""Host-side pipeline drivers, ported from
``lidar_visual_odometry_tpu/models/pipeline.py``: ``OdometryPipeline`` (lidar
odometry) and ``FullPipeline`` (odometry + scan-to-map refinement).

Per frame, ``process_scan`` / ``run`` register each padded raw scan
(``register_scan``) and hand its features to ``LidarOdometry`` (and, in
``FullPipeline.run``, to the device map or the host cube map). The chunked
``run_chunked`` registers frame 0 from its raw points, then uploads ``chunk``
frames at a time in the ingest asked for:

* ``"float"``: float32 points and a mask, padded to ``capacity``;
* ``"uint16"``: points quantised at 3.9 mm and a count a frame
  (``lidar_odometry.quantize_scan``), half the float bytes;
* ``"polar"`` / ``"polar2"``: packed (ring, azimuth) range images with or
  without the angular offsets (4 or 2 bytes a cell).

The parameters are the reference's, in its order, with its defaults
(``OdometryPipeline``: ``"uint16"`` with ``quantize``, else ``"float"``;
``FullPipeline``: ``"uint16"``). Checkpoints (``utils/checkpoint.py``) are
written at chunk boundaries every ``checkpoint_every`` frames and when the run
stops after ``stop_after``; ``resume=True`` continues from one, replaying the
same operations on the same state, so the joined run equals the uninterrupted
one bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data import native_pack
from ..ops import pointcloud as pc
from ..ops import se3
from ..utils import checkpoint as ckpt
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from ..utils.profiler import span
from . import device_mapping as dm
from . import lidar_mapping as lm
from . import lidar_odometry as lo
from . import scan_registration as sr

IDENT_Q = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
ZERO_T = np.zeros((1, 3), np.float32)


@dataclass
class TrajectoryResult:
    positions: np.ndarray      # (N, 3)
    quaternions: np.ndarray    # (N, 4) wxyz
    per_frame_s: list = field(default_factory=list)


def _check_ingest(ingest: str, allowed=("float", "uint16", "polar", "polar2")) -> None:
    if ingest not in allowed:
        raise ValueError(f"ingest must be one of {allowed}, got {ingest!r}")


def _pack_polar(batch, lcfg, ingest: str, dev: torch.device) -> torch.Tensor:
    """A chunk of raw scans as polar images (int32 cells) on ``dev``, packed
    by the native packer (``data/native_pack.py``), as the JAX package's
    ``run_chunked`` polar ingests pack them: the reference's bits."""
    with span("pack"):
        imgs = native_pack.pack_polar_chunk(
            batch, n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
            max_range=lcfg.max_range, n_frames=len(batch),
            channels=1 if ingest == "polar2" else 2)
    with span("upload"):
        return pc.polar_image_to_tensor(imgs, dev)


def _quantize(batch, capacity: int, dev: torch.device):
    """A chunk of raw scans as (K, capacity, 3) uint16 codes (int16 on the
    device, the same bits) and (K,) int32 counts on ``dev``."""
    with span("pack"):
        qs = np.zeros((len(batch), capacity, 3), np.uint16)
        counts = np.zeros((len(batch),), np.int32)
        for i, pts in enumerate(batch):
            qs[i], counts[i] = lo.quantize_scan(np.asarray(pts), capacity)
    with span("upload"):
        return lo.upload(qs, dev), lo.upload(counts, dev)


def _register_raw(scan, capacity: int, lcfg, dev: torch.device):
    """One raw (n, ≥3) scan padded to ``capacity`` and registered on ``dev``."""
    xyz, mask = pc.pad_points(np.asarray(scan)[:, :3], capacity)
    return sr.register_scan_impl(pc.to_device(xyz, dev), pc.to_device(mask, dev), lcfg)


class OdometryPipeline:
    """scan → features → scan-to-scan pose, on ``device`` (default CUDA)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        self.odom = lo.LidarOdometry(cfg.odometry)

    def process_scan(self, points: np.ndarray) -> se3.Pose:
        """Feed one raw (N, ≥3) scan; returns the current world pose (on the
        device; nothing is read back)."""
        reg = _register_raw(points, self.capacity, self.cfg.lidar, self.device)
        pose_w, _ = self.odom.process(reg.features)
        return pose_w

    def run(self, scans, progress: bool = False) -> TrajectoryResult:
        """Every scan through ``process_scan``, the poses read back once at
        the end."""
        t0 = time.perf_counter()
        poses = [self.process_scan(np.asarray(pts)) for pts in scans]
        qs = torch.stack([p.q for p in poses]).cpu().numpy()
        ts = torch.stack([p.t for p in poses]).cpu().numpy()
        wall = time.perf_counter() - t0
        n = len(scans)
        if progress:
            print(f"{n} frames in {wall:.2f}s → {n / wall:.1f} fps")
        return TrajectoryResult(ts, qs, per_frame_s=[wall / n] * n)

    def run_chunked(self, scans, chunk: int = 8, progress: bool = False,
                    quantize: bool = False, ingest: str | None = None,
                    checkpoint_path: str | None = None, checkpoint_every: int = 0,
                    resume: bool = False, stop_after: int | None = None) -> TrajectoryResult:
        """Run a sequence of raw (n_i, ≥3) scans, ``chunk`` frames per upload.
        Returns world positions and quaternions for every frame done (frame 0
        is the identity). ``ingest`` None means ``"uint16"`` with
        ``quantize``, else ``"float"``. ``progress`` prints the frame rate at
        the end."""
        if ingest is None:
            ingest = "uint16" if quantize else "float"
        _check_ingest(ingest)
        dev, lcfg, ocfg = self.device, self.cfg.lidar, self.cfg.odometry
        with span("sequence"):
            if resume:
                with span("sync", site="checkpoint"):
                    start, state, traj_q, traj_t = ckpt.load_checkpoint(checkpoint_path,
                                                                        device=dev)
            else:
                with span("features"):
                    feats0 = _register_raw(scans[0], self.capacity, lcfg, dev).features
                state = lo.init_state(feats0)
                start, traj_q, traj_t = 1, IDENT_Q, ZERO_T
            rec = ckpt.RunRecord(checkpoint_path, checkpoint_every, stop_after, start,
                                 {"q": traj_q, "t": traj_t})

            # timed from the first frame computed, as the reference times it
            t0 = time.perf_counter()
            n = len(scans)
            for s in range(start, n, chunk):
                with span("chunk"):
                    batch = scans[s:s + chunk]
                    if ingest.startswith("polar"):
                        state, poses = lo.odometry_chunk_polar(
                            state, _pack_polar(batch, lcfg, ingest, dev), lcfg, ocfg, device=dev)
                    elif ingest == "uint16":
                        state, poses = lo.odometry_chunk_quantized(
                            state, *_quantize(batch, self.capacity, dev), lcfg, ocfg)
                    else:
                        with span("pack"):
                            padded = [pc.pad_points(np.asarray(p)[:, :3], self.capacity)
                                      for p in batch]
                        with span("upload"):
                            pts = lo.upload(np.stack([p for p, _ in padded]), dev)
                            masks = lo.upload(np.stack([m for _, m in padded]), dev)
                        state, poses = lo.odometry_chunk(state, pts, masks, lcfg, ocfg)
                    rec.append(q=poses.q, t=poses.t)
                    next_s = min(s + chunk, n)
                    if rec.snapshot_due(next_s):
                        with span("sync", site="checkpoint"):
                            ckpt.save_checkpoint(checkpoint_path, frame_idx=next_s,
                                                 odom_state=state,
                                                 trajectory_q=rec.host("q")[:next_s],
                                                 trajectory_t=rec.host("t")[:next_s])
                    if rec.stops(next_s):
                        n = next_s
                        break
            with span("sync", site="readback"):
                qs, ts = rec.host("q")[:n], rec.host("t")[:n]
            wall = time.perf_counter() - t0
        done = max(n - start, 1)
        if progress:
            print(f"{n} frames ({done} computed) in {wall:.2f}s → {done / wall:.1f} fps")
        return TrajectoryResult(ts, qs, per_frame_s=[wall / done] * n)


class FullPipeline:
    """Odometry + scan-to-map refinement on ``device`` (default CUDA): the
    scanRegistration → laserOdometry → laserMapping chain. ``device_map``
    True keeps the local map on the device (``models/device_mapping.py``);
    False keeps the reference's unbounded host cube store
    (``lidar_mapping.LidarMapping``: a submap upload and a host
    synchronisation a frame), for ``run`` only."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device_map: bool = True, device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        self.odom = lo.LidarOdometry(cfg.odometry)
        self.device_map = device_map
        self.mapper = (dm.DeviceMapping(cfg.mapping, self.device) if device_map
                       else lm.LidarMapping(cfg.mapping, self.device))

    def run(self, scans, progress: bool = False):
        """Per frame: register, odometry, then mapping at the odometry's
        cadence (``cfg.odometry.skip_frame_num``; frames in between compose
        the last correction). Returns (odometry, mapped) ``TrajectoryResult``s."""
        t0 = time.perf_counter()
        feats_stream, odom_poses = [], []
        for pts in scans:
            reg = _register_raw(pts, self.capacity, self.cfg.lidar, self.device)
            pose_w, _ = self.odom.process(reg.features)
            feats_stream.append(reg.features)
            odom_poses.append(pose_w)

        mapped_poses = []
        skip = self.cfg.odometry.skip_frame_num
        for k, (feats, pose) in enumerate(zip(feats_stream, odom_poses)):
            if self.device_map:
                last = self.mapper.process(feats, pose, skip=skip)
            elif k % skip == 0:
                last = self.mapper.process(feats, pose)
            else:
                last = se3.se3_compose(self.mapper.correction, pose)
            mapped_poses.append(last)

        def to_numpy(poses):
            return (torch.stack([p.t for p in poses]).cpu().numpy(),
                    torch.stack([p.q for p in poses]).cpu().numpy())

        (odo_t, odo_q), (map_t, map_q) = to_numpy(odom_poses), to_numpy(mapped_poses)
        wall = time.perf_counter() - t0
        n = len(scans)
        if progress:
            print(f"odom+map: {n} frames in {wall:.2f}s")
        per = [wall / n] * n
        return (TrajectoryResult(odo_t, odo_q, per_frame_s=per),
                TrajectoryResult(map_t, map_q, per_frame_s=per))

    def run_chunked(self, scans, chunk: int = 8, progress: bool = False,
                    map_skip: int | None = None, ingest: str = "uint16",
                    checkpoint_path: str | None = None, checkpoint_every: int = 0,
                    resume: bool = False, stop_after: int | None = None):
        """Run a sequence of raw (n_i, ≥3) scans, ``chunk`` frames per
        upload, mapping every ``map_skip``-th frame (default
        ``cfg.odometry.skip_frame_num``) against the device map. Returns
        (odometry, mapped) ``TrajectoryResult``s; frame 0 is the identity in
        both. ``ingest`` is ``"uint16"``, ``"polar"`` or ``"polar2"`` (the
        reference runs any other as uint16; the port raises). A checkpoint
        also carries the map state and the mapped trajectory (``mapst_*``,
        ``traj_map_q`` / ``traj_map_t``)."""
        if not self.device_map:
            raise ValueError("run_chunked needs the device-resident map (device_map=True)")
        _check_ingest(ingest, allowed=("uint16", "polar", "polar2"))
        if map_skip is None:
            map_skip = self.cfg.odometry.skip_frame_num
        dev, lcfg = self.device, self.cfg.lidar
        with span("sequence"):
            if resume:
                with span("sync", site="checkpoint"):
                    start, odo_state, traj_q, traj_t = ckpt.load_checkpoint(checkpoint_path,
                                                                            device=dev)
                    map_state = ckpt.load_map_state(checkpoint_path, dev)
                    data = np.load(checkpoint_path)
                    first = {"q": traj_q, "t": traj_t, "map_q": data["traj_map_q"],
                             "map_t": data["traj_map_t"]}
            else:
                with span("features"):
                    feats0 = _register_raw(scans[0], self.capacity, lcfg, dev).features
                odo_state = lo.init_state(feats0)
                map_state = dm.init_state(self.cfg.mapping, dev)
                start = 1
                first = {"q": IDENT_Q, "t": ZERO_T, "map_q": IDENT_Q, "map_t": ZERO_T}
            rec = ckpt.RunRecord(checkpoint_path, checkpoint_every, stop_after, start, first)
            cfgs = (lcfg, self.cfg.odometry, self.cfg.mapping)

            # timed from the first frame computed, as the reference times it
            t0 = time.perf_counter()
            n = len(scans)
            for s in range(start, n, chunk):
                with span("chunk"):
                    batch = scans[s:s + chunk]
                    if ingest.startswith("polar"):
                        odo_state, map_state, op, mp = dm.slam_chunk_polar(
                            odo_state, map_state, _pack_polar(batch, lcfg, ingest, dev), *cfgs,
                            start_idx=s, map_skip=map_skip, device=dev)
                    else:
                        odo_state, map_state, op, mp = dm.slam_chunk_quantized(
                            odo_state, map_state, *_quantize(batch, self.capacity, dev), *cfgs,
                            start_idx=s, map_skip=map_skip)
                    rec.append(q=op.q, t=op.t, map_q=mp.q, map_t=mp.t)
                    next_s = min(s + chunk, n)
                    if rec.snapshot_due(next_s):
                        with span("sync", site="checkpoint"):
                            ckpt.save_checkpoint(
                                checkpoint_path, frame_idx=next_s, odom_state=odo_state,
                                trajectory_q=rec.host("q")[:next_s],
                                trajectory_t=rec.host("t")[:next_s], map_state=map_state,
                                extra={"traj_map_q": rec.host("map_q")[:next_s],
                                       "traj_map_t": rec.host("map_t")[:next_s]})
                    if rec.stops(next_s):
                        n = next_s
                        break
            with span("sync", site="readback"):
                odom_q, odom_t, map_q, map_t = (rec.host(k)[:n]
                                                for k in ("q", "t", "map_q", "map_t"))
            wall = time.perf_counter() - t0
        done = max(n - start, 1)
        if progress:
            print(f"odom+map(fused): {n} frames ({done} computed) in {wall:.2f}s → "
                  f"{done / wall:.1f} fps")
        per = [wall / done] * n
        return (TrajectoryResult(odom_t, odom_q, per_frame_s=per),
                TrajectoryResult(map_t, map_q, per_frame_s=per))
