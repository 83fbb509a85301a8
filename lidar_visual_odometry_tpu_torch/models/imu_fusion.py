"""IMU-fused lidar odometry, ported from
``lidar_visual_odometry_tpu/models/imu_fusion.py``.

The reference ships the pieces and never connects them: adjustPointCloud
bundles IMU samples per lidar frame and derotates clouds
(``src/adjustPointCloud.cpp:144-247``), and BackEndSolver holds an ISAM2
smoother that nothing builds (``src/vloam/BackEndSolver.cpp:22-385``). This
driver connects them as the JAX package does:

    scans ──► LidarOdometry ──► relative poses ─┐
    IMU  ──► bundle (sync.bundle_imu)           ├─► solve_window (sliding
             └► preintegrate (backend)          ┘    Gauss-Newton window)

Per frame: preintegrate the frame's IMU bundle into an ``ImuDelta``, take the
odometry's relative pose as a between-factor, and re-solve the window of K
states. The gyro's preintegrated rotation warm-starts the scan-to-scan solve
in place of the constant-velocity rotation; ``derotate`` first removes the
roll and pitch of the dead-reckoned IMU orientation from each scan
(adjustPointCloud's republish loop).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..data import sync
from ..ops import se3
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import lidar_odometry as lo
from .backend import ImuDelta, WindowState, preintegrate, solve_window
from .pipeline import _register_raw


class ImuFusedOdometry:
    """Sliding-window IMU + lidar-odometry fusion on ``device`` (default
    CUDA). ``window`` is the number of states K in the factor graph; until
    the window fills, the output is the plain lidar odometry."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), *, capacity: int = 131072,
                 window: int = 8, frame_period: float = 0.1, imu_weight: float = 1.0,
                 odom_weight: float = 20.0, derotate: bool = False, n_iters: int = 6,
                 imu_warmstart: bool = True, device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.window = window
        self.frame_period = frame_period
        self.imu_weight = imu_weight
        self.odom_weight = odom_weight
        self.derotate = derotate
        self.n_iters = n_iters
        self.imu_warmstart = imu_warmstart
        self.device = resolve_device(device)

        self.odom = lo.LidarOdometry(cfg.odometry)
        self._poses: list[se3.Pose] = []          # raw odometry world poses
        self._fused: list[se3.Pose] = []          # fused history (the anchors)
        self._deltas: deque[ImuDelta] = deque(maxlen=window - 1)
        self._rels: deque[se3.Pose] = deque(maxlen=window - 1)
        self._q_imu = np.array([1.0, 0.0, 0.0, 0.0])    # dead-reckoned orientation

    def _upload(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)

    def _preintegrate(self, accel, gyro, dts) -> ImuDelta:
        return preintegrate(self._upload(accel), self._upload(gyro), self._upload(dts))

    def _integrate_orientation(self, gyro, dts) -> None:
        """Dead-reckon the IMU orientation on the host: float32 steps, as the
        JAX package takes them, kept between calls as float64."""
        q = torch.tensor(self._q_imu, dtype=torch.float32)
        for w, dt in zip(np.asarray(gyro), np.asarray(dts)):
            q = se3.quat_normalize(se3.quat_mul(q, se3.so3_exp(
                torch.as_tensor(np.asarray(w * dt), dtype=torch.float32))))
        self._q_imu = q.numpy().astype(np.float64)

    def process(self, scan: np.ndarray, accel: np.ndarray, gyro: np.ndarray,
                dts: np.ndarray) -> se3.Pose:
        """Feed one raw (n, ≥3) scan and its IMU bundle ((M, 3) accel, (M, 3)
        gyro, (M,) intervals; M may be 0); returns the fused world pose."""
        if self.derotate and len(accel):
            self._integrate_orientation(gyro, dts)
            scan = sync.derotate_cloud(np.asarray(scan)[:, :3], self._q_imu).astype(np.float32)
        reg = _register_raw(scan, self.capacity, self.cfg.lidar, self.device)
        # the gyro's rotation over this interval replaces the constant-velocity
        # rotation prior; the translation keeps the velocity prior
        delta = init_rel = None
        if len(accel) and self.odom.state is not None:
            delta = self._preintegrate(accel, gyro, dts)
            if self.imu_warmstart:
                init_rel = se3.Pose(delta.dq, self.odom.state.pose_rel.t)
        pose_w, _ = self.odom.process(reg.features, init_rel=init_rel)
        return self._fuse(pose_w, accel, gyro, dts, delta)

    def process_pose(self, pose_w: se3.Pose, accel: np.ndarray, gyro: np.ndarray,
                     dts: np.ndarray) -> se3.Pose:
        """The fusion core with any odometry source: feed one world pose
        estimate and the frame's IMU bundle; returns the fused world pose."""
        return self._fuse(pose_w, accel, gyro, dts, None)

    def _fuse(self, pose_w: se3.Pose, accel, gyro, dts, delta: ImuDelta | None) -> se3.Pose:
        """``process_pose``, reusing the bundle's preintegration when
        ``process`` has made it."""
        self._poses.append(pose_w)
        dev = pose_w.t.device
        if len(self._poses) >= 2:
            self._rels.append(se3.se3_compose(se3.se3_inverse(self._poses[-2]),
                                              self._poses[-1]))
            if len(accel):
                d = delta if delta is not None else self._preintegrate(accel, gyro, dts)
            else:   # no samples this interval: the zero-motion delta
                d = ImuDelta(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                             torch.zeros(3, device=dev), torch.zeros(3, device=dev),
                             torch.tensor(self.frame_period, dtype=torch.float32, device=dev))
            self._deltas.append(d)

        if len(self._poses) < self.window:
            self._fused.append(pose_w)
            return pose_w

        # the window is anchored on the fused history (the prior pins its
        # oldest state; the raw odometry gives only between-factors), its
        # newest state predicted by the latest odometry motion
        tail = self._fused[-(self.window - 1):] + [
            se3.se3_compose(self._fused[-1], self._rels[-1])]
        ps = torch.stack([p.t for p in tail])
        vs = torch.cat([(ps[1:] - ps[:-1]) / self.frame_period,
                        torch.zeros((1, 3), device=dev)])
        state0 = WindowState(q=torch.stack([p.q for p in tail]), p=ps, v=vs)
        deltas = ImuDelta(*(torch.stack(field) for field in zip(*self._deltas)))
        rels = se3.Pose(torch.stack([r.q for r in self._rels]),
                        torch.stack([r.t for r in self._rels]))
        fused = solve_window(state0, deltas, rels, imu_weight=self.imu_weight,
                             odom_weight=self.odom_weight, n_iters=self.n_iters)
        out = se3.Pose(fused.q[-1], fused.p[-1])
        self._fused.append(out)
        return out
