"""Synthetic HDL-64 scene raycaster (host-side, numpy).

The port's own copy of ``lidar_visual_odometry_tpu/data/synthetic.py`` (numpy and
dataclasses only): the port imports nothing from the JAX package, so it
keeps this file verbatim to read the same defaults and scenes.

Generates structured lidar scans — ground plane + box "buildings" + thin poles,
so curvature-based corner/plane features exist — with exact ground-truth sensor
poses. This replaces KITTI for tests and benchmarks in the zero-egress
environment (no dataset on disk), standing in for the reference's kittiHelper
data path (``src/kittiHelper.cpp:37-181``).

Frames follow Velodyne convention: x forward, y left, z up; azimuth sweep
matches the reference's clockwise ``ori = -atan2(y, x)`` time ordering
(``scanRegistration.cpp:141``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def hdl64_elevations() -> np.ndarray:
    """Per-ring elevation angles (deg) consistent with the reference's HDL-64
    ring formula (``scanRegistration.cpp:184-199``): rings 0-31 span
    [2°, -8.33°] at 1/3° spacing, rings 32-63 span [-8.83°, -24.33°] at 1/2°."""
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - (np.arange(32, 64) - 32) / 2.0
    return np.concatenate([upper, lower])


@dataclass
class BoxScene:
    """Axis-aligned boxes + ground plane z=0."""

    boxes: np.ndarray  # (B, 2, 3): [min_corner, max_corner]
    ground_z: float = 0.0

    @staticmethod
    def corridor(seed: int = 0, length: float = 200.0) -> "BoxScene":
        """An urban-canyon corridor along +x: building slabs on both sides with
        gaps (→ vertical edges), plus poles and cross walls."""
        rng = np.random.default_rng(seed)
        boxes = []
        for side in (-1.0, 1.0):
            x = -20.0
            while x < length:
                w = rng.uniform(8.0, 20.0)       # building length along x
                gap = rng.uniform(2.0, 6.0)      # gap → corner edges
                depth = rng.uniform(5.0, 10.0)
                dist = rng.uniform(8.0, 14.0)    # lateral offset of facade
                h = rng.uniform(4.0, 12.0)
                y0 = side * dist
                y1 = side * (dist + depth)
                boxes.append([[x, min(y0, y1), 0.0], [x + w, max(y0, y1), h]])
                x += w + gap
        # poles near the road
        for _ in range(30):
            px = rng.uniform(-10.0, length)
            py = rng.uniform(-7.0, 7.0)
            boxes.append([[px, py, 0.0], [px + 0.25, py + 0.25, rng.uniform(2, 5)]])
        return BoxScene(np.asarray(boxes, dtype=np.float64))


def _ray_aabb(origin: np.ndarray, dirs: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Min positive hit distance per ray against a box set (slab method).

    origin (3,), dirs (M, 3) unit, boxes (B, 2, 3) → (M,) t or +inf.
    """
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)  # (M, 3)
    lo = boxes[:, 0][:, None, :]  # (B, 1, 3)
    hi = boxes[:, 1][:, None, :]
    t0 = (lo - origin) * inv[None]  # (B, M, 3)
    t1 = (hi - origin) * inv[None]
    tmin = np.minimum(t0, t1).max(axis=-1)  # (B, M)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(hit, np.where(tmin > 0, tmin, np.inf), np.inf)
    return t.min(axis=0)


def render_scan(
    scene: BoxScene,
    R_ws: np.ndarray,
    t_ws: np.ndarray,
    *,
    width: int = 1800,
    max_range: float = 80.0,
    noise: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Render one scan from sensor pose (R_ws, t_ws) (sensor→world).

    Returns (N, 3) float32 points in the sensor frame, azimuth-major scan
    order (like a raw Velodyne packet stream); misses are dropped.
    """
    elev = np.radians(hdl64_elevations())  # (64,)
    az = -np.pi + (np.arange(width) + 0.5) / width * 2.0 * np.pi  # (W,)
    # scan order: azimuth outer loop (time), rings inner
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    # -atan2(y, x) == az  →  x = cos(e)cos(az), y = -cos(e)sin(az)
    dirs_s = np.stack(
        [
            np.outer(ca, ce),        # (W, 64)
            np.outer(-sa, ce),
            np.broadcast_to(se, (width, 64)),
        ],
        axis=-1,
    ).reshape(-1, 3)  # (W*64, 3), azimuth-major
    dirs_w = dirs_s @ R_ws.T

    t_box = _ray_aabb(t_ws, dirs_w, scene.boxes)
    # ground plane z = ground_z
    dz = dirs_w[:, 2]
    down = dz < -1e-9
    t_gnd = np.where(down, (scene.ground_z - t_ws[2]) / np.where(down, dz, -1.0), np.inf)
    t = np.minimum(t_box, t_gnd)
    hit = np.isfinite(t) & (t < max_range) & (t > 0.5)

    pts_w = t_ws + dirs_w[hit] * t[hit, None]
    if noise > 0:
        rng = np.random.default_rng(seed)
        pts_w = pts_w + rng.normal(scale=noise, size=pts_w.shape)
    pts_s = (pts_w - t_ws) @ R_ws
    return pts_s.astype(np.float32)


def render_image(
    scene: BoxScene,
    R_wc: np.ndarray,
    t_wc: np.ndarray,
    *,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    max_range: float = 120.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render a textured grayscale view + depth map from a camera pose.

    Camera convention: z forward, x right, y down (standard pinhole). The
    texture is procedural (world-position sinusoids + height shading), so
    images of the same scene are exactly photo-consistent across views —
    ideal ground truth for KLT / photometric-tracking tests.

    Returns (image (H, W) float32 in [0,1], depth (H, W) float32, inf = miss).
    """
    ys, xs = np.mgrid[0:height, 0:width]
    dirs_c = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, dtype=np.float64)],
        axis=-1,
    ).reshape(-1, 3)
    dirs_c /= np.linalg.norm(dirs_c, axis=-1, keepdims=True)
    dirs_w = dirs_c @ R_wc.T

    t_box = _ray_aabb(t_wc, dirs_w, scene.boxes)
    dz = dirs_w[:, 2]
    down = dz < -1e-9
    t_gnd = np.where(down, (scene.ground_z - t_wc[2]) / np.where(down, dz, -1.0), np.inf)
    t = np.minimum(t_box, t_gnd)
    hit = np.isfinite(t) & (t < max_range)

    pts = t_wc + dirs_w * np.where(hit, t, 1.0)[:, None]
    # procedural world-anchored texture
    tex = (
        0.5
        + 0.2 * np.sin(2.1 * pts[:, 0]) * np.cos(1.7 * pts[:, 1])
        + 0.15 * np.sin(3.3 * pts[:, 2] + 0.8 * pts[:, 0])
        + 0.1 * np.sin(9.0 * pts[:, 0] + 7.0 * pts[:, 1])
    )
    shade = 1.0 / (1.0 + 0.01 * np.where(hit, t, max_range))
    img = np.where(hit, np.clip(tex, 0.05, 0.95) * shade, 0.02)
    depth_ray = np.where(hit, t, np.inf)
    # depth map stores z-depth (camera frame), the pinhole convention
    z_cam = (pts - t_wc) @ R_wc  # camera-frame points
    depth = np.where(hit, z_cam[:, 2], np.inf)
    return (
        img.reshape(height, width).astype(np.float32),
        depth.reshape(height, width).astype(np.float32),
    )


def camera_from_velodyne_pose(R_ws: np.ndarray, t_ws: np.ndarray):
    """Camera pose for a forward-looking camera rigidly on the sensor:
    cam z = velo x (forward), cam x = −velo y (right), cam y = −velo z (down)."""
    # columns: cam x=(0,−1,0), cam y=(0,0,−1), cam z=(1,0,0) in the velo frame
    R_sc = np.array(
        [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
    )
    return R_ws @ R_sc, t_ws


def yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@dataclass
class SyntheticSequence:
    """A drive through a corridor scene with exact GT poses."""

    n_frames: int = 20
    speed: float = 1.0          # m/frame
    yaw_rate: float = 0.005     # rad/frame
    width: int = 1800
    noise: float = 0.0
    seed: int = 0
    scene: BoxScene = field(default_factory=lambda: BoxScene.corridor(0))

    #: vertical bounce (m) and roll wobble (rad) amplitudes for "bumpy"
    #: regimes (exercise the IMU fusion path); 0 = smooth drive
    bounce: float = 0.0
    roll_amp: float = 0.0

    def pose(self, k: float) -> tuple[np.ndarray, np.ndarray]:
        """GT sensor→world pose at (possibly fractional) frame k — an arc of
        constant curvature, optionally with bounce/roll perturbations. Being
        analytic in k lets ``synthesize_imu`` sample it at IMU rate."""
        yaw = self.yaw_rate * k
        R = yaw_matrix(yaw)
        if abs(self.yaw_rate) < 1e-9:
            t = np.array([self.speed * k, 0.0, 0.0])
        else:
            rad = self.speed / self.yaw_rate
            t = np.array([rad * np.sin(yaw), rad * (1.0 - np.cos(yaw)), 0.0])
        t = t + np.array([0.0, 0.0, 1.73])  # sensor height
        if self.bounce > 0.0:
            t = t + np.array([0.0, 0.0, self.bounce * np.sin(0.9 * k)])
        if self.roll_amp > 0.0:
            r = self.roll_amp * np.sin(0.7 * k)
            c, s = np.cos(r), np.sin(r)
            R = R @ np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
        return R, t

    def scan(self, k: int) -> np.ndarray:
        R, t = self.pose(k)
        return render_scan(
            self.scene, R, t,
            width=self.width, noise=self.noise, seed=self.seed + k,
        )

    def gt_relative(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """GT motion from frame k to k+1 expressed in frame k:
        T_k_{k+1} = T_w_k^{-1} T_w_{k+1} → (R_rel, t_rel)."""
        R0, t0 = self.pose(k)
        R1, t1 = self.pose(k + 1)
        return R0.T @ R1, R0.T @ (t1 - t0)


@dataclass
class PiecewiseArcSequence(SyntheticSequence):
    """Piecewise constant-curvature drive: harder accuracy regimes than the
    single gentle arc (rotation-heavy turns, S-curves, out-and-back
    revisits). ``segments`` = ((n_frames, speed, yaw_rate), ...); pose(k)
    integrates the arcs in closed form segment by segment, so it stays
    analytic in k (fractional k works → IMU synthesis works too)."""

    segments: tuple = ((20, 1.0, 0.0),)

    def __post_init__(self):
        # segment-start states (yaw, x, y), computed once, exactly
        starts = [(0.0, 0.0, 0.0)]
        for (n, v, w) in self.segments:
            yaw, x, y = starts[-1]
            dyaw = w * n
            if abs(w) < 1e-9:
                x += v * n * np.cos(yaw)
                y += v * n * np.sin(yaw)
            else:
                r = v / w
                x += r * (np.sin(yaw + dyaw) - np.sin(yaw))
                y += r * (np.cos(yaw) - np.cos(yaw + dyaw))
            starts.append((yaw + dyaw, x, y))
        self._starts = starts
        self.n_frames = int(sum(s[0] for s in self.segments)) + 1

    def pose(self, k: float) -> tuple[np.ndarray, np.ndarray]:
        rem = float(k)
        for i, ((n, v, w), (yaw, x, y)) in enumerate(
            zip(self.segments, self._starts)
        ):
            if rem <= n or i == len(self.segments) - 1:
                dyaw = w * rem
                if abs(w) < 1e-9:
                    x += v * rem * np.cos(yaw)
                    y += v * rem * np.sin(yaw)
                else:
                    r = v / w
                    x += r * (np.sin(yaw + dyaw) - np.sin(yaw))
                    y += r * (np.cos(yaw) - np.cos(yaw + dyaw))
                R = yaw_matrix(yaw + dyaw)
                t = np.array([x, y, 1.73])
                if self.bounce > 0.0:
                    t = t + np.array(
                        [0.0, 0.0, self.bounce * np.sin(0.9 * float(k))]
                    )
                return R, t
            rem -= n
        raise ValueError(k)

    @staticmethod
    def out_and_back(leg: int = 12, turn: int = 21, speed: float = 1.0,
                     **kw) -> "PiecewiseArcSequence":
        """Drive out, U-turn, drive back over the same ground — the revisit
        regime where a long-horizon map matters and an 8-frame one fails.
        The default turn rate (π/21 ≈ 0.15 rad/frame at reduced speed) is at
        the edge of what warm-started scan-to-scan can track — rotation
        stress by design."""
        return PiecewiseArcSequence(
            segments=(
                (leg, speed, 0.0),
                (turn, speed * 0.4, np.pi / turn),
                (leg, speed, 0.0),
            ),
            **kw,
        )

    @staticmethod
    def s_curve(leg: int = 15, yaw_rate: float = 0.04, speed: float = 1.0,
                **kw) -> "PiecewiseArcSequence":
        """Rotation-heavy S-curve (|yaw_rate| ≥ 0.03 rad/frame)."""
        return PiecewiseArcSequence(
            segments=((leg, speed, yaw_rate), (leg, speed, -yaw_rate)),
            **kw,
        )


GRAVITY_W = np.array([0.0, 0.0, -9.81])


def synthesize_imu(
    seq: SyntheticSequence,
    *,
    frame_period: float = 0.1,
    rate_hz: float = 100.0,
    accel_noise: float = 0.02,
    gyro_noise: float = 0.002,
    accel_bias: np.ndarray | None = None,
    gyro_bias: np.ndarray | None = None,
    seed: int = 7,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Body-frame IMU stream along the sequence's exact trajectory.

    Samples the analytic pose at IMU rate and differentiates numerically:
    accel measurement aₘ = Rᵀ(a_w − g_w) (a static IMU reads +9.81 up),
    gyro measurement ω = log(RᵀR₊)/dt. This is the data source the
    reference's adjustPointCloud/BackEndSolver path consumes from a real
    IMU (``src/adjustPointCloud.cpp:76-142``).

    Returns (stamps (M,), accel (M, 3), gyro (M, 3)); frame k's lidar stamp
    is k·frame_period, so ``sync.bundle_imu`` slices this stream directly.
    """
    rng = np.random.default_rng(seed)
    dt = 1.0 / rate_hz
    n = int(round((seq.n_frames - 1) * frame_period * rate_hz)) + 1
    stamps = np.arange(n) * dt
    ks = stamps / frame_period                     # fractional frame index
    eps = 1e-3                                     # frames (central diff)

    poses = [seq.pose(k) for k in ks]
    poses_m = [seq.pose(k - eps) for k in ks]
    poses_p = [seq.pose(k + eps) for k in ks]
    h = eps * frame_period                         # seconds

    accel = np.zeros((n, 3))
    gyro = np.zeros((n, 3))
    for i in range(n):
        R, t = poses[i]
        _, tm = poses_m[i]
        Rp, tp = poses_p[i]
        a_w = (tp - 2.0 * t + tm) / (h * h)
        accel[i] = R.T @ (a_w - GRAVITY_W)
        dR = R.T @ Rp                              # body rotation over h
        w_skew = (dR - dR.T) / 2.0
        gyro[i] = (
            np.array([w_skew[2, 1], w_skew[0, 2], w_skew[1, 0]]) / h
        )

    accel += rng.normal(scale=accel_noise, size=accel.shape)
    gyro += rng.normal(scale=gyro_noise, size=gyro.shape)
    if accel_bias is not None:
        accel += accel_bias
    if gyro_bias is not None:
        gyro += gyro_bias
    return (
        stamps.astype(np.float64),
        accel.astype(np.float32),
        gyro.astype(np.float32),
    )
