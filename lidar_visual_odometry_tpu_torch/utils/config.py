"""Typed configuration for the TPU lidar-visual odometry engine.

The port's own copy of ``lidar_visual_odometry_tpu/utils/config.py`` (numpy and
dataclasses only): the port imports nothing from the JAX package, so it
keeps this file verbatim to read the same defaults and scenes.

Replaces the reference's three config layers (ROS launch params, OpenCV-YAML
``Config`` singleton ``src/vloam/Config.cpp:10-203``, gflags) with plain frozen
dataclasses. Defaults mirror the reference's hard-coded constants (SURVEY.md §5
"Config / flag system"): scan period 0.1 s (`scanRegistration.cpp:60`),
DISTANCE_SQ_THRESHOLD 25 / NEARBY_SCAN 2.5 (`laserOdometry.cpp:72-76`),
curvature gate 0.1 (`scanRegistration.cpp:297,352`), cube size 50 m and grid
21×21×11 (`laserMapping.cpp:74-82`), 5-keyframe window (`Frontend.cpp:54`).

All sizes that land on device are static (XLA needs fixed shapes); caps are
padded-with-mask budgets, chosen to cover HDL-64 KITTI scans with headroom.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LidarConfig:
    """Sensor + feature-extraction parameters (≡ scanRegistration)."""

    n_scans: int = 64                 # rings: 16 / 32 / 64
    scan_period: float = 0.1          # s  (scanRegistration.cpp:60)
    min_range: float = 0.1            # m  MINIMUM_RANGE (scanRegistration.cpp:83)
    max_range: float = 120.0
    azimuth_bins: int = 2048          # W of the dense (ring, azimuth) grid; 128-aligned
    n_sectors: int = 6                # azimuthal sectors per ring (scanRegistration.cpp:283)
    curvature_edge_min: float = 0.1   # corner gate (scanRegistration.cpp:297)
    curvature_surf_max: float = 0.1   # flat gate  (scanRegistration.cpp:352)
    max_sharp_per_sector: int = 2     # (scanRegistration.cpp:302)
    max_less_sharp_per_sector: int = 20  # (scanRegistration.cpp:307)
    max_flat_per_sector: int = 4      # (scanRegistration.cpp:361)
    nms_radius: int = 5               # ±5 neighbor suppression (scanRegistration.cpp:319-342)
    nms_gap_sq: float = 0.05          # suppression stops at neighbor jumps > 0.05 m²
    surf_leaf_size: float = 0.2       # less-flat voxel leaf (scanRegistration.cpp:404)
    max_less_flat: int = 32768        # padded cap for downsampled less-flat cloud

    @property
    def max_sharp(self) -> int:
        return self.n_scans * self.n_sectors * self.max_sharp_per_sector

    @property
    def max_less_sharp(self) -> int:
        return self.n_scans * self.n_sectors * self.max_less_sharp_per_sector

    @property
    def max_flat(self) -> int:
        return self.n_scans * self.n_sectors * self.max_flat_per_sector


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan Gauss-Newton (≡ laserOdometry)."""

    dist_sq_threshold: float = 25.0   # correspondence gate (laserOdometry.cpp:72)
    nearby_scan: float = 2.5          # ring window (laserOdometry.cpp:76)
    outer_iters: int = 10             # max re-association rounds (reference:
                                      # fixed 10, laserOdometry.cpp:364)
    outer_tol: float = 1e-3           # early-exit: stop when one round moves
                                      # the pose < tol (m / ~rad). Warm-started
                                      # smooth frames converge in 2-3 rounds;
                                      # sharp turn onsets need all 10 (a fixed
                                      # 5 locks in 9.6° at the out-and-back
                                      # turn: mapped ATE 0.83 vs 0.017 m).
                                      # 0 = fixed outer_iters rounds (old
                                      # behavior, used by schedule tests).
    gn_iters: int = 4                 # inner GN iterations (Ceres max_num_iterations=4)
    huber_delta: float = 0.1          # HuberLoss(0.1) (laserOdometry.cpp:369)
    deskew: bool = False              # DISTORTION 0 (laserOdometry.cpp:66)
    skip_frame_num: int = 1           # feature republish cadence (launch file: 1)
    n_rings: int = 64                 # candidate clouds are ring-major blocks of
                                      # capacity/n_rings (association streams per ring)


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map refinement (≡ laserMapping)."""

    cube_size: float = 50.0           # m per voxel cube (laserMapping.cpp:312-314)
    grid_w: int = 21                  # cubes along x (laserMapping.cpp:77)
    grid_h: int = 21                  # cubes along y
    grid_d: int = 11                  # cubes along z
    corner_leaf: float = 0.4          # lineRes default (laserMapping.cpp:899)
    surf_leaf: float = 0.8            # planeRes default (laserMapping.cpp:900)
    outer_iters: int = 10             # max re-association rounds (reference:
                                      # fixed 10, laserMapping.cpp:562)
    outer_tol: float = 4e-3           # adaptive early-exit (m / ~rad) — same
                                      # scheme as OdometryConfig.outer_tol;
                                      # 0 = fixed outer_iters rounds. Looser
                                      # than odometry's 1e-3: map refinement
                                      # legitimately moves the pose a few mm
                                      # per re-association round, and 1e-3
                                      # made smooth frames pay turn-frame
                                      # cost (TPU sweep: tol 1e-3/2e-3/4e-3 →
                                      # 54/68/72 SLAM fps at rotation ATE
                                      # 0.031/0.032/0.031 m)
    gn_iters: int = 4                 # Ceres max_num_iterations=4 (laserMapping.cpp:715)
    huber_delta: float = 0.1          # (laserMapping.cpp:564)
    knn: int = 5                      # 5-NN line/plane fits (laserMapping.cpp:582,648)
    line_eig_ratio: float = 3.0       # accept line if l2 > 3*l1 (laserMapping.cpp:607)
    plane_fit_tol: float = 0.2        # planarity gate (laserMapping.cpp:673)
    corner_nn_max_dist: float = 1.0   # 5th NN must be < 1 m (laserMapping.cpp:586)
    max_corner_map_local: int = 16384  # padded local submap caps (5x5x3 neighborhood)
    max_surf_map_local: int = 32768
    cube_capacity: int = 4096         # max points stored per 50 m cube, per class
    submap_radius: tuple = (2, 2, 1)  # 5x5x3 neighborhood (laserMapping.cpp:515-519)
    # Device-resident map (models/device_mapping.py + ops/voxel_map.py): a
    # bounded world-frame voxel store per feature class, deduped at the leaf,
    # with farthest-first eviction inside `map_drop_radius` of the pose.
    # corner_slot/surf_slot are the PER-FRAME downsampled feature budgets
    # (query side of the scan-to-map solve). They must hold a full frame:
    # an HDL-64 scan occupies ~3.1k corner voxels @ 0.4 m and ~2.2k surf
    # voxels @ 0.8 m, so 4096 has headroom — an overflowing slot silently
    # drops a hash-ordered subsample, which corrupts NN association (the
    # round-1 regression). TPU tiling: slots must be multiples of 1024
    # (Pallas block_topk query tile), map caps multiples of 512 (c_tile);
    # solve_map_pose derives the actual q_tile as gcd(slot, 1024) so
    # non-aligned CPU test configs still trace.
    corner_slot: int = 4096
    surf_slot: int = 4096
    map_corner_cap: int = 16384       # bounded voxel-map capacities (points)
    map_surf_cap: int = 32768
    map_drop_radius: float = 150.0    # evict beyond this (≡ ±125 m 5x5x3 hood)
    # Cell-windowed 5-NN (ops/pallas_nn.block_topk_windowed): prune candidate
    # chunks by coarse-cell key-range overlap. nn_cell must be ≥ the 1 m
    # association gates (exactness condition); nn_grid_w cells of nn_cell
    # must cover the map extent (256 × 2 m = ±256 m > drop radius).
    windowed_nn: bool = True
    nn_cell: float = 2.0
    nn_grid_w: int = 256
    nn_q_tile: int = 256


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics (≡ Config::camera, PinholeModel)."""

    width: int = 1280                 # padded KITTI gray width (native 1241)
    height: int = 384                 # padded KITTI gray height (native 376)
    fx: float = 718.856               # KITTI odometry 00-02 calibration
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    # radial-tangential distortion (KITTI odometry grayscale is rectified: zeros)
    d0: float = 0.0
    d1: float = 0.0
    d2: float = 0.0
    d3: float = 0.0
    d4: float = 0.0


@dataclass(frozen=True)
class VisualConfig:
    """Visual frontend (≡ featureTracking + Frontend)."""

    pyramid_levels: int = 4           # tracker levels (params/KITTI00.yaml pyramid)
    grid_cols: int = 28               # feature subregions (featureTracking.cpp grid)
    grid_rows: int = 6
    max_features_per_cell: int = 5
    lk_window: int = 25               # LK window size (featureTracking.cpp:203)
    lk_levels: int = 4
    lk_iters: int = 10
    lk_eps: float = 0.01              # per-feature LK step termination in px
                                      # (cv::TermCriteria(COUNT+EPS, 30, 0.01),
                                      # featureTracking.cpp:211); 0 = fixed count.
                                      # TPU Pallas kernel only: the XLA/CPU
                                      # fallback is SIMD across features and
                                      # runs the fixed count — the two paths
                                      # differ by < lk_eps px per level by the
                                      # exit condition (tested in
                                      # test_level_kernel_eps_termination)
    lk_affine: bool = True            # 6-DOF deformation-compensated LK at
                                      # the finest level: affine nuisance
                                      # columns absorb forward-motion patch
                                      # zoom/shear that biases the
                                      # translation-only model (cv LK,
                                      # featureTracking.cpp:203-211, carries
                                      # this bias); measured flow bias
                                      # 0.5→0.02 px on the corridor bench
    lk_reverse_affine: bool | str = True
                                      # reverse-GATE leg solve mode:
                                      # True/"solve" (default), "fixed"
                                      # (translation-only + the forward
                                      # fit's negated affine as a constant
                                      # residual correction), False/"none".
                                      # All three measured on v5e
                                      # (scripts/exp_lk_reverse_affine.py):
                                      # solve 63.7 fps / 0.0821 m, fixed
                                      # 74.6 / 0.1445, none 68.3 / 0.1532
                                      # — the cheap modes cost ~2x
                                      # ate_visual, and "fixed" barely
                                      # beating "none" shows the solve
                                      # gate wins as a per-feature 6-DOF
                                      # model-fit TEST, not by deformation
                                      # compensation (BASELINE.md probes
                                      # table). Keep the affine gate.
    reverse_check_px: float = 1.0     # fwd/bwd consistency gate (featureTracking.cpp:214-237)
    lk_reverse_levels: int = 0        # 0 = full-pyramid reverse (reference);
                                      # n>0: shallow reverse over the finest n
                                      # levels warm-started at the negated
                                      # forward flow (~25-40% LK savings)
    lk_iters_coarse: int = 0          # 0 = lk_iters at every level; n>0 runs
                                      # only n GN iterations on levels > 0
                                      # (coarse levels just need to land in
                                      # the next level's basin, < win/2 px)
    fast_threshold: float = 30.0
    gn_iters: int = 150               # visual GN cap (Frontend.cpp:401); the
                                      # |δ|<gn_tol while_loop early-out makes
                                      # typical frames converge in 10-30 iters
    gn_tol: float = 1e-5              # convergence |dx| (Frontend.cpp:443-447)
    huber_reproj: float = 1.5 / 760.0  # Huber on normalized-plane residual (Frontend.cpp:652)
    max_tracked: int = 1024           # padded tracked-feature budget (28*6*5 = 840)
    depth_cloud_cap: int = 32768      # padded camera-frame lidar cloud
    keyframe_window: int = 5          # KeyframeWindow size (Frontend.cpp:54)
    ba_iters: int = 4                 # window-BA GN round cap per keyframe
    ba_level: int = 0                 # window-BA pyramid level (clamped to
                                      # pyramid_levels-1); the 20-pair one-hot
                                      # sampling matmul scales with level area.
                                      # Level 0 is the accuracy lever: the r4
                                      # frontier (exp_direct_cost, BASELINE)
                                      # measured corridor ATE 0.167 (l1) →
                                      # 0.041 m (l0) at ba_iters=4; fewer
                                      # than 4 iterations leaves the finest
                                      # solve mid-step and is WORSE than a
                                      # converged coarse level
    ba_points: int = 1024             # 0 = every selected host point per BA
                                      # pair; n>0 strides each host keyframe's
                                      # point set down to ~n for BA only.
                                      # 1024 recovers the level-0 fps cost:
                                      # 45.3 → 73.8 fps at ATE 0.039 m (TPU
                                      # frontier, BASELINE.md)
    ba_step_tol: float = 1e-5         # BA early-exit |δ|∞ (LSQNonlinear.hpp:56-60)
    coupled_min_track_ratio: float = 0.5  # coupled warm-start health gate:
                                      # the visual prior feeds the lidar GN
                                      # only while the PRE-replenish
                                      # surviving-track count stays above
                                      # this fraction of max_tracked.
                                      # U-turn blackouts keep the prior
                                      # plausible-SIZED while tracking
                                      # nothing; magnitude gating alone
                                      # measured lidar ATE 0.17 → 4.33 m
                                      # on the revisit regime (bench cam).
                                      # Ratio sweep there: 0.25 → 2.44 m,
                                      # 0.5 → 0.093 (coupling now BEATS
                                      # plain 0.172), 0.75 → 0.172
                                      # (coupling gated off entirely)
    ba_pair_radius: int = 2           # 0 = all K·(K−1) ordered BA pairs
                                      # (WindowOptimizer.cpp:496-520);
                                      # r>0 keeps only |host−target| ≤ r.
                                      # Every per-iteration BA tensor scales
                                      # with the pair count, and r=2 also
                                      # IMPROVES accuracy (0.0391→0.0351 m
                                      # at "high"): the dropped distant
                                      # pairs have the least co-visible
                                      # overlap and mostly contribute
                                      # noise. r=1 over-prunes (0.066 m).
                                      # Sweep: BASELINE.md round-5 roofline
    ba_sample_precision: str = "bf16"  # one-hot MXU patch-sampler pass
                                      # count: "high" = bf16x3 (≈ f32),
                                      # "bf16" = single pass — 3× cheaper
                                      # on the BA's dominant device op
                                      # (95% of MXU peak at "high").
                                      # bf16+r2 = 90.8 fps / 0.0362 m vs
                                      # the r4 default 73.8 / 0.0391
                                      # (better on BOTH axes; sweep in
                                      # BASELINE.md), "highest" = f32x6
    patch_pattern: str = "quad"       # 4-px pattern {(1,-1),(1,1),(-1,-1),(-1,1)} (Tracker2.h:41-44)
    tdist_dof: float = 5.0            # t-distribution nu (WeightFunction.cpp:91-95)
    use_clahe: bool = False           # CLAHE prep (featureTracking.cpp:92-95);
                                      # on for real camera imagery (kitti_config),
                                      # off for synthetic renders (already uniform)
    clahe_clip: float = 3.0           # cv::createCLAHE(3.0, (8, 8))
    clahe_grid: tuple = (8, 8)


@dataclass(frozen=True)
class ExtrinsicConfig:
    """Camera←lidar rigid transform (≡ Config camlidar 3×4, KITTI Tr)."""

    # KITTI odometry seq 00 velodyne→cam0 (Tr from calib.txt)
    matrix: tuple = (
        (4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02),
        (-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02),
        (9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01),
    )


@dataclass(frozen=True)
class SystemConfig:
    lidar: LidarConfig = LidarConfig()
    odometry: OdometryConfig = OdometryConfig()
    mapping: MappingConfig = MappingConfig()
    camera: CameraConfig = CameraConfig()
    visual: VisualConfig = VisualConfig()
    extrinsic: ExtrinsicConfig = ExtrinsicConfig()

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def kitti_config(sequence: int = 0, n_scans: int = 64) -> SystemConfig:
    """Per-sequence config (≡ params/KITTI00.yaml … KITTI10.yaml)."""
    if sequence <= 2:
        cam = CameraConfig()
    elif sequence == 3:
        cam = CameraConfig(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854)
    else:
        cam = CameraConfig(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104)
    return SystemConfig(
        lidar=LidarConfig(n_scans=n_scans),
        camera=cam,
        # lk_iters_coarse: coarse pyramid levels only need to land in the
        # next level's basin — measured free (+12% cam-lidar fps, ATE
        # unchanged; BASELINE.md round-4 trace table)
        visual=VisualConfig(use_clahe=True, lk_iters_coarse=4),
    )
