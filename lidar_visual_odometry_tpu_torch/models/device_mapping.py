"""Device-resident scan-to-map refinement, ported from
``lidar_visual_odometry_tpu/models/device_mapping.py`` (≡ laserMapping).

The local map stays on the device as a bounded voxel store per feature class
(``ops/voxel_map.voxel_merge``: one point per 0.4 / 0.8 m cell, farthest cells
evicted first, recentred by index arithmetic); each mapped frame is
downsample (kernel K1, flat) → ``lidar_mapping.solve_map_pose`` against the
stored map (kernel K4 or K5) → merge. The correction ``wmap_T_odom``
(``laserMapping.cpp:142-152``) lives in the carried state, so frames between
mapped ones (``map_skip`` ≥ 2) compose it with their odometry pose.

``slam_chunk_polar`` (packed polar images) and ``slam_chunk_quantized``
(uint16 points and counts, the reference's default ingest) run K frames of the
whole lidar chain, decode → features → scan-to-scan → scan-to-map → merge, as
the reference's fused chunk programs do. ``DeviceMapping`` is the per-frame
driver of the same map.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..ops import pointcloud as pc
from ..ops import se3
from ..ops.features import ScanFeatures
from ..ops.pointcloud import PointBatch, voxel_downsample
from ..ops.voxel_map import voxel_merge
from ..utils.config import LidarConfig, MappingConfig, OdometryConfig
from ..utils.device import resolve_device
from ..utils.profiler import span
from .lidar_mapping import solve_map_pose
from .lidar_odometry import OdometryState, dequantize, odometry_step
from .scan_registration import register_polar_impl, register_scan_impl


class DeviceMapState(NamedTuple):
    corner: torch.Tensor       # (map_corner_cap, 3) world frame
    corner_mask: torch.Tensor  # (map_corner_cap,)
    surf: torch.Tensor         # (map_surf_cap, 3)
    surf_mask: torch.Tensor    # (map_surf_cap,)
    correction: se3.Pose       # wmap_T_odom


def init_state(cfg: MappingConfig, device="cuda") -> DeviceMapState:
    """An empty map and the identity correction."""
    dev = resolve_device(device)
    return DeviceMapState(
        corner=torch.zeros((cfg.map_corner_cap, 3), device=dev),
        corner_mask=torch.zeros((cfg.map_corner_cap,), dtype=torch.bool, device=dev),
        surf=torch.zeros((cfg.map_surf_cap, 3), device=dev),
        surf_mask=torch.zeros((cfg.map_surf_cap,), dtype=torch.bool, device=dev),
        correction=se3.identity_pose(dev),
    )


def device_map_state_from_numpy(arrays: Mapping[str, np.ndarray],
                                device="cuda") -> DeviceMapState:
    """Map state from the keys the JAX package's checkpoint writes for it
    (``utils/checkpoint.py``: ``mapst_0`` … ``mapst_5`` = corner, corner mask,
    surf, surf mask, correction q, correction t, in pytree leaf order)."""
    dev = resolve_device(device)

    def get(i, dtype):
        return torch.tensor(np.asarray(arrays[f"mapst_{i}"]), dtype=dtype, device=dev)

    return DeviceMapState(
        get(0, torch.float32), get(1, torch.bool), get(2, torch.float32), get(3, torch.bool),
        se3.Pose(get(4, torch.float32), get(5, torch.float32)),
    )


def device_mapping_impl(
    state: DeviceMapState,
    corner_pts: torch.Tensor, corner_mask: torch.Tensor,
    surf_pts: torch.Tensor, surf_mask: torch.Tensor,
    odom_pose: se3.Pose,
    cfg: MappingConfig,
) -> tuple[DeviceMapState, se3.Pose]:
    """One mapped frame: downsample → solve → insert. Returns (new state,
    refined world pose). On the first frame the map is empty, the solve takes
    a zero step and the frame seeds the map."""
    with span("mapping"):
        with span("mapping.filter"):
            corner_ds = voxel_downsample(corner_pts, corner_mask, leaf=cfg.corner_leaf,
                                         max_out=cfg.corner_slot)
            surf_ds = voxel_downsample(surf_pts, surf_mask, leaf=cfg.surf_leaf,
                                       max_out=cfg.surf_slot)
        refined = solve_map_pose(
            corner_ds, surf_ds,
            PointBatch(state.corner, state.corner_mask), PointBatch(state.surf, state.surf_mask),
            se3.se3_compose(state.correction, odom_pose), cfg,
        )
        with span("mapping.merge"):
            new_corner = voxel_merge(
                state.corner, state.corner_mask, se3.se3_apply(refined, corner_ds.xyz),
                corner_ds.mask, refined.t, leaf=cfg.corner_leaf, cap=cfg.map_corner_cap,
                drop_radius=cfg.map_drop_radius,
            )
            new_surf = voxel_merge(
                state.surf, state.surf_mask, se3.se3_apply(refined, surf_ds.xyz), surf_ds.mask,
                refined.t, leaf=cfg.surf_leaf, cap=cfg.map_surf_cap,
                drop_radius=cfg.map_drop_radius,
            )
        new_state = DeviceMapState(
            new_corner.xyz, new_corner.mask, new_surf.xyz, new_surf.mask,
            se3.se3_compose(refined, se3.se3_inverse(odom_pose)),
        )
    return new_state, refined


def _apply_correction(correction: se3.Pose, odom_pose: se3.Pose) -> se3.Pose:
    return se3.se3_compose(correction, odom_pose)


def _slam_scan(odo_state: OdometryState, map_state: DeviceMapState, n_frames: int, feats_of,
               odom_cfg: OdometryConfig, map_cfg: MappingConfig, start_idx: int,
               map_skip: int, init_of=None):
    """Frame by frame: features (``feats_of(i)``) → odometry (warm-started
    by ``init_of(i, odo_state)`` where given) → mapping on frames whose
    global index ``start_idx + i`` is a multiple of ``map_skip``, else the
    carried correction composed with the odometry pose. Returns (odometry
    state, map state, odometry poses (K,), mapped poses (K,))."""
    odom, mapped = [], []
    for i in range(n_frames):
        with span("frame"):
            with span("features"):
                feats = feats_of(i)
            init = None if init_of is None else init_of(i, odo_state)
            with span("odometry"):
                odo_state, pose_w = odometry_step(odo_state, feats, odom_cfg, init_rel=init)
            if map_skip <= 1 or (start_idx + i) % map_skip == 0:
                map_state, refined = device_mapping_impl(
                    map_state, feats.less_sharp.xyz, feats.less_sharp.mask,
                    feats.less_flat.xyz, feats.less_flat.mask, pose_w, map_cfg,
                )
            else:
                refined = _apply_correction(map_state.correction, pose_w)
            odom.append(pose_w)
            mapped.append(refined)

    def stack(poses):
        return se3.Pose(torch.stack([p.q for p in poses]), torch.stack([p.t for p in poses]))

    return odo_state, map_state, stack(odom), stack(mapped)


def slam_chunk_polar(
    odo_state: OdometryState,
    map_state: DeviceMapState,
    imgs,                 # (K, R, W, 1|2) uint16 numpy, or int32 cells on a device
    lidar_cfg: LidarConfig,
    odom_cfg: OdometryConfig,
    map_cfg: MappingConfig,
    start_idx: int = 0,
    map_skip: int = 1,
    device="cuda",
    init_of=None,
):
    """K frames of packed polar images through the whole lidar chain, frame
    i's odometry warm-started by ``init_of(i, odo_state)`` where given.
    Returns (odometry state, map state, odometry poses (K,), mapped poses
    (K,))."""
    dev = resolve_device(device)
    if isinstance(imgs, np.ndarray):
        imgs = pc.polar_image_to_tensor(imgs, dev)
    imgs = imgs.to(dev)
    return _slam_scan(
        odo_state, map_state, imgs.shape[0],
        lambda i: register_polar_impl(imgs[i], lidar_cfg).features,
        odom_cfg, map_cfg, start_idx, map_skip, init_of,
    )


def slam_chunk_quantized(
    odo_state: OdometryState,
    map_state: DeviceMapState,
    qpts: torch.Tensor,      # (K, N, 3) uint16 codes (or int16 with their bits)
    counts: torch.Tensor,    # (K,) int32
    lidar_cfg: LidarConfig,
    odom_cfg: OdometryConfig,
    map_cfg: MappingConfig,
    start_idx: int = 0,
    map_skip: int = 1,
):
    """K quantised scans (``lidar_odometry.quantize_scan``) through the whole
    lidar chain, decoded on the device with the mask from the counts. Returns
    (odometry state, map state, odometry poses (K,), mapped poses (K,))."""
    idx = torch.arange(qpts.shape[1], dtype=torch.int32, device=qpts.device)
    return _slam_scan(
        odo_state, map_state, qpts.shape[0],
        lambda i: register_scan_impl(dequantize(qpts[i]), idx < counts[i], lidar_cfg).features,
        odom_cfg, map_cfg, start_idx, map_skip,
    )


class DeviceMapping:
    """Per-frame driver of the device-resident map: the same state and step
    as the chunk programs, one frame at a time, with no host synchronisation."""

    def __init__(self, cfg: MappingConfig = MappingConfig(), device="cuda"):
        self.cfg = cfg
        self.state = init_state(cfg, device)
        self._frame = 0

    def process(self, feats: ScanFeatures, odom_pose: se3.Pose, skip: int = 1) -> se3.Pose:
        """Refine ``odom_pose`` against the map every ``skip`` frames (≡
        mapping_skip_frame); in between, compose the last correction."""
        if self._frame % skip == 0:
            self.state, refined = device_mapping_impl(
                self.state, feats.less_sharp.xyz, feats.less_sharp.mask,
                feats.less_flat.xyz, feats.less_flat.mask, odom_pose, self.cfg,
            )
        else:
            refined = _apply_correction(self.state.correction, odom_pose)
        self._frame += 1
        return refined

    def export_map(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copy of the live map: (corner, surf) world points, for
        ``lidar_mapping.CubeMap.insert``."""
        st = self.state
        return (st.corner[st.corner_mask].cpu().numpy(), st.surf[st.surf_mask].cpu().numpy())
