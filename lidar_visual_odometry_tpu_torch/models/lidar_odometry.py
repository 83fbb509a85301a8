"""Scan-to-scan lidar odometry, ported from
``lidar_visual_odometry_tpu/models/lidar_odometry.py`` (≡ the laserOdometry
node's re-associate → solve loop, ``src/laserOdometry.cpp:364-578``).

* outer loop: corner and surf association (kernel K2) against the previous
  frame's less-sharp / less-flat clouds at the current pose estimate;
* inner loop: ``gn_iters`` Gauss-Newton iterations at fixed correspondences —
  one launch of the fused kernel K3 when de-skew is off, else the
  ``ops/gn.py`` loop.

The adaptive re-association of the reference (a ``lax.while_loop`` that stops
once a round moves the pose by less than ``outer_tol``) checks its exit on the
host once per round from the third round on: one device synchronisation per
round, and only the rounds a frame needs are run.

World pose integrates as ``T_w_curr = T_w_last ∘ T_last_curr``
(``laserOdometry.cpp:581-582``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import gn as kgn
from ..ops import gn, knn, lidar_factors as lf, se3
from ..ops import pointcloud as pc
from ..ops.features import FeatureCloud, ScanFeatures
from ..utils.config import LidarConfig, OdometryConfig
from ..utils.device import resolve_device
from .scan_registration import register_polar_impl

# Host-to-device quantisation of camera-frame clouds (the direct VO chunk's
# upload): uint16 at 3.9 mm over ±128 m, decoded as q·QUANT_SCALE +
# QUANT_OFFSET (the JAX package's ``lidar_odometry.py:216-217``).
QUANT_SCALE = 256.0 / 65536.0
QUANT_OFFSET = -128.0


class OdometryState(NamedTuple):
    pose_w: se3.Pose          # world ← current frame
    pose_rel: se3.Pose        # last ← current (motion prior for the next frame)
    prev_less_sharp: FeatureCloud
    prev_less_flat: FeatureCloud


def _deskew_s(fc: FeatureCloud, deskew: bool) -> torch.Tensor:
    return fc.rel_time if deskew else torch.ones_like(fc.rel_time)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(N, 3) → contiguous (3, N), the fused kernel's layout."""
    return x.T.contiguous()


def scan_to_scan_impl(
    curr: ScanFeatures,
    prev_less_sharp: FeatureCloud,
    prev_less_flat: FeatureCloud,
    init_rel: se3.Pose,
    cfg: OdometryConfig,
) -> se3.Pose:
    """Estimate T_last_curr starting from ``init_rel`` (the constant-velocity
    prior)."""
    sharp, flat = curr.sharp, curr.flat
    s_sharp = _deskew_s(sharp, cfg.deskew)
    s_flat = _deskew_s(flat, cfg.deskew)

    R = cfg.n_rings
    ls_blocks = prev_less_sharp.xyz.reshape(R, -1, 3)
    ls_mask = prev_less_sharp.mask.reshape(R, -1)
    lf_blocks = prev_less_flat.xyz.reshape(R, -1, 3)
    lf_mask = prev_less_flat.mask.reshape(R, -1)
    fused = not cfg.deskew
    if fused:
        edge_p, plane_p = _rows(sharp.xyz), _rows(flat.xyz)

    def outer_once(pose: se3.Pose) -> se3.Pose:
        q_corner = lf._transform_deskewed(pose, sharp.xyz, s_sharp)
        ea = knn.associate_edges_coords(
            q_corner, sharp.mask, ls_blocks, ls_mask,
            dist_sq_threshold=cfg.dist_sq_threshold, nearby_scan=cfg.nearby_scan,
        )
        q_surf = lf._transform_deskewed(pose, flat.xyz, s_flat)
        pa = knn.associate_planes_coords(
            q_surf, flat.mask, lf_blocks, lf_mask,
            dist_sq_threshold=cfg.dist_sq_threshold, nearby_scan=cfg.nearby_scan,
        )
        if fused:
            q, t = kgn.gn_inner_loop(
                pose.q, pose.t,
                edge_p, _rows(ea.a), _rows(ea.b), ea.valid.to(torch.float32)[None],
                plane_p, _rows(pa.j), _rows(pa.l), _rows(pa.m),
                pa.valid.to(torch.float32)[None],
                n_iters=cfg.gn_iters, huber_delta=cfg.huber_delta,
            )
            return se3.Pose(q, t)

        edge = lf.EdgeCorr(p=sharp.xyz, a=ea.a, b=ea.b, s=s_sharp, mask=ea.valid)
        plane = lf.PlaneCorr(p=flat.xyz, j=pa.j, l=pa.l, m=pa.m, s=s_flat, mask=pa.valid)
        for _ in range(cfg.gn_iters):
            re, Je = lf.edge_residuals(pose, edge)
            rp, Jp = lf.plane_residuals(pose, plane)
            we = gn.huber_weight(torch.linalg.vector_norm(re, dim=-1), cfg.huber_delta)
            wp = gn.huber_weight(rp[..., 0].abs(), cfg.huber_delta)
            He, ge = gn.accumulate(re, Je, we, edge.mask)
            Hp, gp = gn.accumulate(rp, Jp, wp, plane.mask)
            pose = gn.gn_update_pose(pose, gn.solve_damped(He + Hp, ge + gp))
        return pose

    pose = init_rel
    if cfg.outer_tol <= 0.0:
        for _ in range(cfg.outer_iters):
            pose = outer_once(pose)
        return pose

    # Adaptive re-association: at least two rounds, then stop as soon as one
    # round moved the pose by no more than outer_tol (m / ~rad).
    prev = pose
    for i in range(cfg.outer_iters):
        if i >= 2:
            dq = torch.max(torch.abs(pose.q - prev.q * torch.sign(torch.sum(pose.q * prev.q))))
            dt = torch.max(torch.abs(pose.t - prev.t))
            if not bool((2.0 * dq > cfg.outer_tol) | (dt > cfg.outer_tol)):
                break
        prev = pose
        pose = outer_once(pose)
    return pose


def init_state(feats: ScanFeatures) -> OdometryState:
    ident = se3.identity_pose(feats.less_sharp.xyz.device)
    return OdometryState(ident, ident, feats.less_sharp, feats.less_flat)


def odometry_step(
    state: OdometryState, feats: ScanFeatures, cfg: OdometryConfig,
    init_rel: se3.Pose | None = None,
) -> tuple[OdometryState, se3.Pose]:
    """One frame: solve T_last_curr (warm-started from ``state.pose_rel``
    unless ``init_rel`` is given), integrate the world pose, roll the feature
    state."""
    rel = scan_to_scan_impl(
        feats, state.prev_less_sharp, state.prev_less_flat,
        state.pose_rel if init_rel is None else init_rel, cfg,
    )
    pose_w = se3.se3_compose(state.pose_w, rel)
    return OdometryState(pose_w, rel, feats.less_sharp, feats.less_flat), pose_w


def odometry_chunk_polar(
    state: OdometryState,
    imgs,                 # (K, R, W, 1|2) uint16 numpy, or int32 cells on a device
    lidar_cfg: LidarConfig,
    odom_cfg: OdometryConfig,
    device="cuda",
) -> tuple[OdometryState, se3.Pose]:
    """K frames of packed polar images: decode → features → scan-to-scan.
    Returns (final state, world poses stacked (K, 4) / (K, 3))."""
    dev = resolve_device(device)
    if isinstance(imgs, np.ndarray):
        imgs = pc.polar_image_to_tensor(imgs, dev)
    imgs = imgs.to(dev)
    qs, ts = [], []
    for k in range(imgs.shape[0]):
        feats = register_polar_impl(imgs[k], lidar_cfg).features
        state, pose_w = odometry_step(state, feats, odom_cfg)
        qs.append(pose_w.q)
        ts.append(pose_w.t)
    return state, se3.Pose(torch.stack(qs), torch.stack(ts))


def _feature_cloud_from_numpy(arrays: Mapping[str, np.ndarray], prefix: str,
                              device: torch.device) -> FeatureCloud:
    def get(key, dtype):
        return torch.tensor(np.asarray(arrays[f"{prefix}_{key}"]), dtype=dtype,
                            device=device)

    return FeatureCloud(
        get("xyz", torch.float32), get("ring", torch.int32),
        get("rel_time", torch.float32), get("mask", torch.bool),
    )


def odometry_state_from_numpy(arrays: Mapping[str, np.ndarray],
                              device="cuda") -> OdometryState:
    """Odometry state from the keys the JAX package's checkpoint writes
    (``utils/checkpoint.py``): ``pose_w_q``, ``pose_w_t``, ``pose_rel_q``,
    ``pose_rel_t`` and ``prev_ls_*`` / ``prev_lf_*`` (xyz, ring, rel_time,
    mask)."""
    dev = resolve_device(device)

    def pose(name):
        return se3.Pose(
            torch.tensor(np.asarray(arrays[f"{name}_q"]), dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(arrays[f"{name}_t"]), dtype=torch.float32, device=dev),
        )

    return OdometryState(
        pose("pose_w"), pose("pose_rel"),
        _feature_cloud_from_numpy(arrays, "prev_ls", dev),
        _feature_cloud_from_numpy(arrays, "prev_lf", dev),
    )
