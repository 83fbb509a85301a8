"""Scan registration: raw cloud or polar image → feature clouds, ported from
``lidar_visual_odometry_tpu/models/scan_registration.py`` (≡ the
scanRegistration node, ``src/scanRegistration.cpp:114-459``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import features as F
from ..ops import pointcloud as pc
from ..utils.config import LidarConfig
from ..utils.device import resolve_device


class RegisteredScan(NamedTuple):
    features: F.ScanFeatures
    full: pc.CompactScan  # ≡ /velodyne_cloud_2


def _extract(cs: pc.CompactScan, cfg: LidarConfig) -> F.ScanFeatures:
    return F.extract_features(
        cs,
        n_sectors=cfg.n_sectors,
        max_sharp=cfg.max_sharp_per_sector,
        max_less_sharp=cfg.max_less_sharp_per_sector,
        max_flat=cfg.max_flat_per_sector,
        edge_gate=cfg.curvature_edge_min,
        surf_gate=cfg.curvature_surf_max,
        surf_leaf=cfg.surf_leaf_size,
        max_less_flat_per_ring=cfg.max_less_flat // cfg.n_scans,
    )


def register_scan_impl(points: torch.Tensor, mask: torch.Tensor,
                       cfg: LidarConfig) -> RegisteredScan:
    cs = pc.build_compact_scan(
        points, mask, n_scans=cfg.n_scans, width=cfg.azimuth_bins,
        min_range=cfg.min_range, max_range=cfg.max_range,
    )
    return RegisteredScan(_extract(cs, cfg), cs)


def register_polar_impl(img: torch.Tensor, cfg: LidarConfig) -> RegisteredScan:
    """Features from a polar image already on the device (int32 cells,
    ``pointcloud.polar_image_to_tensor``)."""
    cs = pc.polar_to_compact(
        img, n_scans=cfg.n_scans, width=cfg.azimuth_bins,
        min_range=cfg.min_range, max_range=cfg.max_range,
    )
    return RegisteredScan(_extract(cs, cfg), cs)


def register_scan(points, mask, cfg: LidarConfig, device="cuda") -> RegisteredScan:
    """Register one padded raw scan: points (N, 3) float32 and mask (N,) bool,
    numpy or tensors, moved to ``device``."""
    dev = resolve_device(device)
    return register_scan_impl(
        torch.as_tensor(points, dtype=torch.float32, device=dev),
        torch.as_tensor(mask, dtype=torch.bool, device=dev),
        cfg,
    )


def register_polar(img, cfg: LidarConfig, device="cuda") -> RegisteredScan:
    """Register one packed polar image: (R, W, 1|2) uint16 numpy
    (``pointcloud.pack_polar_scan``) or int32 cells already on a device."""
    dev = resolve_device(device)
    if isinstance(img, np.ndarray):
        img = pc.polar_image_to_tensor(img, dev)
    return register_polar_impl(img.to(dev), cfg)
