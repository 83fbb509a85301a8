"""Scan-to-scan association, ported from the kernel branch of
``lidar_visual_odometry_tpu/ops/knn.py`` (``associate_edges_coords`` :325,
``associate_planes_coords`` :364).

The A-LOAM ring-structured searches (``laserOdometry.cpp:384-561``) resolve to
coordinates through kernel K2 (``kernels.nn.associate_kernel``): the nearest
candidate (ring r0), r0's runner-up, and the nearest on a ring within
±``nearby_scan`` of r0, each gated at ``dist_sq_threshold``. Candidate clouds
arrive ring-major as (R, B, 3) blocks with (R, B) masks; masked candidates are
baked to ``BAKE_FAR`` before the search. B is taken as it is (the TPU path pads
it to 128 lanes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import nn


class EdgeAssocCoords(NamedTuple):
    a: torch.Tensor      # (Q, 3) nearest neighbour
    b: torch.Tensor      # (Q, 3) nearest on a different ring within the window
    valid: torch.Tensor


class PlaneAssocCoords(NamedTuple):
    j: torch.Tensor      # nearest
    l: torch.Tensor      # same-ring runner-up
    m: torch.Tensor      # different-ring nearest within the window
    valid: torch.Tensor


def associate_edges_coords(
    q_xyz: torch.Tensor,
    q_mask: torch.Tensor,
    c_blocks: torch.Tensor,
    m_blocks: torch.Tensor,
    *,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> EdgeAssocCoords:
    """Corner association (≡ laserOdometry.cpp:384-465): queries (Q, 3)
    against ring-major candidates (R, B, 3) with masks (R, B)."""
    out = nn.associate_kernel(q_xyz.contiguous(), nn.bake_mask(c_blocks, m_blocks),
                              nearby_scan=nearby_scan)
    valid = q_mask & (out[:, 9] < dist_sq_threshold) & (out[:, 11] < dist_sq_threshold)
    return EdgeAssocCoords(out[:, 0:3], out[:, 6:9], valid)


def associate_planes_coords(
    q_xyz: torch.Tensor,
    q_mask: torch.Tensor,
    c_blocks: torch.Tensor,
    m_blocks: torch.Tensor,
    *,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> PlaneAssocCoords:
    """Surf association (≡ laserOdometry.cpp:468-561), same inputs as
    ``associate_edges_coords``."""
    out = nn.associate_kernel(q_xyz.contiguous(), nn.bake_mask(c_blocks, m_blocks),
                              nearby_scan=nearby_scan)
    valid = (
        q_mask
        & (out[:, 9] < dist_sq_threshold)
        & (out[:, 10] < dist_sq_threshold)
        & (out[:, 11] < dist_sq_threshold)
    )
    return PlaneAssocCoords(out[:, 0:3], out[:, 3:6], out[:, 6:9], valid)
