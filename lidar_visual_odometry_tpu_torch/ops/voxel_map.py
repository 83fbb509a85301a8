"""Bounded voxel map on the device, ported from
``lidar_visual_odometry_tpu/ops/voxel_map.py``.

The map of one feature class is a fixed-capacity (cap, 3) world-frame point
tensor with a (cap,) mask; ``voxel_merge`` inserts one frame's points as a
pure sort pipeline (the reference's 21×21×11 cube store with per-cube voxel
filtering and recentering, ``laserMapping.cpp:74-104, 323-507, 736-801``):

1. concatenate map and new points; drop points beyond ``drop_radius`` of the
   pose;
2. quantise to leaf cells on a grid whose origin follows the pose in steps of
   ``origin_quantum`` leaves, so cell boundaries never move under stored
   points;
3. one stable sort by (distance bucket, cell hash, cell xy, cell z, source):
   equal cells land together, near cells first, map points before new points
   of the same cell;
4. keep the first point of every cell (the oldest observation) and compact
   those to the front, in sorted order, truncated to ``cap``: on overflow the
   farthest cells go first.

The five keys take about 73 bits once masked points are counted, so the
stable sort runs in two passes: low (cell xy, cell z, source), then high
(masked, distance bucket, hash).
"""

from __future__ import annotations

import torch

from .pointcloud import PointBatch, _recip32, stable_order, voxel_hash


def voxel_merge(
    map_xyz: torch.Tensor,    # (M, 3) world-frame map points
    map_mask: torch.Tensor,   # (M,)
    new_xyz: torch.Tensor,    # (S, 3) world-frame new points
    new_mask: torch.Tensor,   # (S,)
    center: torch.Tensor,     # (3,) current pose position (eviction anchor)
    *,
    leaf: float,
    cap: int,
    drop_radius: float = 150.0,
    origin_quantum: int = 64,
) -> PointBatch:
    """Insert ``new`` into ``map`` and return the merged map, capped at ``cap``:
    at most one point per ``leaf`` cell (the first observation), the cells
    farthest from ``center`` evicted first."""
    pts = torch.cat([map_xyz, new_xyz])
    mask = torch.cat([map_mask, new_mask])
    src = torch.cat([torch.zeros(map_xyz.shape[0], dtype=torch.int64, device=pts.device),
                     torch.ones(new_xyz.shape[0], dtype=torch.int64, device=pts.device)])

    d2 = torch.sum((pts - center) ** 2, dim=-1)
    mask = mask & (d2 < drop_radius * drop_radius)

    # leaf-aligned origin that steps with the pose: the grid covers
    # center ± 1024 leaves
    oq = origin_quantum * leaf
    origin = (torch.floor(center * _recip32(oq)) - (1024 // origin_quantum)) * oq
    q = torch.clamp(torch.floor((pts - origin) * _recip32(leaf)).to(torch.int32), 0, 2047)
    q64 = q.to(torch.int64)
    kxy = q64[:, 0] * 2048 + q64[:, 1]

    # eviction priority: quadratic distance buckets, ~16 m wide up close
    db = torch.clamp(d2 * (1.0 / 256.0), max=127.0).to(torch.int64)
    high = torch.where(mask, (db << 31) | voxel_hash(q), torch.full_like(db, 1 << 38))
    # masked points carry the reference's INT32_MAX cell keys: one value
    # above every real key, in each field
    low_kxy = torch.where(mask, kxy, torch.full_like(kxy, 1 << 22))
    low_kz = torch.where(mask, q64[:, 2], torch.full_like(kxy, 1 << 11))
    low = (((low_kxy << 12) | low_kz) << 1) | src
    order = stable_order(high, low)

    cell_s = (low >> 1)[order]
    pts_s = pts[order]
    mask_s = mask[order]
    is_start = torch.ones_like(mask_s)
    is_start[1:] = cell_s[1:] != cell_s[:-1]
    is_start = is_start & mask_s

    # compact run starts to the front, keeping the priority order
    keep = torch.sort((~is_start).to(torch.int8), stable=True).indices[:cap]
    return PointBatch(pts_s[keep], is_start[keep])
