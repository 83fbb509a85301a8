"""Scan-to-map refinement, ported from
``lidar_visual_odometry_tpu/models/lidar_mapping.py`` (``solve_map_pose``,
≡ the laserMapping node's 10 × (associate → 4 Ceres iterations),
``laserMapping.cpp:562-721``).

Each round associates the frame's downsampled corner and surf points (lidar
frame) with their 5 nearest map points (world frame), fits lines and planes in
closed form (``ops/fit.py``) and runs ``gn_iters`` Huber Gauss-Newton
iterations in plain PyTorch (``ops/gn.py``, as the reference leaves them to
XLA).

The 5-NN search is kernel K4 (``kernels.topk.block_topk_windowed``) when the
configuration allows the cell window: ``cfg.windowed_nn``, a cell at least as
large as the 1 m gates, and both map capacities a multiple of the 512-point
chunk. Otherwise it is kernel K5 (``block_topk``). The configuration chooses
the branch, on every device; the device only chooses between each kernel and
its plain version. (On the CPU the reference takes a dense XLA search instead;
within the 1 m gates it finds the same neighbours.)

The adaptive re-association checks its exit on the host once per round from
the third round on, as ``lidar_odometry.scan_to_scan_impl`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import topk
from ..kernels.nn import bake_mask
from ..ops import fit, gn, lidar_factors as lf, se3
from ..ops.pointcloud import PointBatch
from ..utils.config import MappingConfig

C_TILE = 512  # candidate chunk of the windowed search (the reference's c_tile)


class LocalMap(NamedTuple):
    corner: PointBatch
    surf: PointBatch


def solve_map_pose(
    corner_q: PointBatch,
    surf_q: PointBatch,
    corner_cand: PointBatch,
    surf_cand: PointBatch,
    init_pose: se3.Pose,
    cfg: MappingConfig,
) -> se3.Pose:
    """World pose of the frame: ``outer_iters`` rounds (adaptive when
    ``outer_tol`` > 0) of 5-NN association → line/plane fits → ``gn_iters``
    GN iterations, from ``init_pose``. An empty map gives H = 0, g = 0 and a
    zero step."""
    corner_pts, corner_mask = corner_q.xyz, corner_q.mask
    surf_pts, surf_mask = surf_q.xyz, surf_q.mask
    local = LocalMap(corner_cand, surf_cand)
    # the cell window (K4) is exact for gates within one cell, and needs the
    # candidate clouds cut into whole chunks
    windowed = (
        cfg.windowed_nn
        and cfg.nn_cell >= max(1.0, cfg.corner_nn_max_dist)
        and corner_cand.xyz.shape[0] % C_TILE == 0
        and surf_cand.xyz.shape[0] % C_TILE == 0
    )

    if windowed:
        ckw = dict(cell=cfg.nn_cell, grid_w=cfg.nn_grid_w)
        origin = init_pose.t[:2] - (cfg.nn_grid_w // 2) * cfg.nn_cell
        prepped = {
            "corner": topk.sort_by_cell(corner_cand.xyz, corner_cand.mask, origin, **ckw),
            "surf": topk.sort_by_cell(surf_cand.xyz, surf_cand.mask, origin, **ckw),
        }
        # queries are searched in the order of their init-pose world cell, so
        # query tiles are spatially tight (efficiency only: tile ranges are
        # recomputed every round); results go back to the input order, so the
        # GN sums in the same order as the dense branch and the two branches
        # give the same poses
        order = {
            which: torch.sort(topk.cell_keys(se3.se3_apply(init_pose, pts), origin, **ckw),
                              stable=True).indices
            for which, pts in (("corner", corner_pts), ("surf", surf_pts))
        }

    def nn5(qpts: torch.Tensor, cands: PointBatch, which: str):
        """(dist (Q, k), neighbour coordinates (Q, k, 3)). Unfilled slots
        (dist 1e30) gather candidate 0; every consumer gates on distance
        first."""
        if windowed:
            c_sorted, c_keys = prepped[which]
            perm = order[which]
            qs = qpts[perm].contiguous()
            dist_s, idx_s = topk.block_topk_windowed(
                qs, topk.cell_keys(qs, origin, **ckw), c_sorted, c_keys, k=cfg.knn,
                q_tile=math.gcd(qpts.shape[0], cfg.nn_q_tile), c_tile=C_TILE,
                grid_w=cfg.nn_grid_w,
            )
            dist = torch.empty_like(dist_s)
            dist[perm] = dist_s
            idx = torch.empty_like(idx_s)
            idx[perm] = idx_s
            return dist, c_sorted[idx.to(torch.int64)]
        baked = bake_mask(cands.xyz, cands.mask).contiguous()
        dist, idx = topk.block_topk(qpts.contiguous(), baked, k=cfg.knn)
        return dist, baked[idx.to(torch.int64)]

    ones = torch.ones(corner_pts.shape[:1], dtype=corner_pts.dtype, device=corner_pts.device)

    def outer_once(pose: se3.Pose) -> se3.Pose:
        # corner → line (laserMapping.cpp:577-621): 5th NN within 1 m
        cdist, cnbrs = nn5(se3.se3_apply(pose, corner_pts), local.corner, "corner")
        centroid, direction, line_ok = fit.line_fit(
            cnbrs, cdist < cfg.corner_nn_max_dist ** 2, eig_ratio=cfg.line_eig_ratio)
        # two virtual points ±0.1 m along the line (laserMapping.cpp:604-609)
        edge = lf.EdgeCorr(p=corner_pts, a=centroid + 0.1 * direction,
                           b=centroid - 0.1 * direction, s=ones,
                           mask=corner_mask & line_ok)
        # surf → plane (laserMapping.cpp:643-687)
        sdist, snbrs = nn5(se3.se3_apply(pose, surf_pts), local.surf, "surf")
        n, d, plane_ok = fit.plane_fit(snbrs, sdist < 1.0, tol=cfg.plane_fit_tol)
        plane = lf.NormPlaneCorr(p=surf_pts, n=n, d=d, mask=surf_mask & plane_ok)

        for _ in range(cfg.gn_iters):
            re, Je = lf.edge_residuals(pose, edge)
            rp, Jp = lf.norm_plane_residuals(pose, plane)
            we = gn.huber_weight(torch.linalg.vector_norm(re, dim=-1), cfg.huber_delta)
            wp = gn.huber_weight(rp[..., 0].abs(), cfg.huber_delta)
            He, ge = gn.accumulate(re, Je, we, edge.mask)
            Hp, gp = gn.accumulate(rp, Jp, wp, plane.mask)
            pose = gn.gn_update_pose(pose, gn.solve_damped(He + Hp, ge + gp))
        return pose

    pose = init_pose
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
