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

``LidarMapping`` is the host cube-map driver (``FullPipeline(device_map=False)``):
``CubeMap`` keeps the reference's unbounded store of 50 m cubes in numpy
(insertion with a per-cube voxel filter, ``laserMapping.cpp:736-801``; the
5 × 5 × 3 neighbourhood gather, ``:512-537``), and ``mapping_step`` refines
each frame's pose against the gathered submap on the device. The default local
caps (16384 corner, 32768 surf points) are whole 512-point chunks, so the
search is K4's cell window.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import topk
from ..kernels.nn import bake_mask
from ..ops import fit, gn, lidar_factors as lf, se3
from ..ops.features import ScanFeatures
from ..ops.pointcloud import PointBatch, voxel_downsample
from ..utils.config import MappingConfig
from ..utils.device import resolve_device
from ..utils.profiler import span

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
    nn_fn=None,
) -> se3.Pose:
    """World pose of the frame: ``outer_iters`` rounds (adaptive when
    ``outer_tol`` > 0) of 5-NN association → line/plane fits → ``gn_iters``
    GN iterations, from ``init_pose``. An empty map gives H = 0, g = 0 and a
    zero step.

    ``nn_fn(qpts, cands, k) -> (dist (Q, k), neighbour coordinates (Q, k,
    3))`` replaces the search (K4 / K5): the sharded step passes the merge of
    every rank's block of the map (``parallel/sharded_mapping.py``)."""
    corner_pts, corner_mask = corner_q.xyz, corner_q.mask
    surf_pts, surf_mask = surf_q.xyz, surf_q.mask
    local = LocalMap(corner_cand, surf_cand)
    # the cell window (K4) is exact for gates within one cell, and needs the
    # candidate clouds cut into whole chunks
    windowed = (
        nn_fn is None
        and cfg.windowed_nn
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
        if nn_fn is not None:
            return nn_fn(qpts, cands, cfg.knn)
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
            with span("mapping.round"):
                pose = outer_once(pose)
        return pose

    # Adaptive re-association: at least two rounds, then stop as soon as one
    # round moved the pose by no more than outer_tol (m / ~rad).
    prev = pose
    for i in range(cfg.outer_iters):
        if i >= 2:
            dq = torch.max(torch.abs(pose.q - prev.q * torch.sign(torch.sum(pose.q * prev.q))))
            dt = torch.max(torch.abs(pose.t - prev.t))
            moved = (2.0 * dq > cfg.outer_tol) | (dt > cfg.outer_tol)
            with span("sync", site="mapping.exit"):
                moved = bool(moved)
            if not moved:
                break
        prev = pose
        with span("mapping.round"):
            pose = outer_once(pose)
    return pose


def mapping_step(
    corner_pts: torch.Tensor, corner_mask: torch.Tensor,
    surf_pts: torch.Tensor, surf_mask: torch.Tensor,
    local: LocalMap,
    init_pose: se3.Pose,
    cfg: MappingConfig,
    nn_fn=None,
) -> se3.Pose:
    """Refine the frame's world pose against the local submap: the features
    (lidar frame) voxel-downsampled at the mapping leaves (kernel K1, flat;
    ``laserMapping.cpp:542-550``), then ``solve_map_pose`` from ``init_pose``
    (wmap_T_odom ∘ the odometry pose, ``laserMapping.cpp:142-146``) with its
    ``nn_fn``."""
    corner_ds = voxel_downsample(corner_pts, corner_mask, leaf=cfg.corner_leaf, max_out=4096)
    surf_ds = voxel_downsample(surf_pts, surf_mask, leaf=cfg.surf_leaf, max_out=8192)
    return solve_map_pose(corner_ds, surf_ds, local.corner, local.surf, init_pose, cfg, nn_fn)


class CubeMap:
    """Host store of 50 m cubes for one feature class (numpy), the
    reference's own host structure."""

    def __init__(self, cube_size: float, leaf: float, device="cuda"):
        self.cube_size = cube_size
        self.leaf = leaf
        self.device = resolve_device(device)
        self.cubes: dict[tuple[int, int, int], np.ndarray] = {}

    def _key(self, xyz: np.ndarray) -> np.ndarray:
        # cube i covers [(i-0.5)·50, (i+0.5)·50) (laserMapping.cpp:312-321
        # with the negative-floor correction)
        return np.floor(xyz / self.cube_size + 0.5).astype(np.int64)

    def insert(self, xyz: np.ndarray) -> None:
        """Insert points, then re-voxel-filter the touched cubes
        (laserMapping.cpp:736-801)."""
        if xyz.size == 0:
            return
        keys = self._key(xyz)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        for i, k in enumerate(map(tuple, uniq)):
            pts = xyz[inv == i]
            old = self.cubes.get(k)
            allpts = pts if old is None else np.concatenate([old, pts])
            self.cubes[k] = self._voxel_filter(allpts)

    def _voxel_filter(self, pts: np.ndarray) -> np.ndarray:
        q = np.floor(pts / self.leaf).astype(np.int64)
        _, idx_start, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
        inv = inv.reshape(-1)
        sums = np.zeros((idx_start.shape[0], 3), np.float64)
        np.add.at(sums, inv, pts)
        cnt = np.bincount(inv, minlength=idx_start.shape[0])[:, None]
        return (sums / cnt).astype(np.float32)

    def gather_local(self, center_xyz: np.ndarray, radius: tuple[int, int, int],
                     cap: int) -> PointBatch:
        """The (2rx+1)×(2ry+1)×(2rz+1) cube neighbourhood around the pose,
        padded to ``cap`` (laserMapping.cpp:512-537), on the map's device."""
        ck = self._key(center_xyz[None])[0]
        parts = []
        for dx in range(-radius[0], radius[0] + 1):
            for dy in range(-radius[1], radius[1] + 1):
                for dz in range(-radius[2], radius[2] + 1):
                    c = self.cubes.get((ck[0] + dx, ck[1] + dy, ck[2] + dz))
                    if c is not None:
                        parts.append(c)
        pts = np.concatenate(parts) if parts else np.zeros((0, 3), np.float32)
        if pts.shape[0] > cap:
            # deterministic subsample: every k-th point
            stride = pts.shape[0] // cap + 1
            pts = pts[::stride][:cap]
        out = np.zeros((cap, 3), np.float32)
        mask = np.zeros((cap,), bool)
        out[: pts.shape[0]] = pts
        mask[: pts.shape[0]] = True
        return PointBatch(torch.from_numpy(out).to(self.device),
                          torch.from_numpy(mask).to(self.device))


class LidarMapping:
    """Host cube-map driver (≡ laserMapping): the map-corrected pose, the
    submap gathered on the host, the solve on the device, the cube
    bookkeeping on the host (one synchronisation a frame)."""

    def __init__(self, cfg: MappingConfig = MappingConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.corner_map = CubeMap(cfg.cube_size, cfg.corner_leaf, self.device)
        self.surf_map = CubeMap(cfg.cube_size, cfg.surf_leaf, self.device)
        # wmap_T_odom drift correction (laserMapping.cpp:110-117)
        self.correction = se3.identity_pose(self.device)
        self.initialized = False

    def process(self, feats: ScanFeatures, odom_pose: se3.Pose, *, step=mapping_step,
                map_frame: bool = True) -> se3.Pose:
        """Refine the odometry pose against the map with ``step`` (a
        ``mapping_step``), insert the frame's features at the refined pose;
        returns the refined world pose. A frame off the mapping cadence
        (``map_frame`` false; ``laserOdometry.cpp:274-276``) is neither
        refined nor inserted: it returns the map-corrected odometry pose."""
        init = se3.se3_compose(self.correction, odom_pose)
        if not map_frame:
            return init
        corner = feats.less_sharp.xyz.cpu().numpy()
        corner_m = feats.less_sharp.mask.cpu().numpy()
        surf = feats.less_flat.xyz.cpu().numpy()
        surf_m = feats.less_flat.mask.cpu().numpy()

        if self.initialized:
            t_np = init.t.cpu().numpy()
            local = LocalMap(
                self.corner_map.gather_local(t_np, self.cfg.submap_radius,
                                             self.cfg.max_corner_map_local),
                self.surf_map.gather_local(t_np, self.cfg.submap_radius,
                                           self.cfg.max_surf_map_local),
            )
            refined = step(feats.less_sharp.xyz, feats.less_sharp.mask,
                           feats.less_flat.xyz, feats.less_flat.mask, local, init, self.cfg)
        else:
            refined = init
            self.initialized = True

        # wmap_T_odom = refined ∘ odom⁻¹ (transformUpdate)
        self.correction = se3.se3_compose(refined, se3.se3_inverse(odom_pose))

        # insert the features in the world frame
        Rw = se3.quat_to_matrix(refined.q).cpu().numpy()
        tw = refined.t.cpu().numpy()
        self.corner_map.insert(corner[corner_m] @ Rw.T + tw)
        self.surf_map.insert(surf[surf_m] @ Rw.T + tw)
        return refined
