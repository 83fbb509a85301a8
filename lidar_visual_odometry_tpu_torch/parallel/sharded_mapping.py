"""Scan-to-map refinement with the local submap sharded over ranks, ported
from ``lidar_visual_odometry_tpu/parallel/sharded_mapping.py``.

The map is what grows with the trajectory, so its capacity is the sharded
axis: each rank holds a block of the gathered local submap, answers the 5-NN
queries against it (``knn.knn`` with a running top-k over column blocks, the
JAX package's search here, which has no TPU kernel), and the candidates of
all ranks merge through one all-gather of (Q, k) distances and (Q, k, 3)
coordinates, packed as one (Q, k, 4) buffer. The rest is
``lidar_mapping.mapping_step`` with this merged search as its ``nn_fn``: the
line and plane fits, the Gauss-Newton loops and the adaptive exit run
replicated, identical on every rank, so every rank reads the same exit and
leaves together.
"""

from __future__ import annotations

from functools import partial

import torch

from ..models.lidar_mapping import LocalMap, mapping_step
from ..ops import knn, se3
from ..ops.pointcloud import PointBatch
from ..utils.config import MappingConfig
from .sharded_odometry import Mesh

KNN_CHUNK = 2048


def _nn_merged(mesh: Mesh, qpts: torch.Tensor, cands: PointBatch,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist (Q, k), neighbour coordinates (Q, k, 3)) over every rank's block
    of the submap: the rank's k best, then the k best of the D·k gathered,
    the lower rank and slot first among equal distances (as ``lax.top_k``
    over the JAX package's rank-major candidates). A pair's distance does not
    depend on the block (``knn.sqdist_by_axis``), so the merge finds what one
    rank finds over the whole map."""
    c_xyz = mesh.block(cands.xyz)
    idx, dist = knn.knn(qpts, c_xyz, mesh.block(cands.mask), k, chunk=KNN_CHUNK)
    mine = torch.cat([dist[..., None], c_xyz[idx]], dim=-1)          # (Q, k, 4)
    every = mesh.all_gather(mine)                                     # (D, Q, k, 4)
    Q = qpts.shape[0]
    cand = every.permute(1, 0, 2, 3).reshape(Q, mesh.size * k, 4)
    sel, best = knn._smallest_k(cand[..., 0], k)
    return best, cand[..., 1:].gather(1, sel[..., None].expand(Q, k, 3))


def sharded_mapping_step(
    mesh: Mesh,
    corner_pts: torch.Tensor, corner_mask: torch.Tensor,
    surf_pts: torch.Tensor, surf_mask: torch.Tensor,
    local: LocalMap,
    init_pose: se3.Pose,
    cfg: MappingConfig,
) -> se3.Pose:
    """The distributed ``lidar_mapping.mapping_step``: the features
    (replicated) voxel-downsampled at the mapping leaves (kernel K1, flat),
    then ``outer_iters`` rounds (adaptive when ``outer_tol`` > 0) of the
    merged 5-NN, line / plane fits and ``gn_iters`` GN iterations. The local
    corner and surf submaps shard along their capacity, which the world size
    must divide. Returns the refined world pose, replicated."""
    return mapping_step(corner_pts, corner_mask, surf_pts, surf_mask, local, init_pose, cfg,
                        nn_fn=partial(_nn_merged, mesh))
