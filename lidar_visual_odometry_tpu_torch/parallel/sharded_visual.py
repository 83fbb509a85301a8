"""The feature-VO frame step parallel over features, ported from
``lidar_visual_odometry_tpu/parallel/sharded_visual.py``
(≡ ``Frontend::trackfeature``, ``Frontend.cpp:188-515``).

* KLT: each rank tracks its block of the feature table (kernel K6) against
  the replicated pyramids, with no communication;
* depth association and triangulation: each block against the replicated
  depth cloud, with no communication;
* pose GN: each block's epipolar and reprojection rows give partial 6 × 6
  normal equations and the staged gates' counters, and one all-reduce an
  iteration sums them (``solve_pose``'s hook).

``uv1`` and ``ok`` come back whole on every rank (an all-gather). The table
update and replenishment are image-global and stay replicated
(``visual_frontend.update_after_external_solve``, ``_replenish``).
"""

from __future__ import annotations

import torch

from ..models import visual_frontend as vf
from ..ops import se3
from ..utils.config import VisualConfig
from .sharded_odometry import DATA_AXIS, Mesh, make_mesh  # noqa: F401  (re-export)


def sharded_visual_step(
    mesh: Mesh,
    prev_pyr: tuple,
    cur_pyr: tuple,
    prev_dc: vf.DepthCloud,
    table: vf.FeatureTable,
    pose_w: se3.Pose,
    warm_rel: se3.Pose,
    cam,
    cfg: VisualConfig,
) -> tuple[torch.Tensor, torch.Tensor, se3.Pose, se3.Pose]:
    """One feature-VO frame (track → gates → pose GN) with the feature table
    sharded along its capacity (which the world size must divide); the
    pyramids, the depth cloud and the poses are replicated. Returns (uv1, ok,
    T_cur_prev, the new pose_w), as the unsharded track + ``solve_and_update``
    composition gives them."""
    tab = vf.FeatureTable(*(mesh.block(x) for x in table))
    uv1, ok = vf._track(prev_pyr, cur_pyr, tab, cfg)
    _, un0, un1, depth, has_depth, epi_ok = vf.depth_gates(uv1, ok, prev_dc, tab, pose_w, cam)

    def reduce(H, g, n_depth, sum_e):
        return mesh.all_reduce_sum(H, g, n_depth, sum_e)

    rel = vf.solve_pose(warm_rel, un0, un1, depth, has_depth, epi_ok, cfg, reduce_fn=reduce)
    new_pose_w = se3.se3_compose(pose_w, se3.se3_inverse(rel))
    return mesh.gather_blocks(uv1), mesh.gather_blocks(ok), rel, new_pose_w
