"""Visual odometry frontend (≡ featureTracking + Frontend::trackfeature), ported
from ``lidar_visual_odometry_tpu/models/visual_frontend.py``.

DEMO-style sparse visual odometry with lidar depth: a fixed-capacity feature
table (slots + active mask) replaces the reference's id-keyed maps
(``Frontend.cpp:188-515``), and every per-feature loop is a batched tensor op:

* KLT tracking with a reverse check → ``ops/lk.py`` (kernel K6);
* per-subregion replenishment → dense corner score + per-cell top-k into free
  slots (``featureTracking.cpp:300-385``);
* depth association: 3-NN in the "10-plane" depth cloud
  ``(10·x/z, 10·y/z, 10)`` + ray/plane intersection with the reference's
  gates (``Frontend.cpp:237-301``);
* two-view triangulation against each feature's first observation
  (``Frontend.cpp:303-381``);
* pose GN over epipolar + linear-reprojection residuals with the staged
  outlier gates (``Frontend.cpp:517-746``), update ``t += δt; q ← δq·q``.

The reference's epipolar Jacobian transcription bug (``Frontend.cpp:595-600``)
is not reproduced, as in the JAX package.

``solve_pose`` runs up to ``gn_iters`` iterations with the ``|δ| < gn_tol``
exit. The exit is read on the host once every ``SOLVE_CHECK_EVERY``
iterations (one device synchronisation each); a converged state is frozen
with ``torch.where`` until then, so the result is the JAX ``while_loop``'s.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import gn, image, knn, lk, se3
from ..ops.pointcloud import _recip32
from ..utils.config import VisualConfig
from ..utils.device import resolve_device
from .lidar_odometry import dequantize

SOLVE_CHECK_EVERY = 8

#: since the last ``reset_stats``: frames tracked by ``chunk_frame_step``,
#: features tracked into them (before replenishment), ``solve_pose`` calls
#: and the Gauss-Newton iterations they ran; the two sums stay device
#: tensors until read, so counting adds no host synchronisation
stats = {"frames": 0, "tracked": 0, "solve_calls": 0, "solve_iterations": 0}


def reset_stats() -> None:
    stats.update(frames=0, tracked=0, solve_calls=0, solve_iterations=0)


class FeatureTable(NamedTuple):
    """Fixed-slot feature store (slot index = identity while active)."""

    uv: torch.Tensor        # (N, 2) pixel coords in the current frame
    active: torch.Tensor    # (N,) bool
    depth: torch.Tensor     # (N,) camera z in the current frame; ≤ 0 = unknown
    start_un: torch.Tensor  # (N, 2) normalized coords at first observation
    start_q: torch.Tensor   # (N, 4) Tw at first observation
    start_t: torch.Tensor   # (N, 3)
    age: torch.Tensor       # (N,) int32 frames tracked
    flow: torch.Tensor      # (N, 2) px displacement over the last frame (LK warm start)


class DepthCloud(NamedTuple):
    """Camera-frame lidar returns in the 10-plane parameterization."""

    plane10: torch.Tensor   # (M, 3) = (10·x/z, 10·y/z, 10)
    z: torch.Tensor         # (M,)
    mask: torch.Tensor      # (M,)


class VisualChunkState(NamedTuple):
    """Carried state of the chunked visual frontend."""

    table: FeatureTable
    pose_w: se3.Pose
    warm_rel: se3.Pose
    prev_pyr: tuple         # previous frame's image pyramid
    prev_dc: DepthCloud


def empty_table(n: int, device="cuda") -> FeatureTable:
    """An unused table of ``n`` slots on ``device`` (the card unless the
    caller asks for the CPU; raises without a card)."""
    device = resolve_device(device)
    return FeatureTable(
        uv=torch.zeros((n, 2), device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        depth=torch.full((n,), -1.0, device=device),
        start_un=torch.zeros((n, 2), device=device),
        start_q=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1),
        start_t=torch.zeros((n, 3), device=device),
        age=torch.zeros((n,), dtype=torch.int32, device=device),
        flow=torch.zeros((n, 2), device=device),
    )


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device."""
    return torch.sqrt(x.double()).float()


def _ones_col(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x[..., :1])


def build_depth_cloud(pts_cam: torch.Tensor, mask: torch.Tensor,
                      min_z: float = 0.3) -> DepthCloud:
    """Camera-frame cloud → 10-plane cloud (Frame::initialize_pc,
    Frame.cpp:289-352)."""
    z = pts_cam[..., 2]
    ok = mask & (z > min_z)
    safe_z = torch.where(ok, z, torch.ones_like(z))
    plane10 = torch.stack([10.0 * pts_cam[..., 0] / safe_z, 10.0 * pts_cam[..., 1] / safe_z,
                           torch.full_like(z, 10.0)], dim=-1)
    return DepthCloud(torch.where(ok[..., None], plane10, torch.full_like(plane10, 1e6)), z, ok)


def associate_depth(un: torch.Tensor, active: torch.Tensor,
                    dc: DepthCloud) -> tuple[torch.Tensor, torch.Tensor]:
    """Lidar depth for features at normalized coords un (N, 2): 3-NN in the
    10-plane cloud (nearest < 0.5), ray ∩ 3-point plane depth by the
    closed-form determinant ratio, with the reference's spread/clamp gates
    (Frontend.cpp:245-296). Returns (depth (N,), ok (N,))."""
    q = torch.cat([10.0 * un, torch.full_like(un[:, :1], 10.0)], dim=-1)
    idx, dist = knn.knn(q, dc.plane10, dc.mask, 3)
    z = dc.z[idx]                                   # (N, 3)
    p10 = dc.plane10[idx]                           # (N, 3, 3)
    # a true division, as the reference function and an unjitted run compute
    # it: XLA's jit multiplies by the reciprocal, whose +1.5e-8 relative scale
    # of x and y leans the depths of this heavily cancelling determinant
    # (ROADMAP C.7). The divisor is a tensor: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal too
    ten = torch.full_like(z, 10.0)
    px = p10[..., 0] * z / ten
    py = p10[..., 1] * z / ten
    x1, x2, x3 = px.unbind(1)
    y1, y2, y3 = py.unbind(1)
    z1, z2, z3 = z.unbind(1)
    u, v = un[:, 0], un[:, 1]
    num = (x1 * y2 * z3 - x1 * y3 * z2 - x2 * y1 * z3
           + x2 * y3 * z1 + x3 * y1 * z2 - x3 * y2 * z1)
    den = (x1 * y2 - x2 * y1 - x1 * y3 + x3 * y1 + x2 * y3 - x3 * y2
           + u * y1 * z2 - u * y2 * z1 - v * x1 * z2 + v * x2 * z1
           - u * y1 * z3 + u * y3 * z1 + v * x1 * z3 - v * x3 * z1
           + u * y2 * z3 - u * y3 * z2 - v * x2 * z3 + v * x3 * z2)
    s = num / torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    zmin = torch.min(z, dim=-1).values
    zmax = torch.max(z, dim=-1).values
    s = torch.where(torch.isfinite(s), s, z[:, 0])
    s = torch.where(s - zmax > 0.2, zmax, s)
    s = torch.where(s - zmin < -0.2, zmin, s)
    ok = (active & (dist[:, 0] < 0.5) & torch.all(torch.isfinite(dist), dim=-1)
          & (zmax - zmin <= 2.0) & (s > 0))
    return torch.where(ok, s, torch.zeros_like(s)), ok


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def triangulate(un0: torch.Tensor, start_un: torch.Tensor,
                T_prev_first: se3.Pose) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-view depth of un0 (previous frame) against the first observation
    (Frontend.cpp:330-357). Returns (depth in the previous frame,
    ok = baseline > 1 & 0.5 < d < 100)."""
    p0 = torch.cat([un0, _ones_col(un0)], dim=-1)
    p1 = torch.cat([start_un, _ones_col(un0)], dim=-1)
    p1r = se3.quat_rotate(T_prev_first.q, p1)
    t = T_prev_first.t
    b0 = _dot3(t, p0)
    b1 = _dot3(t, p1r)
    a00 = _dot3(p0, p0)
    a10 = _dot3(p0, p1r)
    a11 = -_dot3(p1r, p1r)
    det = a00 * a11 + a10 * a10
    safe = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    lam0 = (b0 * a11 + a10 * b1) / safe
    lam1 = (a00 * b1 - a10 * b0) / safe
    depth = 0.5 * (lam0 * p0[..., 2] + (t[..., 2] + lam1 * p1r[..., 2]))
    ok = (_sqrt(_dot3(t, t)) > 1.0) & (depth > 0.5) & (depth < 100.0) & torch.isfinite(depth)
    return depth, ok


def _epipolar_system(pose: se3.Pose, un0, un1, w_mask):
    """Epipolar rows with the full Jacobians. pose: T_cur_prev."""
    u1, v1 = un1[:, 0], un1[:, 1]
    t = pose.t
    p0 = torch.cat([un0, _ones_col(un0)], dim=-1)
    rp0 = se3.quat_rotate(pose.q[None], p0)
    a = torch.stack([-v1 * t[2] + t[1], u1 * t[2] - t[0], -u1 * t[1] + v1 * t[0]], dim=-1)
    res = _dot3(a, rp0)
    p1 = torch.stack([u1, v1, torch.ones_like(u1)], dim=-1)
    J_t = se3._cross(p1, rp0)
    J_th = se3._cross(rp0, a)
    # Huber on the distance to the epipolar line (Frontend.cpp:580-592)
    epi = se3._cross(t.expand_as(rp0), rp0)
    d_line = _dot3(p1, epi).abs() / torch.clamp(_sqrt(_dot3(epi, epi)), min=1e-12)
    thresh = 0.5 / 760.0
    hw = torch.where(d_line < thresh, torch.ones_like(d_line),
                     thresh / torch.clamp(d_line, min=1e-12))
    w = hw * _recip32(0.75) * w_mask
    return res, torch.cat([J_t, J_th], dim=-1), w


def _reproj_system(pose: se3.Pose, un0, un1, depth, w_mask, huber_thresh, obs_std):
    """Linear reprojection rows y3, y4 (Frontend.cpp:628-686)."""
    u1, v1 = un1[:, 0], un1[:, 1]
    p0 = torch.cat([un0, _ones_col(un0)], dim=-1) * depth[:, None]
    rp0 = se3.quat_rotate(pose.q[None], p0)
    p1 = rp0 + pose.t
    y3 = rp0[:, 0] - u1 * rp0[:, 2] + pose.t[0] - u1 * pose.t[2]
    y4 = rp0[:, 1] - v1 * rp0[:, 2] + pose.t[1] - v1 * pose.t[2]
    invz = 1.0 / torch.clamp(p1[:, 2], min=1e-6)
    ex = u1 - p1[:, 0] * invz
    ey_ = v1 - p1[:, 1] * invz
    e = _sqrt(ex * ex + ey_ * ey_)
    hw = torch.where(e < huber_thresh, torch.ones_like(e),
                     huber_thresh / torch.clamp(e, min=1e-12))
    w = hw * _recip32(obs_std * obs_std)
    # degenerate-geometry down-weight (Frontend.cpp:655-659)
    gx = rp0[:, 0] - u1 * rp0[:, 2]
    gy = rp0[:, 1] - v1 * rp0[:, 2]
    ey = _sqrt(gx * gx + gy * gy)
    w = torch.where(ey < 0.01, w * 0.1, w) * w_mask
    hat = se3.so3_hat(rp0)
    dy3_dth = -(hat[:, 0, :] - u1[:, None] * hat[:, 2, :])
    dy4_dth = -(hat[:, 1, :] - v1[:, None] * hat[:, 2, :])
    ones, zeros = torch.ones_like(u1), torch.zeros_like(u1)
    J3 = torch.cat([torch.stack([ones, zeros, -u1], -1), dy3_dth], dim=-1)
    J4 = torch.cat([torch.stack([zeros, ones, -v1], -1), dy4_dth], dim=-1)
    return (y3, J3), (y4, J4), w, e * w_mask


def solve_pose(pose0: se3.Pose, un0, un1, depth, has_depth, epi_ok,
               cfg: VisualConfig, reduce_fn=None) -> se3.Pose:
    """The ≤ ``gn_iters``-iteration GN of Frontend::trackfeature with the
    staged gates (epipolar rows fade at iteration 25, outlier rejection from
    70, Frontend.cpp:555,690-693) and the |δ| < gn_tol exit
    (Frontend.cpp:401,443-447). pose0: the warm start T_cur_prev.

    ``reduce_fn(H, g, n_depth, sum_e)`` returns the four reduced across
    ranks: the distributed layer shards the feature rows and all-reduces
    their partial sums here (``parallel/sharded_visual.py``). Everything
    after it is replicated, the exit read too, so every rank leaves the loop
    at the same iteration. Under a reduction the partial sums are float64
    and round to float32 after it, as in ``lidar_odometry.scan_to_scan_impl``:
    the same bits however the rows are split."""
    epi_stage, rej_stage = 25, 70
    dev = un0.device
    pose = pose0
    mean_prev = torch.tensor(1e5, device=dev)
    n_depth_prev = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    has_depth_f = has_depth.to(torch.float32)
    acc = torch.float32 if reduce_fn is None else torch.float64
    for it in range(cfg.gn_iters):
        if it and it % SOLVE_CHECK_EVERY == 0 and bool(done):
            break
        use_epi = epi_ok & (_sqrt(_dot3(pose.t, pose.t)) > 0.1) & (
            (n_depth_prev < 50) | (it < epi_stage))
        re, Je, we = _epipolar_system(pose, un0, un1, use_epi.to(torch.float32))
        we = we * 3.0
        (y3, J3), (y4, J4), wd, e = _reproj_system(pose, un0, un1, depth, has_depth_f,
                                                   cfg.huber_reproj, 1.0)
        keep = (n_depth_prev < 300) | (it < rej_stage) | (e < 2.0 * mean_prev)
        wd = wd * keep.to(torch.float32)
        kept = has_depth & keep
        n_depth = kept.sum()
        sum_e = torch.where(kept, e, torch.zeros_like(e)).to(acc).sum()
        we2, wd2 = we * we, wd * wd
        Je, J3, J4 = Je.to(acc), J3.to(acc), J4.to(acc)
        H = (torch.einsum("n,ni,nj->ij", we2.to(acc), Je, Je)
             + torch.einsum("n,ni,nj->ij", wd2.to(acc), J3, J3)
             + torch.einsum("n,ni,nj->ij", wd2.to(acc), J4, J4))
        g = (torch.einsum("n,ni->i", (we2 * re).to(acc), Je)
             + torch.einsum("n,ni->i", (wd2 * y3).to(acc), J3)
             + torch.einsum("n,ni->i", (wd2 * y4).to(acc), J4))
        if reduce_fn is not None:
            H, g, n_depth, sum_e = reduce_fn(H, g, n_depth, sum_e)
            H, g, sum_e = H.to(torch.float32), g.to(torch.float32), sum_e.to(torch.float32)
        mean = sum_e / torch.clamp(n_depth, min=1)
        delta = gn.solve_damped(H, g, lm_lambda=1e-5)
        new_pose = se3.Pose(se3.quat_normalize(se3.quat_mul(se3.so3_exp(delta[3:]), pose.q)),
                            pose.t + delta[:3])
        converged = ((_sqrt(_dot3(delta[3:], delta[3:])) < cfg.gn_tol)
                     & (10.0 * _sqrt(_dot3(delta[:3], delta[:3])) < cfg.gn_tol))
        # a converged state stays as it was (the while_loop has left)
        pose = se3.Pose(torch.where(done, pose.q, new_pose.q),
                        torch.where(done, pose.t, new_pose.t))
        mean_prev = torch.where(done, mean_prev, mean)
        n_depth_prev = torch.where(done, n_depth_prev, n_depth)
        n_live = n_live + (~done).to(torch.int64)
        done = done | converged
    stats["solve_calls"] += 1
    stats["solve_iterations"] = stats["solve_iterations"] + n_live
    return pose


def _replenish(table: FeatureTable, img: torch.Tensor, cam, pose_w: se3.Pose,
               cfg: VisualConfig) -> FeatureTable:
    """Fill inactive slots with fresh per-cell corners (featureTracking.cpp:300-385).

    Candidates take the free slots in slot order (a stable sort); candidates
    beyond the free count all write to a pad row N, which is dropped, so the
    order of those duplicate writes does not matter."""
    N = table.uv.shape[0]
    score = image.shi_tomasi_score(img)
    cand_uv, cand_ok = image.grid_select_features(
        score, table.uv, table.active, grid_rows=cfg.grid_rows, grid_cols=cfg.grid_cols,
        per_cell=cfg.max_features_per_cell)
    C = cand_uv.shape[0]
    free = ~table.active
    n_free = free.sum()
    free_order = torch.sort((~free).to(torch.int32), stable=True).indices
    cand_rank = torch.cumsum(cand_ok.to(torch.int64), dim=0) - 1
    write_ok = cand_ok & (cand_rank < n_free)
    slot = torch.where(write_ok, free_order[torch.clamp(cand_rank, 0, N - 1)],
                       torch.full_like(cand_rank, N))
    un = cam_ops.normalized(cam, cand_uv)

    def scat(dst, val):
        padded = torch.cat([dst, torch.zeros_like(dst[:1])], dim=0)
        padded[slot] = val
        return padded[:N]

    return FeatureTable(
        uv=scat(table.uv, cand_uv),
        active=scat(table.active, write_ok),
        depth=scat(table.depth, torch.full_like(cand_uv[:, 0], -1.0)),
        start_un=scat(table.start_un, un),
        start_q=scat(table.start_q, pose_w.q.expand(C, 4)),
        start_t=scat(table.start_t, pose_w.t.expand(C, 3)),
        age=scat(table.age, torch.zeros(C, dtype=torch.int32, device=cand_uv.device)),
        flow=scat(table.flow, torch.zeros_like(cand_uv)),
    )


def depth_gates(uv1, ok, prev_dc: DepthCloud, table: FeatureTable, pose_w: se3.Pose, cam):
    """Depth association + triangulation fusion + residual-set gating for one
    tracked frame (Frontend.cpp:237-381). Returns (active, un0, un1, depth,
    has_depth, epi_ok)."""
    active = table.active & ok
    un0 = cam_ops.normalized(cam, table.uv)
    un1 = cam_ops.normalized(cam, uv1)
    d_lidar, ok_lidar = associate_depth(un0, active, prev_dc)
    T_first = se3.Pose(table.start_q, table.start_t)
    T_prev_first = se3.se3_compose(
        se3.se3_inverse(se3.Pose(pose_w.q.expand_as(table.start_q),
                                 pose_w.t.expand_as(table.start_t))),
        T_first)
    d_tri, ok_tri = triangulate(un0, table.start_un, T_prev_first)
    prev_d = table.depth
    has_prev = prev_d > 0
    # lidar wins; else fused triangulation; else the propagated depth
    d_tri_fused = torch.where(has_prev, 0.4 * prev_d + 0.6 * d_tri, d_tri)
    depth = torch.where(ok_lidar, d_lidar,
                        torch.where(ok_tri, d_tri_fused,
                                    torch.where(has_prev, prev_d, torch.zeros_like(prev_d))))
    v2_flag = ~ok_lidar & (ok_tri | has_prev)
    has_depth = (ok_lidar | v2_flag) & active & (depth > 0)
    epi_ok = ~ok_lidar & active
    return active, un0, un1, depth, has_depth, epi_ok


def apply_solution(uv1, table: FeatureTable, active, un0, depth, has_depth,
                   rel: se3.Pose, pose_w: se3.Pose) -> tuple[FeatureTable, se3.Pose]:
    """World integration Tw ← Tw ∘ T_prev_cur (Frontend.cpp:461-462), depth
    propagation into the current frame (:484-513), the table roll."""
    new_pose_w = se3.se3_compose(pose_w, se3.se3_inverse(rel))
    p0 = torch.cat([un0, _ones_col(un0)], dim=-1) * depth[:, None]
    p1 = se3.quat_rotate(rel.q[None], p0) + rel.t
    new_depth = torch.where(has_depth, p1[:, 2], torch.full_like(depth, -1.0))
    table = FeatureTable(
        uv=uv1, active=active, depth=new_depth, start_un=table.start_un,
        start_q=table.start_q, start_t=table.start_t, age=table.age + 1,
        flow=torch.where(active[:, None], uv1 - table.uv, torch.zeros_like(uv1)),
    )
    return table, new_pose_w


def solve_and_update(uv1, ok, prev_dc: DepthCloud, table: FeatureTable, pose_w: se3.Pose,
                     warm_rel: se3.Pose, cam, cfg: VisualConfig):
    """Depth gates, pose GN from ``warm_rel``, state propagation. Returns
    (table, T_cur_prev, Tw)."""
    active, un0, un1, depth, has_depth, epi_ok = depth_gates(uv1, ok, prev_dc, table, pose_w, cam)
    rel = solve_pose(warm_rel, un0, un1, depth, has_depth, epi_ok, cfg)
    table, new_pose_w = apply_solution(uv1, table, active, un0, depth, has_depth, rel, pose_w)
    return table, rel, new_pose_w


def update_after_external_solve(uv1, ok, prev_dc: DepthCloud, table: FeatureTable,
                                pose_w: se3.Pose, rel: se3.Pose,
                                cam) -> tuple[FeatureTable, se3.Pose]:
    """The state update of ``solve_and_update`` for a relative pose solved
    elsewhere (the reference's sharded visual step): the same gates and the
    same table and pose propagation."""
    active, un0, _, depth, has_depth, _ = depth_gates(uv1, ok, prev_dc, table, pose_w, cam)
    return apply_solution(uv1, table, active, un0, depth, has_depth, rel, pose_w)


def _track(prev_pyr: tuple, pyr: tuple, table: FeatureTable, cfg: VisualConfig):
    """Forward / reverse-checked KLT of the table's features (kernel K6)."""
    return lk.track_pyramid_reverse_checked(
        prev_pyr, pyr, table.uv, table.active, table.flow,
        win=cfg.lk_window, iters=cfg.lk_iters, levels=cfg.lk_levels,
        max_reverse_err=cfg.reverse_check_px, reverse_levels=cfg.lk_reverse_levels or None,
        iters_coarse=cfg.lk_iters_coarse or None, eps=cfg.lk_eps, affine=cfg.lk_affine,
        reverse_affine=cfg.lk_reverse_affine,
    )


def visual_step(prev_pyr: tuple, cur_pyr: tuple, prev_dc: DepthCloud, table: FeatureTable,
                pose_w: se3.Pose, warm_rel: se3.Pose, cam,
                cfg: VisualConfig) -> tuple[FeatureTable, se3.Pose, se3.Pose]:
    """One frame of visual odometry: track → solve and update → replenish.
    Returns (table, T_cur_prev, Tw)."""
    uv1, ok = _track(prev_pyr, cur_pyr, table, cfg)
    table, rel, new_pose_w = solve_and_update(uv1, ok, prev_dc, table, pose_w, warm_rel, cam,
                                              cfg)
    return _replenish(table, cur_pyr[0], cam, new_pose_w, cfg), rel, new_pose_w


def chunk_frame_step(carry: VisualChunkState, img: torch.Tensor, pts: torch.Tensor,
                     m: torch.Tensor, cam, cfg: VisualConfig):
    """One visual frame: dequantize → CLAHE → pyramid → LK forward/reverse →
    depth association + pose GN → replenish. Images come as float32 or uint8,
    clouds as float32 or uint16 codes (as int16 with their bits, the upload's
    form). Returns (carry, T_cur_prev, the count of tracked features before
    replenishment)."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * (1.0 / 255.0)
    if pts.dtype in (torch.int16, torch.uint16):
        pts = dequantize(pts)
    if cfg.use_clahe:
        img = image.clahe(img, grid=cfg.clahe_grid, clip_limit=cfg.clahe_clip)
    pyr = tuple(image.build_pyramid(img, cfg.lk_levels))
    dc = build_depth_cloud(pts, m)
    uv1, ok = _track(carry.prev_pyr, pyr, carry.table, cfg)
    table, rel, pose_w = solve_and_update(uv1, ok, carry.prev_dc, carry.table, carry.pose_w,
                                          carry.warm_rel, cam, cfg)
    n_tracked = table.active.sum()
    stats["frames"] += 1
    stats["tracked"] = stats["tracked"] + n_tracked
    table = _replenish(table, pyr[0], cam, pose_w, cfg)
    return VisualChunkState(table, pose_w, rel, pyr, dc), rel, n_tracked


def visual_frames(state: VisualChunkState, imgs: torch.Tensor, clouds: torch.Tensor,
                  cloud_masks: torch.Tensor, cam, cfg: VisualConfig):
    """``visual_chunk`` that also keeps each frame's T_cur_prev and tracked
    count (``chunk_frame_step``). Returns (state, world poses (K,), the K
    relative poses, the K counts)."""
    qs, ts, rels, n_tracked = [], [], [], []
    for k in range(imgs.shape[0]):
        state, rel, n_trk = chunk_frame_step(state, imgs[k], clouds[k], cloud_masks[k], cam, cfg)
        qs.append(state.pose_w.q)
        ts.append(state.pose_w.t)
        rels.append(rel)
        n_tracked.append(n_trk)
    return state, se3.Pose(torch.stack(qs), torch.stack(ts)), rels, n_tracked


def visual_chunk(state: VisualChunkState, imgs: torch.Tensor, clouds: torch.Tensor,
                 cloud_masks: torch.Tensor, cam, cfg: VisualConfig):
    """K frames of the visual frontend: imgs (K, H, W) uint8 or float32 in
    [0, 1], clouds (K, M, 3) camera-frame points, masks (K, M). Returns
    (state, world poses stacked (K, 4) / (K, 3))."""
    return visual_frames(state, imgs, clouds, cloud_masks, cam, cfg)[:2]


def init_chunk_state(img0: torch.Tensor, pts0: torch.Tensor, mask0: torch.Tensor, cam,
                     cfg: VisualConfig) -> VisualChunkState:
    """Bootstrap the carried state from frame 0 (replenish only, no tracking)."""
    if cfg.use_clahe:
        img0 = image.clahe(img0, grid=cfg.clahe_grid, clip_limit=cfg.clahe_clip)
    dev = img0.device
    pyr = tuple(image.build_pyramid(img0, cfg.lk_levels))
    dc = build_depth_cloud(pts0, mask0)
    ident = se3.identity_pose(dev)
    table = _replenish(empty_table(cfg.max_tracked, dev), pyr[0], cam, ident, cfg)
    return VisualChunkState(table, ident, ident, pyr, dc)


def visual_chunk_state_from_numpy(arrays: Mapping[str, np.ndarray], levels: int,
                                  device="cuda") -> VisualChunkState:
    """The carried state from the keys the JAX package's checkpoint writes
    for a ``VisualChunkState`` (``utils/checkpoint.py``, ``vchunk_0`` … in
    leaf order): the table's 8 fields, pose_w (q, t), warm_rel (q, t), the
    ``levels`` pyramid images, then the depth cloud (plane10, z, mask)."""
    dev = resolve_device(device)
    leaves = iter(range(8 + 4 + levels + 3))

    def nxt(dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[f"vchunk_{next(leaves)}"]), dtype=dtype, device=dev)

    table = FeatureTable(
        uv=nxt(), active=nxt(torch.bool), depth=nxt(), start_un=nxt(), start_q=nxt(),
        start_t=nxt(), age=nxt(torch.int32), flow=nxt(),
    )
    pose_w = se3.Pose(nxt(), nxt())
    warm_rel = se3.Pose(nxt(), nxt())
    pyr = tuple(nxt() for _ in range(levels))
    dc = DepthCloud(nxt(), nxt(), nxt(torch.bool))
    return VisualChunkState(table, pose_w, warm_rel, pyr, dc)


class VisualOdometry:
    """Per-frame driver of the visual frontend (≡ CamLidarProcess thread C
    and the Frontend state)."""

    def __init__(self, cam, cfg: VisualConfig = VisualConfig(), device="cuda"):
        dev = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.table = empty_table(cfg.max_tracked, dev)
        self.pose_w = se3.identity_pose(dev)
        self.warm_rel = se3.identity_pose(dev)
        self.prev_pyr = None
        self.prev_dc = None

    def process(self, img: torch.Tensor, pts_cam: torch.Tensor,
                pts_mask: torch.Tensor) -> se3.Pose:
        """img (H, W) float32 in [0, 1]; pts_cam (M, 3) lidar points in the
        camera frame, pts_mask (M,). The first frame only seeds features.
        Returns the camera's world pose."""
        if self.cfg.use_clahe:
            img = image.clahe(img, grid=self.cfg.clahe_grid, clip_limit=self.cfg.clahe_clip)
        pyr = tuple(image.build_pyramid(img, self.cfg.lk_levels))
        dc = build_depth_cloud(pts_cam, pts_mask)
        if self.prev_pyr is None:
            self.table = _replenish(self.table, pyr[0], self.cam, self.pose_w, self.cfg)
        else:
            self.table, self.warm_rel, self.pose_w = visual_step(
                self.prev_pyr, pyr, self.prev_dc, self.table, self.pose_w, self.warm_rel,
                self.cam, self.cfg)
        self.prev_pyr = pyr
        self.prev_dc = dc
        return self.pose_w
