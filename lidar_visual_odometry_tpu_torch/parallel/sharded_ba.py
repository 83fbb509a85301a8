"""Photometric window BA with the keyframes' points sharded over ranks,
ported from ``lidar_visual_odometry_tpu/parallel/sharded_ba.py``.

The unknowns are only the K keyframe poses (the points are anchored by the
lidar), so the summed (6K × 6K) system is the Schur-reduced camera system:
each rank builds its block of points' contribution, one all-reduce of
K²·36 + K·6 + 1 floats an iteration sums H, g and χ², and the small solve
runs replicated. The sharded axis is P, the points of every keyframe; the
images are replicated.
"""

from __future__ import annotations

import torch

from ..models import window_ba
from ..models.direct_vo import SAMPLE_PRECISIONS
from ..models.tracker_direct import _level_cam
from ..ops import gn, image, se3
from .sharded_odometry import Mesh


def sharded_refine(
    mesh: Mesh,
    pyramids: tuple,
    points: torch.Tensor,        # (K, P, 3), P sharded over the ranks
    point_mask: torch.Tensor,    # (K, P)
    poses: se3.Pose,
    cam,
    *,
    n_iters: int = 5,
    level: int = 1,
    tdist_dof: float = 5.0,
    sample_precision: str = "high",
    pair_radius: int = 0,
) -> se3.Pose:
    """The distributed ``window_ba.refine``: ``n_iters`` steps from
    ``poses``, then the χ² of the last iterate; returns the lowest-χ²
    iterate evaluated, replicated. The world size must divide P.

    As in the JAX package the robust scale is the MEAN absolute residual
    over every rank (one all-reduce of two floats), not ``refine``'s median:
    a distributed median would need a full gather. Nor does it stop early.
    ``sample_precision`` must name one of the JAX package's samplers and is
    then ignored (the port samples in float32 by gathers)."""
    if sample_precision not in SAMPLE_PRECISIONS:
        raise KeyError(sample_precision)
    K = points.shape[0]
    dev = points.device
    imgs = pyramids[level]
    cam_l = _level_cam(cam, level)
    pts = mesh.block(points, axis=1)
    pmask = mesh.block(point_mask, axis=1)
    hs_np, ts_np = window_ba.pair_list(K, pair_radius)
    hs = torch.from_numpy(hs_np).to(dev)
    ts = torch.from_numpy(ts_np).to(dev)
    m_h, m_g = (torch.from_numpy(m).to(dev) for m in window_ba.incidence(K, hs_np, ts_np))
    gauge = torch.zeros(6 * K, device=dev)
    gauge[:6] = window_ba.GAUGE_PRIOR

    # pose-independent hoists: the images' gradients and the host samples
    stack = torch.stack([imgs, *image.gradients(imgs)], dim=-1)
    i_ref, ok_h = window_ba._pair_ref_samples(imgs, pts, pmask, hs, cam_l)

    def system(poses):
        r, J, ok = window_ba._pair_residuals(stack, i_ref, ok_h, pts, poses, hs, ts, cam_l)
        w_ok = ok[..., None].to(r.dtype)
        abs_sum, cnt = mesh.all_reduce_sum(torch.sum(torch.abs(r) * w_ok), torch.sum(w_ok))
        sigma = torch.clamp(1.2533 * abs_sum / torch.clamp(cnt, min=1.0), min=1e-4)
        w = gn.tdist_weight(r, sigma, tdist_dof) * w_ok
        n_pairs = r.shape[0]
        Jf = J.reshape(n_pairs, -1, 6)
        Jw = Jf * w.reshape(n_pairs, -1, 1)
        A = Jw.transpose(1, 2) @ Jf
        v = (Jw.transpose(1, 2) @ r.reshape(n_pairs, -1, 1))[..., 0]
        H = m_h @ A.reshape(n_pairs, 36)
        g = m_g @ v
        # one collective: the pose system and the scalar χ²
        H, g, chi2 = mesh.all_reduce_sum(H, g, torch.sum(w * r * r))
        return H.reshape(K, K, 6, 6), g, chi2

    best = poses
    best_chi2 = torch.tensor(float("inf"), device=dev)
    for _ in range(n_iters):
        H, g, chi2 = system(poses)
        better = chi2 < best_chi2                  # NaN < x is false
        best = se3.Pose(torch.where(better, poses.q, best.q), torch.where(better, poses.t, best.t))
        best_chi2 = torch.minimum(chi2, best_chi2)
        Hf = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) + torch.diag(gauge)
        delta = gn.solve_damped(Hf, g.reshape(6 * K), lm_lambda=1e-4).reshape(K, 6)
        poses = se3.Pose(se3.quat_normalize(se3.quat_mul(se3.so3_exp(delta[:, 3:]), poses.q)),
                         poses.t + delta[:, :3])
    _, _, chi2 = system(poses)
    better = chi2 < best_chi2
    return se3.Pose(torch.where(better, poses.q, best.q), torch.where(better, poses.t, best.t))

