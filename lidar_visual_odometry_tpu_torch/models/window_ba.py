"""Sliding-window photometric bundle adjustment (≡ WindowOptimizer), ported
from ``lidar_visual_odometry_tpu/models/window_ba.py``.

Multi-view photometric BA over the keyframe window
(``src/vloam/WindowOptimizer.cpp:20-603``): ordered (host, target) pairs h ≠ t
(``:496-520``) contribute the 4-pixel-patch residuals of the host keyframe's
points projected into the target frame. With ``p_w`` the world point and
``R_t`` the target rotation, the Jacobians with respect to both world poses
are (``compute_residuals``, ``:352-486``)

    J_host  = ∇I · ∂π/∂p_t · R_tᵀ · [ I | −[p_w]× ],   J_target = −J_host

so each pair adds the block pattern [[A, −A], [−A, A]] at (h, t) to the
(6K × 6K) system. All pairs are evaluated as one batch. The blocks are summed
by one product with a fixed ±1 incidence matrix: a deterministic sum, where
``index_add_`` on the card would add in the order its atomics land. Weights are
a global MAD-normalised Student-t (``build_LinearSystem``, ``:522-560``), the
gauge is fixed by a 1e8 diagonal prior on pose 0 (``solve``, ``:180-181``), and
the refine loop returns the lowest-χ² iterate it evaluated (``refine``,
``:68-148``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import gn, image, se3
from .tracker_direct import _left_perturbation, _level_cam, _patch

GAUGE_PRIOR = 1e8

# BA calls and rounds run since ``reset_stats`` (profiling and the card smoke
# test read them)
stats = {"calls": 0, "rounds": 0}


def reset_stats() -> None:
    stats.update(calls=0, rounds=0)


def pair_list(K: int, pair_radius: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The static (host, target) pairs: every ordered pair h ≠ t, or only
    |h − t| ≤ ``pair_radius`` when it is positive, in row-major order."""
    sel = ~np.eye(K, dtype=bool)
    if pair_radius > 0:
        ij = np.abs(np.arange(K)[:, None] - np.arange(K)[None, :])
        sel &= ij <= pair_radius
    return np.nonzero(sel)


def incidence(K: int, hs: np.ndarray, ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """±1 matrices that scatter the pairs' blocks: H blocks (K·K, 36) =
    M_H @ A (Pairs, 36) puts +A at (h, h) and (t, t), −A at (h, t) and
    (t, h); g (K, 6) = M_g @ v puts +v at h and −v at t."""
    P = len(hs)
    m_h = np.zeros((K * K, P), np.float32)
    m_g = np.zeros((K, P), np.float32)
    p = np.arange(P)
    m_h[hs * K + hs, p] += 1.0
    m_h[ts * K + ts, p] += 1.0
    m_h[hs * K + ts, p] -= 1.0
    m_h[ts * K + hs, p] -= 1.0
    m_g[hs, p] += 1.0
    m_g[ts, p] -= 1.0
    return m_h, m_g


def _pair_ref_samples(imgs: torch.Tensor, points: torch.Tensor, point_mask: torch.Tensor,
                      h: torch.Tensor, cam_l):
    """Host-side samples (Pairs, P, 4) and validity (Pairs, P) of the pairs'
    host keyframes ``h`` at one level (``imgs`` (K, H, W)): pose-independent,
    so computed once a refine."""
    pts_h = points[h]
    uv_h, front_h = cam_ops.project(cam_l, pts_h)
    patch = uv_h[..., None, :] + _patch(uv_h.device)
    i_ref = image.bilinear_stack(imgs[..., None], patch, h[:, None, None])[..., 0]
    ok_h = point_mask[h] & front_h & cam_ops.is_in_image(cam_l, uv_h, boundary=2.0)
    return i_ref, ok_h


def _pair_residuals(stack: torch.Tensor, i_ref: torch.Tensor, ok_h: torch.Tensor,
                    points: torch.Tensor, poses: se3.Pose, h: torch.Tensor, t: torch.Tensor,
                    cam_l):
    """Residuals (Pairs, P, 4), host-side Jacobians (Pairs, P, 4, 6) and
    validity (Pairs, P) of the pairs (h, t); ``stack`` (K, H, W, 3) holds
    each keyframe's image and gradients at the level."""
    pts_h = points[h]
    p_w = se3.se3_apply(se3.Pose(poses.q[h][:, None], poses.t[h][:, None]), pts_h)
    T_tw = se3.se3_inverse(se3.Pose(poses.q[t], poses.t[t]))
    p_t = se3.se3_apply(se3.Pose(T_tw.q[:, None], T_tw.t[:, None]), p_w)

    uv_t, front_t = cam_ops.project(cam_l, p_t)
    patch_t = uv_t[..., None, :] + _patch(uv_t.device)
    i_cur, gxs, gys = image.bilinear_stack(stack, patch_t, t[:, None, None]).unbind(-1)
    r = i_cur - i_ref

    inv_z = 1.0 / torch.clamp(p_t[..., 2], min=1e-3)
    zero = torch.zeros_like(inv_z)
    du = torch.stack([cam_l.fx * inv_z, zero, -cam_l.fx * p_t[..., 0] * inv_z ** 2], dim=-1)
    dv = torch.stack([zero, cam_l.fy * inv_z, -cam_l.fy * p_t[..., 1] * inv_z ** 2], dim=-1)
    # ∂p_t/∂δ_host = R_tᵀ [I | −[p_w]×]
    Rt = se3.quat_to_matrix(T_tw.q)
    dpt = Rt[:, None] @ _left_perturbation(p_w)                 # (Pairs, P, 3, 6)
    du_dxi = (du[..., None, :] @ dpt)[..., 0, :]
    dv_dxi = (dv[..., None, :] @ dpt)[..., 0, :]
    J = gxs[..., None] * du_dxi[..., None, :] + gys[..., None] * dv_dxi[..., None, :]

    ok = (ok_h & front_t & cam_ops.is_in_image(cam_l, uv_t, boundary=2.0)
          & (p_t[..., 2] > 0.1))
    return r, J, ok


def refine(pyramids: tuple, points: torch.Tensor, point_mask: torch.Tensor, poses: se3.Pose,
           cam, *, n_iters: int = 5, level: int = 1, tdist_dof: float = 5.0,
           step_tol: float = 1e-5, pair_radius: int = 0) -> se3.Pose:
    """Jointly refine all K world poses (``pyramids``: per level (K, h, w);
    points (K, P, 3); masks (K, P)); returns the lowest-χ² evaluated
    iterate. The loop stops after ``n_iters`` rounds or once a step's
    max-norm drops below ``step_tol`` (read on the host once a round);
    ``step_tol=0`` runs the fixed count."""
    K = points.shape[0]
    dev = points.device
    imgs = pyramids[level]
    cam_l = _level_cam(cam, level)
    hs_np, ts_np = pair_list(K, pair_radius)
    hs = torch.from_numpy(hs_np).to(dev)
    ts = torch.from_numpy(ts_np).to(dev)
    m_h, m_g = (torch.from_numpy(m).to(dev) for m in incidence(K, hs_np, ts_np))
    gauge = torch.zeros(6 * K, device=dev)
    gauge[:6] = GAUGE_PRIOR

    # pose-independent hoists: target-image gradients (K images) and the
    # host-side samples
    stack = torch.stack([imgs, *image.gradients(imgs)], dim=-1)
    i_ref, ok_h = _pair_ref_samples(imgs, points, point_mask, hs, cam_l)

    def system(poses):
        r, J, ok = _pair_residuals(stack, i_ref, ok_h, points, poses, hs, ts, cam_l)
        w_ok = ok[..., None].to(r.dtype)
        absr = torch.abs(torch.where(ok[..., None], r, torch.full_like(r, float("nan"))))
        sigma = torch.clamp(1.4826 * gn.nanmedian(absr), min=1e-4)
        w = gn.tdist_weight(r, sigma, tdist_dof) * w_ok
        n_pairs = r.shape[0]
        Jf = J.reshape(n_pairs, -1, 6)
        Jw = Jf * w.reshape(n_pairs, -1, 1)
        A = Jw.transpose(1, 2) @ Jf                            # (Pairs, 6, 6)
        v = (Jw.transpose(1, 2) @ r.reshape(n_pairs, -1, 1))[..., 0]
        H = (m_h @ A.reshape(n_pairs, 36)).reshape(K, K, 6, 6)
        g = m_g @ v
        chi2 = torch.sum(w * r * r)
        return H, g, chi2

    best = poses
    best_chi2 = torch.tensor(float("inf"), device=dev)
    stats["calls"] += 1
    for _ in range(n_iters):
        stats["rounds"] += 1
        H, g, chi2 = system(poses)
        better = chi2 < best_chi2                  # NaN < x is false
        best = se3.Pose(torch.where(better, poses.q, best.q), torch.where(better, poses.t, best.t))
        best_chi2 = torch.minimum(chi2, best_chi2)

        Hf = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) + torch.diag(gauge)
        delta = gn.solve_damped(Hf, g.reshape(6 * K), lm_lambda=1e-4).reshape(K, 6)
        poses = se3.Pose(se3.quat_normalize(se3.quat_mul(se3.so3_exp(delta[:, 3:]), poses.q)),
                         poses.t + delta[:, :3])
        if step_tol > 0.0 and not float(torch.max(torch.abs(delta))) >= step_tol:
            break
    return best
