"""Gauss-Newton pieces, ported from ``lidar_visual_odometry_tpu/ops/gn.py``
(≡ Ceres DENSE_QR + HuberLoss(0.1), ``laserOdometry.cpp:570-575``).

The scan-to-scan solve uses these for the de-skewed inner loop, which the fused
kernel K3 (``kernels.gn``) does not cover.
"""

from __future__ import annotations

import torch

from . import se3


def huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss: 1 inside δ, δ/|r| outside."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm),
                       delta / torch.clamp(r_norm, min=1e-12))


def accumulate(r: torch.Tensor, J: torch.Tensor, w: torch.Tensor, mask: torch.Tensor):
    """H (6, 6), g (6,) from (N, D) residuals, (N, D, 6) Jacobians and (N,)
    weights, for H δ = −g. Masked rows contribute zero."""
    wm = (w * mask).to(r.dtype)[..., None, None]
    Jw = J * wm
    H = torch.einsum("ndi,ndj->ij", Jw, J)
    g = torch.einsum("ndi,nd->i", Jw, r)
    return H, g


def solve_damped(H: torch.Tensor, g: torch.Tensor, lm_lambda: float = 1e-4) -> torch.Tensor:
    """δ = −(H + λ·diag(H))⁻¹ g by Cholesky; a non-finite step becomes zero."""
    d = H.shape[-1]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damp = lm_lambda * torch.clamp(diag, min=1e-6)
    Hd = H + torch.eye(d, dtype=H.dtype, device=H.device) * damp[..., None, :]
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = torch.cholesky_solve(-g[..., None], L)[..., 0]
    bad = (info != 0)[..., None] | ~torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros_like(delta), delta)


def gn_update_pose(pose: se3.Pose, delta: torch.Tensor) -> se3.Pose:
    """Left-multiplicative update: q ← exp(δθ) q (normalized), t ← t + δt."""
    dq = se3.so3_exp(delta[..., 3:])
    return se3.Pose(se3.quat_normalize(se3.quat_mul(dq, pose.q)), pose.t + delta[..., :3])
