"""Point-to-line / point-to-plane residuals with analytic Jacobians, ported
from ``lidar_visual_odometry_tpu/ops/lidar_factors.py`` (≡ ``src/lidarFactor.hpp``).

Pose ``T = (q, t)`` maps current-frame points into the last frame,
``y = R(q) x + t``; updates are left-multiplicative with twists ``(δt, δθ)``,
so ``∂y/∂δt = I`` and ``∂y/∂δθ = −[R x]×``. Motion de-skew scales the twist by
each point's relative scan time ``s`` (``lidarFactor.hpp:27-30``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class EdgeCorr(NamedTuple):
    """Corner correspondences: current point ↔ line (a, b) in the last frame."""

    p: torch.Tensor     # (N, 3)
    a: torch.Tensor     # (N, 3)
    b: torch.Tensor     # (N, 3)
    s: torch.Tensor     # (N,) de-skew fraction (1.0 when disabled)
    mask: torch.Tensor  # (N,)


class PlaneCorr(NamedTuple):
    """Surf correspondences: current point ↔ plane (j, l, m) in the last frame."""

    p: torch.Tensor
    j: torch.Tensor
    l: torch.Tensor
    m: torch.Tensor
    s: torch.Tensor
    mask: torch.Tensor


class NormPlaneCorr(NamedTuple):
    """Surf point ↔ fitted plane (unit normal n, offset d): r = n·y + d
    (≡ LidarPlaneNormFactor, ``lidarFactor.hpp:106-138``)."""

    p: torch.Tensor     # (N, 3)
    n: torch.Tensor     # (N, 3) unit normals
    d: torch.Tensor     # (N,)
    mask: torch.Tensor


def _transform_deskewed(pose: se3.Pose, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y = slerp(I, q, s)·p + s·t  (TransformToStart, laserOdometry.cpp:154-172)."""
    ps = se3.pose_interpolate(pose, s)
    return se3.quat_rotate(ps.q, p) + ps.t


def edge_residuals(pose: se3.Pose, c: EdgeCorr) -> tuple[torch.Tensor, torch.Tensor]:
    """r = (y−a)×(y−b)/|a−b| (N, 3) and J (N, 3, 6):
    ∂r/∂y = [b−a]×/|a−b|, ∂y/∂ξ = [s·I | −s·[Rp]×]."""
    y = _transform_deskewed(pose, c.p, c.s)
    u = y - c.a
    v = y - c.b
    ab = c.a - c.b
    denom = torch.clamp(torch.linalg.vector_norm(ab, dim=-1, keepdim=True), min=1e-9)
    r = se3._cross(u, v) / denom

    dr_dy = se3.so3_hat(-ab) / denom[..., None]
    Rp = y - c.s[..., None] * pose.t
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(*y.shape[:-1], 3, 3)
    dy_dxi = torch.cat([eye, -se3.so3_hat(Rp)], dim=-1) * c.s[..., None, None]
    return r, dr_dy @ dy_dxi


def plane_residuals(pose: se3.Pose, c: PlaneCorr) -> tuple[torch.Tensor, torch.Tensor]:
    """r = (y−j)·n, n = normalize((j−l)×(j−m)) (N, 1) and J (N, 1, 6)."""
    n = se3._cross(c.j - c.l, c.j - c.m)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    y = _transform_deskewed(pose, c.p, c.s)
    r = torch.sum((y - c.j) * n, dim=-1, keepdim=True)
    Rp = y - c.s[..., None] * pose.t
    J = torch.cat([n, se3._cross(Rp, n)], dim=-1) * c.s[..., None]
    return r, J[..., None, :]


def norm_plane_residuals(pose: se3.Pose, c: NormPlaneCorr) -> tuple[torch.Tensor, torch.Tensor]:
    """Fitted-plane residual r = n·(R p + t) + d (N, 1) and J (N, 1, 6), the
    scan-to-map form."""
    y = se3.se3_apply(pose, c.p)
    r = torch.sum(y * c.n, dim=-1, keepdim=True) + c.d[..., None]
    J = torch.cat([c.n, se3._cross(y - pose.t, c.n)], dim=-1)
    return r, J[..., None, :]


def point_residuals(pose: se3.Pose, p: torch.Tensor,
                    target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point r = R p + t − target (N, 3) and J (N, 3, 6)
    (≡ LidarDistanceFactor)."""
    y = se3.se3_apply(pose, p)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(*y.shape[:-1], 3, 3)
    return y - target, torch.cat([eye, -se3.so3_hat(y - pose.t)], dim=-1)
