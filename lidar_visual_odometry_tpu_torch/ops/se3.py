"""SO(3)/SE(3) math, ported from ``lidar_visual_odometry_tpu/ops/se3.py``.

Same conventions as the reference: quaternions ``(w, x, y, z)``, unit norm,
acting on column vectors; ``Pose(q, t)`` means ``x_parent = R(q) x_child + t``;
twists are ``(v, ω)``, translation first. Functions broadcast over leading
batch dimensions and keep the dtype and device of their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Below this squared angle use Taylor expansions (the reference's SMALL_EPS)
_SMALL_ANGLE = 1e-6


class Pose(NamedTuple):
    """SE(3) pose: rotation quaternion (w, x, y, z) and translation."""

    q: torch.Tensor  # (..., 4)
    t: torch.Tensor  # (..., 3)


def identity_pose(device) -> Pose:
    return Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                torch.zeros(3, device=device))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, broadcasting."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by q (..., 4): v + 2(w·(u×v) + u×(u×v))."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) → (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(*w.shape[:-1], 3, 3)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → unit quaternion (..., 4), Taylor-guarded."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < _SMALL_ANGLE
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation vector, Taylor-safe, w ≥ 0 canonical."""
    q = torch.where(q[..., :1] >= 0, q, -q)
    w = q[..., :1]
    v = q[..., 1:]
    vn_sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn_sq < _SMALL_ANGLE * _SMALL_ANGLE
    safe_vn = torch.sqrt(torch.where(small, torch.ones_like(vn_sq), vn_sq))
    angle_over_vn = torch.where(
        small,
        2.0 / torch.clamp(w, min=1e-12),
        2.0 * torch.atan2(safe_vn, w) / safe_vn,
    )
    return angle_over_vn * v


def quat_slerp_identity(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """slerp(identity, q, s) = exp(s·log q) (lidarFactor.hpp:27-29)."""
    return so3_exp(s[..., None] * so3_log(q))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V = I + (1−cos θ)/θ² W + (θ−sin θ)/θ³ W²."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta_sq < _SMALL_ANGLE
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    W = so3_hat(w)
    W2 = W @ W
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta)
    )
    return _eye_like(W) + a * W + b * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """V⁻¹ closed form (used by se3_log)."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta_sq < _SMALL_ANGLE
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    W = so3_hat(w)
    W2 = W @ W
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-24)) / safe_sq,
    )
    return _eye_like(W) - 0.5 * W + cot_term * W2


def se3_exp(xi: torch.Tensor) -> Pose:
    """Twist (..., 6) = (v, ω) → Pose with the full V matrix."""
    v, w = xi[..., :3], xi[..., 3:]
    V = _so3_left_jacobian(w)
    return Pose(so3_exp(w), (V @ v[..., None])[..., 0])


def se3_log(pose: Pose) -> torch.Tensor:
    w = so3_log(pose.q)
    v = (_so3_left_jacobian_inv(w) @ pose.t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(p: Pose) -> Pose:
    qinv = quat_conj(p.q)
    return Pose(qinv, -quat_rotate(qinv, p.t))


def se3_apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    return quat_rotate(p.q, x) + p.t


def pose_interpolate(p: Pose, s: torch.Tensor) -> Pose:
    """Fractional pose: slerp-from-identity for q, s·t for t
    (lidarFactor.hpp:27-30)."""
    return Pose(quat_slerp_identity(p.q, s), s[..., None] * p.t)
