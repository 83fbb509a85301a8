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
    # filled on the device: a tensor built from a host list is a blocking copy
    q = torch.zeros(4, device=device)
    q[:1].fill_(1.0)
    return Pose(q, torch.zeros(3, device=device))


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
    # the product by (1, −1, −1, −1), bit for bit, with no host-to-device copy
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


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


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 4), branch-free Shepperd's method: all four
    candidates, the one with the largest pivot selected by ``torch.where``."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


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


def so3t_exp(xi: torch.Tensor) -> Pose:
    """Decoupled rotation / translation exponential (the reference's
    ``so3Transexp``, Twist.h:206-215): the translation taken as it is."""
    return Pose(so3_exp(xi[..., 3:]), xi[..., :3])


def se3_compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def se3_inverse(p: Pose) -> Pose:
    qinv = quat_conj(p.q)
    return Pose(qinv, -quat_rotate(qinv, p.t))


def se3_apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    return quat_rotate(p.q, x) + p.t


def se3_apply_matmul(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """One pose applied to an (N, 3) cloud as ``pts @ Rᵀ + t`` (geometry in
    full float32: TF32 is off, ``utils/device.py``)."""
    return pts @ quat_to_matrix(p.q).T + p.t


def se3_adjoint(p: Pose) -> torch.Tensor:
    """(..., 6, 6) adjoint in (v, ω) order: Ad = [[R, t^ R], [0, R]]
    (the reference's ``SE3Adj``, Twist.h:156-167)."""
    R = quat_to_matrix(p.q)
    top = torch.cat([R, so3_hat(p.t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_matrix(p: Pose) -> torch.Tensor:
    """Pose → (..., 4, 4) homogeneous matrix."""
    top = torch.cat([quat_to_matrix(p.q), p.t[..., :, None]], dim=-1)
    bottom = torch.zeros((*p.t.shape[:-1], 1, 4), dtype=p.t.dtype, device=p.t.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T: torch.Tensor) -> Pose:
    return Pose(matrix_to_quat(T[..., :3, :3]), T[..., :3, 3])


def quat_to_ypr(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) → (yaw, pitch, roll) in radians, ZYX (≡ Utility::R2ypr,
    utility.h:77-96)."""
    R = quat_to_matrix(q)
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def ypr_to_quat(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) → quaternion, ZYX (≡ Utility::ypr2R)."""
    y, p, r = ypr.unbind(-1)
    zeros = torch.zeros_like(y)
    qz = so3_exp(torch.stack([zeros, zeros, y], dim=-1))
    qy = so3_exp(torch.stack([zeros, p, zeros], dim=-1))
    qx = so3_exp(torch.stack([r, zeros, zeros], dim=-1))
    return quat_mul(qz, quat_mul(qy, qx))


def pose_interpolate(p: Pose, s: torch.Tensor) -> Pose:
    """Fractional pose: slerp-from-identity for q, s·t for t
    (lidarFactor.hpp:27-30)."""
    return Pose(quat_slerp_identity(p.q, s), s[..., None] * p.t)
