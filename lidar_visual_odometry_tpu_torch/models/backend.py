"""IMU + odometry fusion back-end (≡ BackEndSolver / State, activated), ported
from ``lidar_visual_odometry_tpu/models/backend.py``.

The reference ships a GTSAM ISAM2 smoother that the main path never builds
(``src/vloam/BackEndSolver.cpp``): IMU preintegration (``create_imu_factor``
``:22-76``), a static initialisation that aligns the mean accelerometer
reading with gravity (``trytoinitialize`` ``:152-281``), relative-pose
between-factors (``:93-146``) and an incremental solve. Here, as in the JAX
package, a sliding window of 10-20 states is re-solved whole at every update
by one Gauss-Newton:

* ``preintegrate``: midpoint IMU preintegration (Δq, Δv, Δp), one sample at a
  time;
* ``gravity_align_init``: the world ← body rotation from the mean accelerometer
  reading;
* ``solve_window``: Gauss-Newton over the states (q, p, v) with an IMU factor
  and an odometry between-factor for each consecutive pair and a prior on
  state 0's pose. The Jacobian of the residual stack is forward-mode
  automatic differentiation (``torch.func.jacfwd``), at δx = 0, every factor
  of the window in one batched evaluation. The step solves the damped normal
  equations by Cholesky; a matrix that is not positive definite, or a step
  that is not finite, gives a zero step. The iterate with the lowest χ² is
  returned, selected on the device with no host read.

Everything is float32 on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se3

GRAVITY = 9.81


class ImuDelta(NamedTuple):
    """Preintegrated IMU measurement between two states (fields may carry a
    leading (K-1,) axis: one delta per consecutive pair)."""

    dq: torch.Tensor    # (4,) orientation delta (body_i → body_j)
    dv: torch.Tensor    # (3,) velocity delta in frame i
    dp: torch.Tensor    # (3,) position delta in frame i
    dt: torch.Tensor    # () total time


class WindowState(NamedTuple):
    """Stacked navigation states (≡ gtsam State.h:15-116 without the biases,
    which the reference does not estimate online either)."""

    q: torch.Tensor   # (K, 4) world ← body
    p: torch.Tensor   # (K, 3)
    v: torch.Tensor   # (K, 3)


def preintegrate(accel: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
                 acc_bias: torch.Tensor | None = None,
                 gyro_bias: torch.Tensor | None = None) -> ImuDelta:
    """Midpoint preintegration of (N, 3) IMU samples over (N,) intervals: each
    sample's acceleration is rotated by the mid-interval attitude
    (≡ adjustPointCloud.cpp:205-276)."""
    if acc_bias is not None:
        accel = accel - acc_bias
    if gyro_bias is not None:
        gyro = gyro - gyro_bias
    dev = accel.device
    dq = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    dv = torch.zeros(3, device=dev)
    dp = torch.zeros(3, device=dev)
    for a, w, dt in zip(accel, gyro, dts):
        dq_half = se3.quat_mul(dq, se3.so3_exp(w * (0.5 * dt)))
        a_world = se3.quat_rotate(dq_half, a)
        dp = dp + dv * dt + 0.5 * a_world * dt * dt
        dv = dv + a_world * dt
        dq = se3.quat_normalize(se3.quat_mul(dq, se3.so3_exp(w * dt)))
    return ImuDelta(dq, dv, dp, torch.sum(dts))


def gravity_align_init(accel_mean: torch.Tensor) -> torch.Tensor:
    """World ← body quaternion that turns the mean accelerometer reading onto
    +z (≡ Utility::g2R in trytoinitialize, BackEndSolver.cpp:200-233)."""
    g_body = accel_mean / torch.clamp(torch.linalg.vector_norm(accel_mean), min=1e-9)
    g_world = torch.tensor([0.0, 0.0, 1.0], dtype=accel_mean.dtype, device=accel_mean.device)
    axis = se3._cross(g_body, g_world)
    s = torch.linalg.vector_norm(axis)
    angle = torch.atan2(s, torch.dot(g_body, g_world))
    return se3.so3_exp(axis / torch.clamp(s, min=1e-9) * angle)


def _imu_residual(state: WindowState, i, delta: ImuDelta, g: torch.Tensor) -> torch.Tensor:
    """The 9-dof residual (r_p, r_q, r_v) of the preintegrated factor between
    states i and i+1. ``i`` is an int, or an index tensor with ``delta``'s
    fields stacked alike (one row a factor)."""
    qi, qj = state.q[i], state.q[i + 1]
    pi, pj = state.p[i], state.p[i + 1]
    vi, vj = state.v[i], state.v[i + 1]
    dt = delta.dt[..., None]
    qi_inv = se3.quat_conj(qi)
    r_q = se3.so3_log(se3.quat_mul(se3.quat_conj(delta.dq), se3.quat_mul(qi_inv, qj)))
    r_v = se3.quat_rotate(qi_inv, vj - vi - g * dt) - delta.dv
    r_p = se3.quat_rotate(qi_inv, pj - pi - vi * dt - 0.5 * g * dt * dt) - delta.dp
    return torch.cat([r_p, r_q, r_v], dim=-1)


def _between_residual(state: WindowState, i, j, rel: se3.Pose) -> torch.Tensor:
    """Relative-pose factor (≡ addBetweenFactor, BackEndSolver.cpp:351-384);
    ``i``, ``j`` ints or index tensors."""
    Ti = se3.Pose(state.q[i], state.p[i])
    Tj = se3.Pose(state.q[j], state.p[j])
    pred = se3.se3_compose(se3.se3_inverse(Ti), Tj)
    return se3.se3_log(se3.se3_compose(se3.se3_inverse(rel), pred))


def _retract(state: WindowState, dx: torch.Tensor) -> WindowState:
    """dx (K, 9) = (δp, δθ, δv), the rotation applied on the left."""
    dq = se3.so3_exp(dx[:, 3:6])
    return WindowState(q=se3.quat_normalize(se3.quat_mul(dq, state.q)),
                       p=state.p + dx[:, :3], v=state.v + dx[:, 6:9])


def window_residuals(dx_flat: torch.Tensor, state: WindowState, state0: WindowState,
                     imu_deltas: ImuDelta, odom_rel: se3.Pose, *, imu_weight: float,
                     odom_weight: float, prior_weight: float) -> torch.Tensor:
    """The window's weighted residual stack at ``state`` retracted by
    ``dx_flat`` (K·9,), in the JAX package's row order: for each pair i the
    IMU factor's 9 rows, then the between-factor's 6, then the 6 rows of the
    prior on state 0's pose (its velocity stays free). (K−1)·15 + 6 rows."""
    K = state.q.shape[0]
    st = _retract(state, dx_flat.reshape(K, 9))
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=st.p.dtype, device=st.p.device)
    i = torch.arange(K - 1, device=st.p.device)
    pairs = torch.cat([_imu_residual(st, i, imu_deltas, g) * imu_weight,
                       _between_residual(st, i, i + 1, odom_rel) * odom_weight], dim=-1)
    prior = torch.cat([st.p[0] - state0.p[0],
                       se3.so3_log(se3.quat_mul(st.q[0], se3.quat_conj(state0.q[0])))])
    return torch.cat([pairs.reshape(-1), prior * prior_weight])


def damped_step(H: torch.Tensor, gvec: torch.Tensor) -> torch.Tensor:
    """dx = −(H + 1e-6·diag(H))⁻¹ g by Cholesky. A matrix that is not
    positive definite (``cholesky_ex`` reports it, where JAX's Cholesky gives
    NaN) or a non-finite step gives dx = 0; nothing raises."""
    damp = 1e-6 * torch.clamp(torch.diagonal(H), min=1e-8)
    L, info = torch.linalg.cholesky_ex(H + torch.diag(damp))
    dx = torch.cholesky_solve(-gvec[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx))


def solve_window(state0: WindowState, imu_deltas: ImuDelta, odom_rel: se3.Pose, *,
                 imu_weight: float = 1.0, odom_weight: float = 100.0,
                 prior_weight: float = 1e4, n_iters: int = 8) -> WindowState:
    """Gauss-Newton over the window (IMU + odometry between-factors + the
    prior on state 0), ``n_iters`` iterations; returns the iterate of lowest
    χ² (≡ LSQNonlinear.hpp:42-48's revert-on-increase). ``imu_deltas`` and
    ``odom_rel`` are stacked (K−1,)."""
    K = state0.q.shape[0]
    dx0 = torch.zeros(K * 9, dtype=state0.p.dtype, device=state0.p.device)
    weights = dict(imu_weight=imu_weight, odom_weight=odom_weight, prior_weight=prior_weight)

    def residuals(dx, state):
        return window_residuals(dx, state, state0, imu_deltas, odom_rel, **weights)

    def cost(state):
        r = residuals(dx0, state)
        return torch.sum(r * r)

    state, best, best_cost = state0, state0, cost(state0)
    for _ in range(n_iters):
        J, r = torch.func.jacfwd(lambda dx: (residuals(dx, state),) * 2, has_aux=True)(dx0)
        dx = damped_step(J.T @ J, J.T @ r)
        state = _retract(state, dx.reshape(K, 9))
        c = cost(state)
        better = c < best_cost
        best = WindowState(*(torch.where(better, a, b) for a, b in zip(state, best)))
        best_cost = torch.where(better, c, best_cost)
    return best
