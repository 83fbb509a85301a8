"""Square-root condensed photometric factor (≡ ``TwoFramePhotometricFunction``,
``src/Optimization/FrameTracker.cpp:26-71``, and ``FrameParameterization``,
``FrameParameterization.cpp:22-46``), ported from
``lidar_visual_odometry_tpu/models/sqrt_photometric.py``.

The weighted photometric Gauss-Newton system H = Σ wJᵀJ, b = −Σ wJᵀr of a
two-frame patch set is condensed into a 6-dim linear residual by
eigendecomposition,

    H = U S Uᵀ,   J_lin = S^½ Uᵀ,   r_lin = −S^{−½} Uᵀ b,

so that J_linᵀJ_lin = H and the least-squares step of the condensed factor
equals the full system's step on the non-degenerate eigen-subspace
(eigenvalues ≤ eps are zeroed, as the reference's ``eps`` select). The
parameterisation is the left update Plus(T, δ) = exp(δ)·T.

``torch.linalg.eigh`` may return an eigenvector with the other sign than
another library's, which flips the sign of a row of J_lin and of r_lin
together; J_linᵀJ_lin, J_linᵀr_lin and the step do not change.
"""

from __future__ import annotations

import torch

from ..ops import se3
from .tracker_direct import _photometric_system, normal_equations


def condense(H: torch.Tensor, g: torch.Tensor, eps: float = 1e-8):
    """Square-root condensation (FrameTracker.cpp:38-57): H (6, 6) PSD and g
    (6,) with GN step δ* = H⁺ g → (J_lin (6, 6), r_lin (6,)) with
    J_linᵀJ_lin = H (eps-clamped) and argmin |J_lin δ + r_lin|² = δ*."""
    w, U = torch.linalg.eigh((H + H.T) * 0.5)
    ok = w > eps
    s_sqrt = torch.sqrt(torch.where(ok, w, torch.zeros_like(w)))
    s_inv_sqrt = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(w, min=eps)), torch.zeros_like(w))
    J_lin = s_sqrt[:, None] * U.T
    r_lin = -s_inv_sqrt * (U.T @ g)
    return J_lin, r_lin


def photometric_sqrt_factor(T: se3.Pose, ref_img: torch.Tensor, cur_img: torch.Tensor,
                            pts_ref: torch.Tensor, mask: torch.Tensor, cam_l,
                            tdist_dof: float = 5.0):
    """The condensed two-frame factor at linearisation point ``T`` (cur ←
    ref): one pass over the patch set (the tracker's system), then
    ``condense``. Returns (J_lin, r_lin), the residual ρ(δ) = J_lin δ + r_lin
    of the photometric cost around T under T ← exp(δ)·T."""
    r, J, w, _ = _photometric_system(T, ref_img, cur_img, pts_ref, mask, cam_l, tdist_dof)
    H, g = normal_equations(r, J, w)
    return condense(H, -g)


def factor_step(J_lin: torch.Tensor, r_lin: torch.Tensor, lm_lambda: float = 0.0) -> torch.Tensor:
    """GN step of one condensed factor, δ = argmin |J_lin δ + r_lin|², with
    Levenberg damping ``lm_lambda`` on the condensed normal equations."""
    H = J_lin.T @ J_lin + lm_lambda * torch.eye(6, dtype=J_lin.dtype, device=J_lin.device)
    g = -J_lin.T @ r_lin
    return torch.linalg.solve(H, g)


def apply_step(T: se3.Pose, delta: torch.Tensor) -> se3.Pose:
    """FrameParameterization::Plus, the left tangent update
    (FrameParameterization.cpp:22-34)."""
    return se3.se3_compose(se3.se3_exp(delta), T)
