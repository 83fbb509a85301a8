"""Gauss-Newton pieces, ported from ``lidar_visual_odometry_tpu/ops/gn.py``
(≡ Ceres DENSE_QR + HuberLoss(0.1), ``laserOdometry.cpp:570-575``).

The scan-to-scan solve uses these for the de-skewed inner loop, which the fused
kernel K3 (``kernels.gn``) does not cover; the direct photometric tracker and
the window BA use the Student-t weights and ``nanmedian``. ``tdist_scale`` (the
reference's Student-t scale estimator) and ``lm_optimize`` (its
Levenberg-Marquardt driver) are library functions that no pipeline calls.
"""

from __future__ import annotations

import torch

from . import se3


def huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss: 1 inside δ, δ/|r| outside."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm),
                       delta / torch.clamp(r_norm, min=1e-12))


def tdist_weight(r: torch.Tensor, sigma: torch.Tensor, dof: float = 5.0) -> torch.Tensor:
    """Student-t weight (ν+1)/(ν+(r/σ)²) (≡ WeightFunction.cpp:91-95)."""
    x2 = (r / torch.clamp(sigma, min=1e-12)) ** 2
    return (dof + 1.0) / (dof + x2)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values of ``x`` (all axes) by the JAX package's
    rule, ``jnp.nanmedian`` = ``nanquantile(0.5, "linear")``: sort (NaNs
    last), q = 0.5·(n − 1) in float32 over the n valid values, and
    ``low·(1 − f) + high·f`` at floor and ceil of q. ``torch.nanmedian``
    returns the lower middle value instead, which differs at an even count.
    NaN when no value is valid."""
    a = torch.sort(x.reshape(-1)).values
    n = torch.sum(~torch.isnan(a)).to(torch.float32)
    q = 0.5 * (n - 1.0)
    low = torch.floor(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo = torch.clamp(torch.minimum(low, n - 1.0), min=0.0).to(torch.int64)
    hi = torch.clamp(torch.minimum(torch.ceil(q), n - 1.0), min=0.0).to(torch.int64)
    return a[lo] * low_w + a[hi] * high_w


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


def tdist_scale(r: torch.Tensor, mask: torch.Tensor, *, dof: float = 5.0,
                init_sigma: float = 5.0, iters: int = 10) -> torch.Tensor:
    """Student-t scale by ``iters`` fixed-point steps
    σ² ← Σ_valid (ν+1)/(ν + rᵢ²/σ²) · rᵢ² / n (≡ ``TDistributionScaleEstimator``,
    ``WeightFunction.cpp:20-78``). Masked rows are ignored."""
    m = mask.to(r.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    r2 = r * r
    sigma2 = torch.tensor(init_sigma ** 2, dtype=r.dtype, device=r.device)
    for _ in range(iters):
        w = (dof + 1.0) / (dof + r2 / torch.clamp(sigma2, min=1e-12))
        sigma2 = torch.clamp((w * r2 * m).sum() / n, min=1e-12)
    return torch.sqrt(sigma2)


def _select(pick: torch.Tensor, a, b):
    """``torch.where(pick, a, b)`` over a tensor or a tuple of tensors."""
    if isinstance(a, tuple):
        return type(a)(*(_select(pick, x, y) for x, y in zip(a, b)))
    return torch.where(pick, a, b)


def lm_optimize(build_system, update, apply_delta, x0, *, iters: int = 10,
                tau: float = 1e-2):
    """Levenberg-Marquardt with the gain-ratio schedule of the reference's
    ``LSQNonlinearLevenbergMarquardt`` (``LSQNonlinear.hpp:84-194``):
    damping μ·diag(H) from μ₀ = τ·max(diag H); ρ = (χ²_old − χ²_new) /
    ½δᵀ(μDδ − g); accept when ρ > 0 (μ ← μ·max(⅓, 1 − (2ρ−1)³), ν ← 2), else
    keep x (μ ← μν, ν ← 2ν). ``build_system(x) -> (H, g, χ²)`` for H δ = −g;
    ``update(x, δ) -> x``; ``apply_delta`` is unused. A rejected step uses an
    iteration. Every decision is a ``torch.where`` on the device: no host
    read. Returns (x, χ²)."""
    del apply_delta
    H0, g0, chi = build_system(x0)
    d = g0.shape[-1]
    eye = torch.eye(d, dtype=H0.dtype, device=H0.device)
    mu = tau * torch.max(torch.diagonal(H0))
    nu = torch.tensor(2.0, dtype=g0.dtype, device=g0.device)
    x = x0
    for _ in range(iters):
        H, g, _ = build_system(x)
        D = torch.clamp(torch.diagonal(H), min=1e-6)
        L, info = torch.linalg.cholesky_ex(H + eye * (mu * D))
        delta = torch.cholesky_solve(-g[:, None], L)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(delta))
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        x_new = update(x, delta)
        _, _, chi_new = build_system(x_new)
        pred = 0.5 * torch.dot(delta, mu * D * delta - g)
        rho = (chi - chi_new) / torch.clamp(pred, min=1e-12)
        accept = rho > 0.0
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        x = _select(accept, x_new, x)
        chi = torch.where(accept, chi_new, chi)
        mu = torch.where(accept, mu_acc, mu * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), 2.0 * nu)
    return x, chi
