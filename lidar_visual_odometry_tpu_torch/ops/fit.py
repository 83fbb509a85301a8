"""Batched geometric fits for scan-to-map association, ported from
``lidar_visual_odometry_tpu/ops/fit.py``:

* ``line_fit`` ≡ the 5-NN PCA line fit (``laserMapping.cpp:582-621``): accept
  when the dominant covariance eigenvalue is 3× the runner-up, direction = its
  eigenvector;
* ``plane_fit`` ≡ the 5-NN plane fit solving ``A·n = −1`` (``:648-687``), with
  the 0.2 m planarity gate.

Both are closed form and elementwise (Cardano eigenvalues, cross-product
eigenvectors, Cramer's rule with cofactor determinants): no batched LAPACK
call. The reference's ``jnp.linalg.det`` runs an LU factorisation; the
cofactor expansion rounds differently, by about 1e-6 relative on
well-conditioned 3×3 inputs (``tests/test_torch_mapping.py`` measures it).
"""

from __future__ import annotations

import math

import torch

from .se3 import _cross


def det3x3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion along the first row."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def eigh3x3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending, (..., 3)) and eigenvectors (columns, (..., 3, 3))
    of symmetric (..., 3, 3): Cardano's trigonometric formula, then cross
    products of the two most independent rows of A − λI. A repeated
    eigenvalue gives *an* orthonormal basis, enough for the λmax > 3·λmid
    gate."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    A_sh = A - q[..., None, None] * eye
    p2 = torch.sum(A_sh * A_sh, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = A_sh / p[..., None, None]
    phi = torch.arccos(torch.clamp(det3x3(B) / 2.0, -1.0, 1.0)) / 3.0
    e1 = 2.0 * torch.cos(phi)
    e2 = 2.0 * torch.cos(phi - 2.0 * math.pi / 3.0)
    e3 = 2.0 * torch.cos(phi + 2.0 * math.pi / 3.0)
    lams = q[..., None] + p[..., None] * torch.stack([e3, e2, e1], dim=-1)
    lams = torch.sort(lams, dim=-1).values

    def eigvec(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        v = torch.where(n01 >= torch.maximum(n02, n12), c01,
                        torch.where(n02 >= n12, c02, c12))
        nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        unit = torch.zeros_like(v)
        unit[..., 0] = 1.0
        return torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-12), unit)

    vecs = torch.stack([eigvec(lams[..., 0]), eigvec(lams[..., 1]), eigvec(lams[..., 2])],
                       dim=-1)
    return lams, vecs


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x = (..., 3) by Cramer's rule; zero where |det| ≤ 1e-12."""
    det = det3x3(A)
    cols = []
    for i in range(3):
        Ai = A.clone()
        Ai[..., :, i] = b
        cols.append(det3x3(Ai))
    x = torch.stack(cols, dim=-1)
    safe = det.abs() > 1e-12
    return torch.where(safe[..., None], x / torch.where(safe, det, torch.ones_like(det))[..., None],
                       torch.zeros_like(x))


def _outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., k, :]ᵀ b[..., k, :] → (..., 3, 3), elementwise (no matrix
    product, so no TF32 question on the card)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def line_fit(nbrs: torch.Tensor, nbr_mask: torch.Tensor, *, eig_ratio: float = 3.0):
    """PCA line fit over (..., K, 3) neighbourhoods → (centroid (..., 3), unit
    direction (..., 3), ok (...,)) with ok = all K valid and
    λmax > eig_ratio · λmid (``laserMapping.cpp:607``)."""
    w = nbr_mask[..., None].to(nbrs.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-2), min=1.0)
    centroid = torch.sum(nbrs * w, dim=-2) / cnt
    d = (nbrs - centroid[..., None, :]) * w
    cov = _outer_sum(d, d) / cnt[..., None]
    lams, vecs = eigh3x3(cov)
    ok = torch.all(nbr_mask, dim=-1) & (
        lams[..., 2] > eig_ratio * torch.clamp(lams[..., 1], min=0.0))
    return centroid, vecs[..., :, 2], ok


def plane_fit(nbrs: torch.Tensor, nbr_mask: torch.Tensor, *, tol: float = 0.2):
    """Fit n·p + d = 0, |n| = 1, by solving A·m = −1 over (..., K, 3) → (unit
    normal, offset d, ok) with ok = all K valid and every neighbour within
    ``tol`` of the plane (``laserMapping.cpp:665-675``)."""
    w = nbr_mask[..., None].to(nbrs.dtype)
    Aw = nbrs * w
    AtA = _outer_sum(Aw, nbrs * w)
    Atb = torch.sum(Aw * -1.0, dim=-2)
    m = solve3x3(AtA, Atb)
    norm = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    n = m / torch.clamp(norm, min=1e-12)
    dist = 1.0 / torch.clamp(norm[..., 0], min=1e-12)
    resid = torch.abs(torch.sum(nbrs * n[..., None, :], dim=-1) + dist[..., None])
    ok = (
        torch.all(nbr_mask, dim=-1)
        & (norm[..., 0] > 1e-12)
        & torch.all(torch.where(nbr_mask, resid, torch.zeros_like(resid)) <= tol, dim=-1)
    )
    return n, dist, ok
