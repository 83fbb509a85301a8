"""Direct photometric tracker (≡ Tracker2, the dedvo-style dense VO), ported
from ``lidar_visual_odometry_tpu/models/tracker_direct.py``.

Coarse-to-fine photometric alignment of the current frame against a reference
keyframe (``src/vloam/Tracker2.cpp:60-360``): on each pyramid level the
keyframe's gradient-selected points project into the current image with the
4-pixel patch {(1,−1),(1,1),(−1,−1),(−1,1)} (``Tracker2.h:41-44``); residuals
are photometric differences less a per-level brightness offset, weighted by
Student-t on MAD-normalised errors (``compute_residuals``, ``:197-306``;
``WeightFunction.cpp:20-95``); the 6-dof Gauss-Newton step updates
left-multiplicatively, ``T ← exp(δ)·T`` (``:83-106``). Gradients are taken in
the current image (forward-compositional), as in the JAX package.

Samples are float32 4-tap gathers (``ops/image.bilinear``), the JAX package's
branch off the TPU; its one-hot MXU sampler is a TPU workaround and is not
ported.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import gn, image, se3
from .keyframe import Keyframe

# 4-pixel sparse patch (Tracker2.h:41-44)
PATCH = np.asarray([[1.0, -1.0], [1.0, 1.0], [-1.0, -1.0], [-1.0, 1.0]], np.float32)


# Gauss-Newton iterations run since ``reset_stats`` (profiling and the card
# smoke test read them)
stats = {"iterations": 0}


def reset_stats() -> None:
    stats["iterations"] = 0


@lru_cache(maxsize=None)
def _patch(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(PATCH).to(device)


def _level_cam(cam, level: int):
    s = 0.5 ** level
    return dataclasses.replace(cam, fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s,
                               cy=cam.cy * s, width=int(cam.width * s),
                               height=int(cam.height * s))


def _stack3(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The image and its gradients as one channels-last (1, H, W, 3) stack,
    sampled by one gather (``image.bilinear_stack``)."""
    return torch.stack([img, gx, gy], dim=-1)[None]


def _ref_samples(ref_img: torch.Tensor, pts_ref: torch.Tensor, mask: torch.Tensor, cam_l):
    """The pose-independent reference-side samples (N, 4) and validity (N,),
    computed once a level."""
    uv_ref, front_ref = cam_ops.project(cam_l, pts_ref)
    i_ref = image.bilinear(ref_img, uv_ref[:, None, :] + _patch(uv_ref.device)[None])
    ok_ref = mask & front_ref & cam_ops.is_in_image(cam_l, uv_ref, boundary=2.0)
    return i_ref, ok_ref


def _pixel_jacobian(cam_l, p: torch.Tensor):
    """∂u/∂p and ∂v/∂p (pinhole, no distortion: the tracker runs on rectified
    images) at camera-frame points p (N, 3), z clamped at 1e-3."""
    inv_z = 1.0 / torch.clamp(p[..., 2], min=1e-3)
    zero = torch.zeros_like(inv_z)
    du = torch.stack([cam_l.fx * inv_z, zero, -cam_l.fx * p[..., 0] * inv_z * inv_z], dim=-1)
    dv = torch.stack([zero, cam_l.fy * inv_z, -cam_l.fy * p[..., 1] * inv_z * inv_z], dim=-1)
    return du, dv


def _left_perturbation(p: torch.Tensor) -> torch.Tensor:
    """∂p/∂ξ = [I | −[p]×], (..., 3, 6)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    return torch.cat([eye, -se3.so3_hat(p)], dim=-1)


def _photometric_system_pre(T: se3.Pose, i_ref: torch.Tensor, ok_ref: torch.Tensor,
                            stack: torch.Tensor, pts_ref: torch.Tensor, cam_l,
                            tdist_dof: float):
    """Residuals r (N, 4), Jacobians J (N, 4, 6), weights w (N, 4) and
    validity (N,) at one level; ``stack`` is ``_stack3`` of the current
    image and its gradients."""
    p_cur = se3.se3_apply(T, pts_ref)
    uv_cur, front_cur = cam_ops.project(cam_l, p_cur)
    patch_cur = uv_cur[:, None, :] + _patch(uv_cur.device)[None]
    i_cur, gxs, gys = image.bilinear_stack(stack, patch_cur).unbind(-1)   # (N, 4) each

    z = p_cur[..., 2]
    du, dv = _pixel_jacobian(cam_l, p_cur)
    dp = _left_perturbation(p_cur)                              # (N, 3, 6)
    duv_dxi_u = (du[:, None, :] @ dp)[:, 0]                     # (N, 6)
    duv_dxi_v = (dv[:, None, :] @ dp)[:, 0]
    J = gxs[..., None] * duv_dxi_u[:, None, :] + gys[..., None] * duv_dxi_v[:, None, :]

    r = i_cur - i_ref
    ok = ok_ref & front_cur & cam_ops.is_in_image(cam_l, uv_cur, boundary=2.0) & (z > 0.1)
    # affine brightness offset (the per-level b of Tracker2.cpp:235-273)
    w_ok = ok[:, None].to(r.dtype)
    b = torch.sum(r * w_ok) / torch.clamp(torch.sum(w_ok) * 4.0, min=1.0)
    r = r - b

    # Student-t weights on MAD-normalised residuals, the median by JAX's rule
    absr = torch.abs(torch.where(ok[:, None], r, torch.full_like(r, float("nan"))))
    sigma = torch.clamp(1.4826 * gn.nanmedian(absr), min=1e-4)
    w = gn.tdist_weight(r, sigma, tdist_dof) * w_ok
    return r, J, w, ok


def _photometric_system(T: se3.Pose, ref_img: torch.Tensor, cur_img: torch.Tensor,
                        pts_ref: torch.Tensor, mask: torch.Tensor, cam_l, tdist_dof: float):
    """One-shot form (sqrt factor, tests): hoists nothing."""
    i_ref, ok_ref = _ref_samples(ref_img, pts_ref, mask, cam_l)
    gx, gy = image.gradients(cur_img)
    return _photometric_system_pre(T, i_ref, ok_ref, _stack3(cur_img, gx, gy), pts_ref,
                                   cam_l, tdist_dof)


def normal_equations(r: torch.Tensor, J: torch.Tensor, w: torch.Tensor):
    """H = Σ w JᵀJ (6, 6) and g = Σ w Jᵀr (6,) over every row of (..., 6)."""
    Jf = J.reshape(-1, 6)
    Jw = Jf * w.reshape(-1, 1)
    return Jw.T @ Jf, Jw.T @ r.reshape(-1)


def track(ref_kf: Keyframe, cur_pyr: tuple, cam, T_init: se3.Pose, *, levels: int = 4,
          iters_per_level: int = 10, tdist_dof: float = 5.0,
          step_tol: float = 1e-5) -> se3.Pose:
    """Estimate T (cur ← ref keyframe) coarse-to-fine (Tracker2::tracking).

    Each level's Gauss-Newton stops when the max-norm of the step drops
    below ``step_tol`` (``LSQNonlinear.hpp:56-60``) or after
    ``iters_per_level`` iterations, as the JAX package's ``while_loop``:
    the step's max-norm is read on the host once an iteration, and the pose
    is the one that loop returns. ``step_tol=0`` runs the fixed count with no
    read."""
    T = T_init
    for lvl in range(levels - 1, -1, -1):
        cam_l = _level_cam(cam, lvl)
        cur_img = cur_pyr[lvl]
        # per-level invariants: reference samples, current-image gradients
        i_ref, ok_ref = _ref_samples(ref_kf.pyramid[lvl], ref_kf.points, ref_kf.point_mask,
                                     cam_l)
        stack = _stack3(cur_img, *image.gradients(cur_img))
        for _ in range(iters_per_level):
            r, J, w, _ = _photometric_system_pre(T, i_ref, ok_ref, stack, ref_kf.points,
                                                 cam_l, tdist_dof)
            H, g = normal_equations(r, J, w)
            delta = gn.solve_damped(H, g, lm_lambda=1e-4)
            # left-multiplicative update T ← exp(δ)·T (Tracker2.cpp:90)
            T = se3.se3_compose(se3.se3_exp(delta), T)
            stats["iterations"] += 1
            if step_tol > 0.0 and not float(torch.max(torch.abs(delta))) >= step_tol:
                break
    return T
