"""Pyramidal Lucas-Kanade optical flow, ported from
``lidar_visual_odometry_tpu/ops/lk.py`` (≡ ``cv::calcOpticalFlowPyrLK``,
``featureTracking.cpp:203-211``, with the forward/backward gate of
``:214-237``).

Each level goes where the JAX package sends it on the TPU: to kernel K6
(``kernels.lk.lk_level``) when the level has room for the window's clamped
origin (``H − win − 4 ≥ 0`` and ``W − win − 4 ≥ 0``) and the slot count
``uv0.shape[0]`` is a multiple of 8 (the TPU kernel's batches of 8 features),
else to the gather path ``_track_level``, the JAX package's XLA formulation
(each sample clamped, a fixed iteration count, no ``active`` skip, no ``eps``
exit). The bench's 768 slots and the default 1024 take the kernel on every
level that fits.
"""

from __future__ import annotations

import torch

from ..kernels import lk as klk
from ..kernels.lk import AFF_DAMP as _AFF_DAMP
from .image import bilinear, gradients


def _window_offsets(win: int, device=None) -> torch.Tensor:
    r = (win - 1) / 2.0
    xs = torch.linspace(-r, r, win, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)    # (win², 2)


def _track_level(img0, img1, gx, gy, uv0, guess, *, win: int, iters: int,
                 affine: bool = False, fixed_affine=None, return_affine: bool = False):
    """One pyramid level of inverse-compositional KLT by gathers, for all
    features at once (the JAX package's vmapped XLA path): bilinear samples
    of the image and of its gradient images, each sample clamped into the
    image, ``iters`` steps for every feature. ``affine`` adds the four affine
    nuisance columns (damped, solved by an explicit inverse)."""
    N = uv0.shape[0]
    offs = _window_offsets(win, uv0.device)
    ox, oy = offs[:, 0], offs[:, 1]
    if fixed_affine is None:
        fixed_affine = torch.zeros((N, 4), dtype=torch.float32, device=uv0.device)
    pts0 = uv0[:, None, :] + offs[None]                              # (N, W2, 2)
    t = bilinear(img0, pts0)
    jx = bilinear(gx, pts0)
    jy = bilinear(gy, pts0)
    a11 = torch.sum(jx * jx, dim=1)
    a12 = torch.sum(jx * jy, dim=1)
    a22 = torch.sum(jy * jy, dim=1)
    det = a11 * a22 - a12 * a12
    ok = det > 1e-9
    d = guess

    if not affine:
        inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12), torch.zeros_like(det))
        fa = fixed_affine
        corr = (fa[:, 0:1] * ox + fa[:, 1:2] * oy) * jx + (fa[:, 2:3] * ox + fa[:, 3:4] * oy) * jy
        for _ in range(iters):
            cur = bilinear(img1, pts0 + d[:, None, :])
            e = cur - t + corr
            b1 = torch.sum(e * jx, dim=1)
            b2 = torch.sum(e * jy, dim=1)
            dd = inv_det[:, None] * torch.stack([a22 * b1 - a12 * b2, a11 * b2 - a12 * b1], dim=-1)
            d = d - dd
        A = torch.zeros((N, 4), dtype=torch.float32, device=uv0.device)
    else:
        J = torch.stack([jx, jy, jx * ox, jx * oy, jy * ox, jy * oy], dim=-1)   # (N, W2, 6)
        Hm = J.transpose(1, 2) @ J
        diag = torch.diagonal(Hm, dim1=-2, dim2=-1)
        damp = torch.cat([torch.zeros_like(diag[:, :2]), _AFF_DAMP * diag[:, 2:]], dim=1)
        Hm = Hm + torch.diag_embed(damp) + 1e-6 * torch.eye(6, device=uv0.device)
        Hinv = torch.where(ok, 1.0, 0.0)[:, None, None] * torch.linalg.inv(Hm)
        A = torch.zeros((N, 4), dtype=torch.float32, device=uv0.device)
        for _ in range(iters):
            cur = bilinear(img1, pts0 + d[:, None, :])
            e = (cur - t + (A[:, 0:1] * ox + A[:, 1:2] * oy) * jx
                 + (A[:, 2:3] * ox + A[:, 3:4] * oy) * jy)
            dp = (Hinv @ (J.transpose(1, 2) @ e[..., None]))[..., 0]
            d = d - dp[:, :2]
            A = A - dp[:, 2:]
        A = torch.where(ok[:, None], A, torch.zeros_like(A))
    if return_affine:
        return d, ok, A
    return d, ok


def track_pyramid(
    pyr0, pyr1, uv0: torch.Tensor, init_d: torch.Tensor | None = None,
    active: torch.Tensor | None = None, fixed_affine: torch.Tensor | None = None,
    *, win: int = 25, iters: int = 10, levels: int = 4, iters_coarse: int | None = None,
    eps: float = 0.0, affine: bool = False, return_affine: bool = False,
):
    """Track features uv0 (N, 2, level-0 pixels) from pyr0 to pyr1,
    coarse to fine over ``levels``; returns (uv1 (N, 2), ok (N,)) [+ the
    finest level's affine parameters (N, 4) with ``return_affine``].

    init_d: warm start in level-0 pixels (scaled to the top level); active:
    rows to solve (the kernel skips the others); iters_coarse: iterations on
    levels > 0 (None = ``iters``); eps: per-feature step exit in px; affine:
    the 6-DOF solve at the finest level; fixed_affine: a constant deformation
    correction at the finest level (non-affine only)."""
    klk.check_modes(affine, fixed_affine, return_affine)
    scale_top = 2.0 ** (levels - 1)
    d = torch.zeros_like(uv0) if init_d is None else init_d / scale_top
    ok_all = torch.ones(uv0.shape[0], dtype=torch.bool, device=uv0.device)
    A_out = torch.zeros((uv0.shape[0], 4), dtype=torch.float32, device=uv0.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        it = iters if (lvl == 0 or iters_coarse is None) else iters_coarse
        img0, img1 = pyr0[lvl], pyr1[lvl]
        fits = img0.shape[0] - win - 4 >= 0 and img0.shape[1] - win - 4 >= 0
        to_kernel = fits and uv0.shape[0] % 8 == 0     # the TPU's routing
        aff = affine and lvl == 0
        fixa = fixed_affine if lvl == 0 else None
        ret_a = return_affine and aff
        if to_kernel:
            res = klk.lk_level(img0, img1, (uv0 / s).contiguous(), d.contiguous(), active, fixa,
                               win=win, iters=it, eps=eps, affine=aff, return_affine=ret_a)
        else:
            gx, gy = gradients(img0)
            res = _track_level(img0, img1, gx, gy, uv0 / s, d, win=win, iters=it, affine=aff,
                               fixed_affine=fixa, return_affine=ret_a)
        if ret_a:
            d, ok, A_out = res
        else:
            d, ok = res
        ok_all = ok_all & ok
        if lvl > 0:
            d = d * 2.0
    uv1 = uv0 + d
    H, W = pyr1[0].shape
    inb = (uv1[:, 0] >= 1) & (uv1[:, 0] < W - 1) & (uv1[:, 1] >= 1) & (uv1[:, 1] < H - 1)
    if return_affine:
        return uv1, ok_all & inb, A_out
    return uv1, ok_all & inb


def track_pyramid_reverse_checked(
    pyr0, pyr1, uv0: torch.Tensor, active: torch.Tensor | None = None,
    init_d: torch.Tensor | None = None,
    *, win: int = 25, iters: int = 10, levels: int = 4, max_reverse_err: float = 1.0,
    reverse_levels: int | None = None, iters_coarse: int | None = None, eps: float = 0.0,
    affine: bool = False, reverse_affine: bool | str = True,
):
    """Forward track, then a reverse track from the result back to pyr0;
    a feature passes when both succeed and the round trip lands within
    ``max_reverse_err`` px. ``reverse_levels`` < ``levels`` runs a shallow
    reverse over the finest levels only, warm-started at the negated forward
    flow. ``reverse_affine`` ∈ {"solve" (True), "fixed", "none" (False)}: the
    reverse leg's deformation model ("fixed" needs ``affine`` and uses the
    forward fit, negated, as a constant correction)."""
    mode = ("solve" if reverse_affine else "none") if isinstance(reverse_affine, bool) \
        else reverse_affine
    if mode not in ("solve", "fixed", "none"):
        raise ValueError(f"reverse_affine must be 'solve', 'fixed' or 'none', got {reverse_affine!r}")
    if mode == "fixed" and not affine:
        raise ValueError("reverse_affine='fixed' needs affine=True (it reuses the forward fit)")
    want_A = mode == "fixed"
    fwd = track_pyramid(pyr0, pyr1, uv0, init_d, active, win=win, iters=iters, levels=levels,
                        iters_coarse=iters_coarse, eps=eps, affine=affine, return_affine=want_A)
    if want_A:
        uv1, ok_f, A = fwd
    else:
        uv1, ok_f = fwd
    rl = levels if reverse_levels is None else min(reverse_levels, levels)
    act_b = ok_f if active is None else (active & ok_f)
    uv0_back, ok_b = track_pyramid(
        pyr1[:rl], pyr0[:rl], uv1, uv0 - uv1, act_b, -A if want_A else None,
        win=win, iters=iters, levels=rl, iters_coarse=iters_coarse, eps=eps,
        affine=affine and mode == "solve",
    )
    diff = uv0_back - uv0
    err = torch.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]).double()).float()
    return uv1, ok_f & ok_b & (err <= max_reverse_err)
