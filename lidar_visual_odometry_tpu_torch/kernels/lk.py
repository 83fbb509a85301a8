"""K6: one pyramid level of inverse-compositional KLT, the counterpart of
``ops/pallas_lk.py`` ``lk_level`` (its default ``batch8`` body,
``_lk_level_kernel_b8``).

For each feature: one bilinear (win+2)² sample of ``img0`` around the feature
gives the template and, by central differences, both its gradients; then up
to ``iters`` Gauss-Newton steps, each one bilinear win² sample of ``img1`` at
the current displacement, solve either the 2×2 translation system or, with
``affine``, the 6-DOF system with four affine nuisance columns (a damped,
unrolled 6×6 Cholesky). A feature stops once its step is shorter than
``eps`` px. The TPU kernel's rules are kept exactly:

* the window *origin* clamps into the level (fractions taken before the
  clamp), which is where this kernel and the XLA gather path
  (``ops/lk._track_level``) differ near borders;
* inactive rows return (guess, ok = False) and never update;
* with ``affine`` a degenerate template (det ≤ 1e-9) returns the guess;
* ``fixed_affine`` (non-affine only) adds a constant deformation to the
  residual; ``return_affine`` (affine only) returns the fitted parameters,
  zero where not ``ok & active``.

A CUDA tensor goes to the hand-written kernel ``csrc/lk.cu``; a CPU tensor to
``lk_level_plain``. The kernel gives each feature one warp; both versions sum
the win² products in the warp's order (lane ``l`` adds elements ``l, l+32, …``
left to right, then a butterfly over the 32 lanes) and round every product and
sum on its own, so they agree bit for bit up to the library square root
(correctly rounded in both).

What bounds the kernel on the H100: neither bytes (two level images, ≤ 1 MB,
sit in L2) nor operations (~30 MFLOP for the bench's affine level-0 call, ~6
for each coarse 2×2 level: under a microsecond at the card's float32 rate),
but each feature's serial chain of iterations, each a dependent sample →
warp reduction → solve. One warp per feature; the kernel is instantiated for
windows 9, 13 and 25 (others run a runtime-window instance), so a lane's
elements are unrolled and all of an iteration's image loads are in flight
at once; up to win 15 the template, gradients and affine columns stay in
registers for all iterations (at win 25 in shared memory); the independent
warp sums of a step share each shuffle round. 768 features fill 192 blocks
of 4 warps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

#: relative Tikhonov damping of the affine block (``ops/lk.py`` ``_AFF_DAMP``)
AFF_DAMP = 0.03
_LANES = 32

#: launches of the CUDA kernel since the last reset
launches = 0

#: ctypes argument types of ``lvo_lk_level``: img0, img1, H, W, uv0, guess,
#: active, fixed_affine, N, win, iters, eps², affine, damping, the output, the
#: stream
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p, ctypes.c_void_p])


def _f32(x: float) -> float:
    return float(np.float32(x))


def check_modes(affine: bool, fixed_affine, return_affine: bool) -> None:
    """Raise ``ValueError`` for the mode combinations the TPU kernel asserts
    against or the XLA path accepts silently."""
    if fixed_affine is not None and affine:
        raise ValueError("fixed_affine applies to the non-affine solve only")
    if return_affine and not affine:
        raise ValueError("return_affine needs affine=True")


def _check_level(H: int, W: int, win: int, affine: bool, fixed_affine,
                 return_affine: bool) -> None:
    check_modes(affine, fixed_affine, return_affine)
    if win < 1 or H - win - 4 < 0 or W - win - 4 < 0:
        raise ValueError(f"lk_level: a ({H}, {W}) level is too small for window {win}")


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a warp's order: lane l adds elements
    l, l + 32, … left to right, then a butterfly over the lanes (16, 8, 4,
    2, 1). Every lane of the warp ends with this value."""
    M = x.shape[-1]
    K = -(-M // _LANES)
    x = torch.nn.functional.pad(x, (0, K * _LANES - M)).reshape(*x.shape[:-1], K, _LANES)
    s = x[..., 0, :]
    for k in range(1, K):
        s = s + x[..., k, :]
    lane = torch.arange(_LANES, device=x.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off]
    return s[..., 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device."""
    return torch.sqrt(x.double()).float()


def _corner(xf, yf, w: int, H: int, W: int):
    """Integer window origin, clamped so a (w+1)-wide read stays inside the
    level, and the fractions of the unclamped position."""
    flx, fly = torch.floor(xf), torch.floor(yf)
    xi = torch.clamp(flx.to(torch.int64), 0, W - w - 1)
    yi = torch.clamp(fly.to(torch.int64), 0, H - w - 1)
    return xi, yi, xf - flx, yf - fly


def _patch(img, xi, yi, fx, fy, n: int):
    """(N, n, n) bilinear patch from origin (xi, yi): rows mix first, then
    columns."""
    W = img.shape[1]
    a = torch.arange(n + 1, device=img.device)
    idx = (yi[:, None, None] + a[None, :, None]) * W + (xi[:, None, None] + a[None, None, :])
    S = img.reshape(-1)[idx]                                   # (N, n+1, n+1)
    fy3, fx3 = fy[:, None, None], fx[:, None, None]
    v = S[:, :n, :] * (1.0 - fy3) + S[:, 1:, :] * fy3          # (N, n, n+1)
    return v[:, :, :n] * (1.0 - fx3) + v[:, :, 1:] * fx3


def _chol6(Hm):
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = Hm[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = _sqrt(torch.clamp(s, min=1e-12)) if i == j else s / L[j][j]
    return L


def _solve6(L, b):
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def lk_level_plain(
    img0: torch.Tensor, img1: torch.Tensor, uv0: torch.Tensor, guess: torch.Tensor,
    active: torch.Tensor | None = None, fixed_affine: torch.Tensor | None = None,
    *, win: int = 25, iters: int = 10, eps: float = 0.0, affine: bool = False,
    return_affine: bool = False, return_iters: bool = False,
):
    """Plain PyTorch version of the kernel, vectorised over features; the
    same arguments and results as ``lk_level``."""
    H, W = img0.shape
    _check_level(H, W, win, affine, fixed_affine, return_affine)
    N = uv0.shape[0]
    dev = uv0.device
    act = torch.ones(N, dtype=torch.bool, device=dev) if active is None else active.to(torch.bool)
    r = (win - 1) / 2.0
    tx = uv0[:, 0] - r
    ty = uv0[:, 1] - r

    # template and gradients from one (win+2)² sample
    xi, yi, fx, fy = _corner(tx - 1.0, ty - 1.0, win + 3, H, W)
    p = _patch(img0, xi, yi, fx, fy, win + 2)
    t = p[:, 1:win + 1, 1:win + 1].reshape(N, -1)
    jx = (0.5 * (p[:, 1:win + 1, 2:win + 2] - p[:, 1:win + 1, 0:win])).reshape(N, -1)
    jy = (0.5 * (p[:, 2:win + 2, 1:win + 1] - p[:, 0:win, 1:win + 1])).reshape(N, -1)
    a11, a12, a22 = _lane_sum(torch.stack([jx * jx, jx * jy, jy * jy], dim=1)).unbind(1)
    det = a11 * a22 - a12 * a12
    ok = det > 1e-9

    grid = torch.arange(win, dtype=torch.float32, device=dev) - r
    ox = grid[None, :].expand(win, win).reshape(1, -1)
    oy = grid[:, None].expand(win, win).reshape(1, -1)
    if affine:
        cols = torch.stack([jx, jy, jx * ox, jx * oy, jy * ox, jy * oy], dim=1)   # (N, 6, M)
        pairs = [(i, j) for i in range(6) for j in range(i + 1)]
        sums = _lane_sum(torch.stack([cols[:, i] * cols[:, j] for i, j in pairs], dim=1))
        Hm = [[None] * 6 for _ in range(6)]
        damp = _f32(1.0 + AFF_DAMP)
        for k, (i, j) in enumerate(pairs):
            v = sums[:, k]
            if i == j:
                if i >= 2:
                    v = v * damp
                v = v + 1e-6
            Hm[i][j] = Hm[j][i] = v
        L = _chol6(Hm)
        npar = 6
    else:
        inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12), torch.zeros_like(det))
        npar = 2
        if fixed_affine is not None:
            fa = fixed_affine.to(torch.float32)
            corr = ((fa[:, 0:1] * ox + fa[:, 1:2] * oy) * jx, (fa[:, 2:3] * ox + fa[:, 3:4] * oy) * jy)

    params = [guess[:, 0], guess[:, 1]] + [torch.zeros_like(tx)] * (npar - 2)
    dd2 = torch.where(act, torch.full_like(tx, float("inf")), torch.zeros_like(tx))
    eps2 = _f32(eps * eps)
    n_iter = torch.zeros(N, dtype=torch.int32, device=dev)
    for _ in range(iters):
        live = dd2 >= eps2
        xi, yi, fx, fy = _corner(tx + params[0], ty + params[1], win + 1, H, W)
        e = _patch(img1, xi, yi, fx, fy, win).reshape(N, -1) - t
        if affine:
            pa = [q[:, None] for q in params[2:]]
            e = e + (pa[0] * ox + pa[1] * oy) * jx + (pa[2] * ox + pa[3] * oy) * jy
            b = _lane_sum(e[:, None, :] * cols).unbind(1)
            dp = _solve6(L, b)
        else:
            if fixed_affine is not None:
                e = e + corr[0] + corr[1]
            b1, b2 = _lane_sum(torch.stack([e * jx, e * jy], dim=1)).unbind(1)
            dp = [inv_det * (a22 * b1 - a12 * b2), inv_det * (a11 * b2 - a12 * b1)]
        step2 = dp[0] * dp[0] + dp[1] * dp[1]
        params = [torch.where(live, q - d, q) for q, d in zip(params, dp)]
        dd2 = torch.where(live, step2, dd2)
        n_iter += (live & act).to(torch.int32)

    d = torch.stack(params[:2], dim=1)
    if affine:
        d = torch.where(ok[:, None], d, guess)
    d = torch.where(act[:, None], d, guess)
    out = [d, ok & act]
    if return_affine:
        gate = (ok & act)[:, None]
        A = torch.stack(params[2:], dim=1)
        out.append(torch.where(gate, A, torch.zeros_like(A)))
    if return_iters:
        out.append(torch.where(act, n_iter, torch.zeros_like(n_iter)))
    return tuple(out)


def lk_level(
    img0: torch.Tensor, img1: torch.Tensor, uv0: torch.Tensor, guess: torch.Tensor,
    active: torch.Tensor | None = None, fixed_affine: torch.Tensor | None = None,
    *, win: int = 25, iters: int = 10, eps: float = 0.0, affine: bool = False,
    return_affine: bool = False, return_iters: bool = False,
):
    """Refined displacement ``d`` (N, 2) and Hessian-ok flag (N,) for one
    pyramid level; ``return_affine`` appends the fitted affine parameters
    (N, 4), ``return_iters`` the iterations each feature ran (N,) int32.
    img0, img1 (H, W) float32; uv0 (level pixels) and guess (N, 2); active
    (N,) bool or None; fixed_affine (N, 4) or None."""
    kw = dict(win=win, iters=iters, eps=eps, affine=affine, return_affine=return_affine,
              return_iters=return_iters)
    if uv0.device.type == "cpu":
        return lk_level_plain(img0, img1, uv0, guess, active, fixed_affine, **kw)
    H, W = img0.shape
    _check_level(H, W, win, affine, fixed_affine, return_affine)
    N = uv0.shape[0]
    dev = uv0.device
    if active is None:
        active = torch.ones(N, dtype=torch.bool, device=dev)
    tensors = {"img0": (img0, (H, W)), "img1": (img1, (H, W)), "uv0": (uv0, (N, 2)),
               "guess": (guess, (N, 2)), "active": (active, (N,))}
    if fixed_affine is not None:
        tensors["fixed_affine"] = (fixed_affine, (N, 4))
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"lk_level: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != (torch.bool if name == "active" else torch.float32):
            raise TypeError(f"lk_level: {name} has dtype {t.dtype}")
        if t.device != dev or dev.type != "cuda":
            raise ValueError("lk_level: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"lk_level: {name} must be contiguous")
    out = _launch(img0, img1, uv0, guess, active, fixed_affine, win=win, iters=iters, eps=eps,
                  affine=affine)
    res = [out[:, :2], out[:, 2] > 0.5]
    if return_affine:
        res.append(out[:, 4:8])
    if return_iters:
        res.append(out[:, 3].to(torch.int32))
    return tuple(res)


def _launch(img0, img1, uv0, guess, active, fixed_affine, *, win, iters, eps, affine):
    """Launch the kernel on checked tensors; returns its (N, 8) rows
    [dx, dy, ok, iterations, a0..a3]."""
    global launches
    H, W = img0.shape
    N = uv0.shape[0]
    out = torch.empty((N, 8), dtype=torch.float32, device=uv0.device)
    fa_ptr = fixed_affine.data_ptr() if fixed_affine is not None else None
    fn = _build.launcher("lk", "lvo_lk_level", _ARGTYPES)
    rc = fn(img0.data_ptr(), img1.data_ptr(), H, W, uv0.data_ptr(), guess.data_ptr(),
            active.data_ptr(), fa_ptr, N, win, iters, _f32(eps * eps), int(affine),
            _f32(1.0 + AFF_DAMP), out.data_ptr(), _build.stream(uv0))
    _build.check(rc, "lk_level")
    launches += 1
    return out
