"""K3: fused Gauss-Newton inner loop, the counterpart of ``ops/pallas_gn.py``.

``gn_inner_loop`` runs ``n_iters`` scan-to-scan GN iterations at fixed
correspondences (point-to-line edges, point-to-plane planes, Huber IRLS
weights, damped 6×6 Cholesky, left-multiplicative update) and returns the new
pose ``(q (4,), t (3,))``. Point arrays use the TPU kernel's layout: (3, N)
rows, weights (1, N) with 0 for masked correspondences. A CUDA tensor goes to
the hand-written kernel ``csrc/gn.cu``; a CPU tensor goes to
``gn_inner_loop_plain``, which follows the kernel's math (pivots clamped at
1e-12, the update skipped when the step is not finite) rather than
``ops/gn.solve_damped``'s NaN guard.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset
launches = 0


def _quat_mat(qw, qx, qy, qz):
    return (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy),
    )


def _chol6_solve(H, g):
    """Unrolled 6×6 Cholesky solve of H x = −g over 0-d tensors."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = H[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s = H[j][i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv
    y = [None] * 6
    for i in range(6):
        s = -g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def gn_inner_loop_plain(
    pose_q, pose_t, edge_p, edge_a, edge_b, edge_w,
    plane_p, plane_j, plane_l, plane_m, plane_w,
    *, n_iters: int = 4, huber_delta: float = 0.1, lm_lambda: float = 1e-4,
):
    """Plain PyTorch version of the kernel's math (vectorized over N)."""
    epx, epy, epz = edge_p
    eax, eay, eaz = edge_a
    ebx, eby, ebz = edge_b
    ew = edge_w[0]
    ppx, ppy, ppz = plane_p
    pjx, pjy, pjz = plane_j
    plx, ply, plz = plane_l
    pmx, pmy, pmz = plane_m
    pw = plane_w[0]

    v1x, v1y, v1z = pjx - plx, pjy - ply, pjz - plz
    v2x, v2y, v2z = pjx - pmx, pjy - pmy, pjz - pmz
    nx = v1y * v2z - v1z * v2y
    ny = v1z * v2x - v1x * v2z
    nz = v1x * v2y - v1y * v2x
    ninv = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-18))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

    dx_, dy_, dz_ = eax - ebx, eay - eby, eaz - ebz
    dninv = torch.rsqrt(torch.clamp(dx_ * dx_ + dy_ * dy_ + dz_ * dz_, min=1e-18))
    m01, m02 = dz_ * dninv, -dy_ * dninv
    m10, m12 = -dz_ * dninv, dx_ * dninv
    m20, m21 = dy_ * dninv, -dx_ * dninv
    zero = torch.zeros_like(m01)

    pose = [pose_q[i] for i in range(4)] + [pose_t[i] for i in range(3)]
    for _ in range(n_iters):
        qw, qx, qy, qz, tx, ty, tz = pose
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = _quat_mat(qw, qx, qy, qz)

        ypx = r00 * epx + r01 * epy + r02 * epz
        ypy = r10 * epx + r11 * epy + r12 * epz
        ypz = r20 * epx + r21 * epy + r22 * epz
        yx, yy, yz = ypx + tx, ypy + ty, ypz + tz
        ux, uy, uz = yx - eax, yy - eay, yz - eaz
        vx, vy, vz = yx - ebx, yy - eby, yz - ebz
        rx = (uy * vz - uz * vy) * dninv
        ry = (uz * vx - ux * vz) * dninv
        rz = (ux * vy - uy * vx) * dninv
        rn = torch.sqrt(rx * rx + ry * ry + rz * rz)
        wh = torch.where(rn <= huber_delta, torch.ones_like(rn),
                         huber_delta / torch.clamp(rn, min=1e-12))
        we = wh * ew

        def edge_row(Md0, Md1, Md2):
            return (
                Md0, Md1, Md2,
                Md1 * (-ypz) + Md2 * ypy,
                Md0 * ypz + Md2 * (-ypx),
                Md0 * (-ypy) + Md1 * ypx,
            )

        J0 = edge_row(zero, m01, m02)
        J1 = edge_row(m10, zero, m12)
        J2 = edge_row(m20, m21, zero)

        qpx = r00 * ppx + r01 * ppy + r02 * ppz
        qpy = r10 * ppx + r11 * ppy + r12 * ppz
        qpz = r20 * ppx + r21 * ppy + r22 * ppz
        rp = (qpx + tx - pjx) * nx + (qpy + ty - pjy) * ny + (qpz + tz - pjz) * nz
        arp = rp.abs()
        whp = torch.where(arp <= huber_delta, torch.ones_like(arp),
                          huber_delta / torch.clamp(arp, min=1e-12))
        wp = whp * pw
        Jp = (nx, ny, nz, qpy * nz - qpz * ny, qpz * nx - qpx * nz, qpx * ny - qpy * nx)

        # H = Σ w J Jᵀ, g = Σ w J r over every residual row (planes, then the
        # three edge rows), as two products in full float32
        J = torch.cat([torch.stack(Jr) for Jr in (Jp, J0, J1, J2)], dim=1)  # (6, M)
        r = torch.cat([rp, rx, ry, rz])
        w = torch.cat([wp, we, we, we])
        Jw = J * w
        Hm = Jw @ J.T
        gv = Jw @ r
        H = [[Hm[i, j] for j in range(6)] for i in range(6)]
        g = [gv[i] for i in range(6)]
        for i in range(6):
            H[i][i] = H[i][i] + lm_lambda * torch.clamp(H[i][i], min=1e-6)
        x = _chol6_solve(H, g)

        wx, wy, wz = x[3], x[4], x[5]
        th2 = wx * wx + wy * wy + wz * wz
        th = torch.sqrt(torch.clamp(th2, min=1e-32))
        small = th2 < 1e-6
        kk = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
        cw = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
        dw, dxq, dyq, dzq = cw, kk * wx, kk * wy, kk * wz
        nqw = dw * qw - dxq * qx - dyq * qy - dzq * qz
        nqx = dw * qx + dxq * qw + dyq * qz - dzq * qy
        nqy = dw * qy - dxq * qz + dyq * qw + dzq * qx
        nqz = dw * qz + dxq * qy - dyq * qx + dzq * qw
        norm = torch.rsqrt(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz)
        finite = torch.isfinite(x[0] + x[1] + x[2] + th2)
        new = (nqw * norm, nqx * norm, nqy * norm, nqz * norm,
               tx + x[0], ty + x[1], tz + x[2])
        pose = [torch.where(finite, n, o) for n, o in zip(new, pose)]
    return torch.stack(pose[:4]), torch.stack(pose[4:])


def gn_inner_loop(
    pose_q, pose_t, edge_p, edge_a, edge_b, edge_w,
    plane_p, plane_j, plane_l, plane_m, plane_w,
    *, n_iters: int = 4, huber_delta: float = 0.1, lm_lambda: float = 1e-4,
):
    """Fused GN loop. Points (3, N), weights (1, N), pose q (4,), t (3,);
    returns (q, t)."""
    kw = dict(n_iters=n_iters, huber_delta=huber_delta, lm_lambda=lm_lambda)
    args = (pose_q, pose_t, edge_p, edge_a, edge_b, edge_w,
            plane_p, plane_j, plane_l, plane_m, plane_w)
    if pose_q.device.type == "cpu":
        return gn_inner_loop_plain(*args, **kw)
    global launches
    Ne, Np = edge_p.shape[1], plane_p.shape[1]
    shapes = ((4,), (3,), (3, Ne), (3, Ne), (3, Ne), (1, Ne),
              (3, Np), (3, Np), (3, Np), (3, Np), (1, Np))
    for t, shp in zip(args, shapes):
        if tuple(t.shape) != shp:
            raise ValueError(f"gn_inner_loop: expected shape {shp}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError("gn_inner_loop takes float32 tensors")
        if t.device != pose_q.device or t.device.type != "cuda":
            raise ValueError("gn_inner_loop: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("gn_inner_loop takes contiguous tensors")
    lib = _build.load("gn")
    fn = lib.lvo_gn_inner_loop
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    pose_in = torch.cat([pose_q, pose_t])
    pose_out = torch.empty(8, dtype=torch.float32, device=pose_q.device)
    rc = fn(pose_in.data_ptr(), edge_p.data_ptr(), edge_a.data_ptr(), edge_b.data_ptr(),
            edge_w.data_ptr(), Ne, plane_p.data_ptr(), plane_j.data_ptr(),
            plane_l.data_ptr(), plane_m.data_ptr(), plane_w.data_ptr(), Np,
            pose_out.data_ptr(), int(n_iters), float(huber_delta), float(lm_lambda),
            torch.cuda.current_stream(pose_q.device).cuda_stream)
    _build.check(rc, "gn_inner_loop")
    launches += 1
    return pose_out[:4], pose_out[4:7]
