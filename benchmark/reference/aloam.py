"""Plain reference of the lidar chain that the benchmark's configurations run:
scan registration (polar2 ingest, curvature features), scan-to-scan odometry
and device-map scan-to-map refinement, as A-LOAM's scanRegistration,
laserOdometry and laserMapping define them and as the configuration file
states their settings.

It is written from the semantics, in plain PyTorch and NumPy, with none of
the program's kernels, sort pipelines or fused loops: every nearest neighbour
is a dense distance matrix (a matrix product, as ``torch.cdist`` forms it),
every least-squares system a matrix product, every fit a LAPACK call. It
imports nothing of the program and takes nothing the program made: it packs
and decodes the raw scans itself.

``Arith`` fixes the dtype, the device and the precision of matrix products.
The check runs in float64. The control runs in float32 with every matrix
product's operands rounded to TF32 (10 mantissa bits), the step below the
program's float32 with TF32 off.

Two uses:

* ``check_odometry`` / ``check_mapping`` follow the program frame by frame
  from its own outputs (teacher forcing): frame k's scan-to-scan solve starts
  from the program's motion of frame k-1, and frame k's refinement from the
  program's correction of frame k-1, against a map that the reference builds
  from its own features placed at the program's mapped poses. Each returns
  the gap between the program's pose of each frame and the reference's.
* ``odometry_chain`` / ``slam_chain`` run the whole chain on their own, which
  the control puts in the program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BIG = 1e30


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


@dataclass(frozen=True)
class Arith:
    dtype: torch.dtype = torch.float64
    device: str = "cpu"
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)


FLOAT64 = Arith()


def control_arith(device: str) -> Arith:
    """The control's precision: float32 with TF32 matrix products."""
    return Arith(torch.float32, device, tf32=True)


# ---------------------------------------------------------------------------
# poses: quaternions (w, x, y, z), x_parent = R x_child + t
# ---------------------------------------------------------------------------

def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_matrix(q):
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1).reshape(*q.shape[:-1], 3, 3)


def rotvec_quat(w):
    """Rotation vector → unit quaternion."""
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = th < 1e-8
    k = torch.where(small, 0.5 - th * th / 48.0, torch.sin(0.5 * th) / torch.where(small, 1.0, th))
    return torch.cat([torch.cos(0.5 * th), k * w], dim=-1)


def compose(a, b):
    """(q, t) a ∘ b."""
    qa, ta = a
    qb, tb = b
    q = quat_mul(qa, qb)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True), \
        (quat_matrix(qa) @ tb[..., None])[..., 0] + ta


def inverse(p):
    q, t = p
    qi = quat_conj(q)
    return qi, -(quat_matrix(qi) @ t[..., None])[..., 0]


def transform(ar: Arith, pose, pts):
    """R p + t for an (N, 3) cloud, as one matrix product."""
    q, t = pose
    return ar.mm(pts, quat_matrix(q).transpose(-1, -2)) + t


def rotation_angle(qa, qb):
    """Angle (rad) of qa⁻¹ qb."""
    d = quat_mul(quat_conj(qa), qb)
    return 2.0 * torch.atan2(torch.linalg.vector_norm(d[..., 1:], dim=-1), d[..., 0].abs())


def identity(ar: Arith):
    return (ar.t([1.0, 0.0, 0.0, 0.0]), ar.t([0.0, 0.0, 0.0]))


# ---------------------------------------------------------------------------
# scan registration
# ---------------------------------------------------------------------------

RANGE_Q = np.float32(131.072) / np.float32(65536.0)   # the polar2 range quantum (2 mm)


def ring_elevations_deg(n_scans: int) -> np.ndarray:
    """Nominal ring elevations (deg) of the reference's ring formulas
    (scanRegistration.cpp:168-199)."""
    i = np.arange(n_scans, dtype=np.float64)
    if n_scans == 64:
        return np.where(i < 32, 2.0 - i / 3.0, -8.83 - (i - 32) / 2.0)
    if n_scans == 32:
        return (i + 0.5) * 4.0 / 3.0 - 92.0 / 3.0
    if n_scans == 16:
        return -15.0 + 2.0 * i
    raise ValueError(f"unsupported n_scans {n_scans}")


def _ring_of(angle: np.ndarray, n_scans: int):
    """Ring id and acceptance of each vertical angle (deg, float32)."""
    f = np.float32
    if n_scans == 64:
        upper = np.floor((f(2.0) - angle) * f(3.0) + f(0.5)).astype(np.int64)
        lower = 32 + np.floor((f(-8.83) - angle) * f(2.0) + f(0.5)).astype(np.int64)
        ring = np.where(angle >= f(-8.83), upper, lower)
        ok = (angle <= f(2.0)) & (angle >= f(-24.33)) & (ring >= 0) & (ring <= 50)
    elif n_scans == 32:
        ring = np.floor((angle + f(92.0 / 3.0)) * f(3.0 / 4.0)).astype(np.int64)
        ok = (ring >= 0) & (ring <= 31)
    elif n_scans == 16:
        ring = np.floor((angle + f(15.0)) / f(2.0) + f(0.5)).astype(np.int64)
        ok = (ring >= 0) & (ring <= 15)
    else:
        raise ValueError(f"unsupported n_scans {n_scans}")
    return np.clip(ring, 0, n_scans - 1), ok


def _cells(points: np.ndarray, L: dict):
    """Float32 ring, column, range² and acceptance of raw points."""
    p = np.asarray(points, dtype=np.float32)[:, :3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    d2 = x * x + y * y
    with np.errstate(invalid="ignore"):
        angle = np.arctan2(z, np.sqrt(d2)) * np.float32(180.0 / np.pi)
    ring, ok = _ring_of(angle.astype(np.float32), L["n_scans"])
    W = L["azimuth_bins"]
    ori = -np.arctan2(y, x)
    col = np.floor((ori + np.float32(np.pi)) * np.float32(W / (2.0 * np.pi))).astype(np.int64)
    col = np.clip(col, 0, W - 1)
    r2 = d2 + z * z
    ok = ok & np.isfinite(p).all(axis=1)
    return p, ring, col, r2, ok


def _compact(grid_xyz: np.ndarray, valid: np.ndarray, ar: Arith):
    """(R, W) grid → valid cells moved to the front of each ring, in column
    order: (xyz (R, W, 3), count (R,))."""
    order = np.argsort(~valid, axis=1, kind="stable")
    xyz = np.take_along_axis(grid_xyz, order[..., None], axis=1)
    count = valid.sum(axis=1)
    xyz = np.where((np.arange(valid.shape[1])[None, :] < count[:, None])[..., None], xyz, 0.0)
    return ar.t(xyz), torch.as_tensor(count, device=ar.device)


def scan_from_polar2(points: np.ndarray, L: dict, ar: Arith):
    """The polar2 ingest: every (ring, azimuth) cell keeps its nearest
    return's range, quantised to 2 mm; the cell decodes at the ring's nominal
    elevation and the column's centre azimuth."""
    R, W = L["n_scans"], L["azimuth_bins"]
    p, ring, col, r2, ok = _cells(points, L)
    rng = np.sqrt(r2)
    ok = ok & (rng > np.float32(L["min_range"])) & (rng < np.float32(L["max_range"]))
    cell = ring * W + col
    best = np.full(R * W, np.inf, np.float32)
    np.minimum.at(best, cell[ok], rng[ok])
    hit = np.isfinite(best)
    qr = np.zeros(R * W, np.float64)
    qr[hit] = np.clip(np.rint(best[hit] / RANGE_Q), 1, 65535)
    r = qr * float(RANGE_Q)
    valid = (qr > 0) & (r > L["min_range"]) & (r < L["max_range"])
    el = np.radians(ring_elevations_deg(R))[:, None]
    ori = -np.pi + (np.arange(W) + 0.5) * (2.0 * np.pi / W)
    r = r.reshape(R, W)
    d = r * np.cos(el)
    xyz = np.stack([d * np.cos(ori)[None], -d * np.sin(ori)[None], r * np.sin(el)], axis=-1)
    return _compact(xyz, valid.reshape(R, W), ar)


def scan_from_points(points: np.ndarray, L: dict, ar: Arith):
    """The raw ingest (a sequence's first frame): every cell keeps its
    nearest return (the first of equal ranges) at its own coordinates."""
    R, W = L["n_scans"], L["azimuth_bins"]
    p, ring, col, r2, ok = _cells(points, L)
    ok = ok & (r2 > np.float32(L["min_range"] ** 2)) & (r2 < np.float32(L["max_range"] ** 2))
    cell = np.where(ok, ring * W + col, R * W)
    order = np.lexsort((np.arange(len(cell)), r2, cell))
    cs = cell[order]
    first = np.ones(len(cs), bool)
    first[1:] = cs[1:] != cs[:-1]
    win = order[first & (cs < R * W)]
    grid = np.zeros((R * W, 3), np.float64)
    valid = np.zeros(R * W, bool)
    grid[cell[win]] = p[win]
    valid[cell[win]] = True
    return _compact(grid.reshape(R, W, 3), valid.reshape(R, W), ar)


@dataclass
class Cloud:
    xyz: torch.Tensor    # (..., N, 3)
    mask: torch.Tensor   # (..., N)


def _shift(x, k, fill):
    """x[:, i + k] with ``fill`` beyond the row."""
    out = torch.full_like(x, fill)
    W = x.shape[1]
    if k > 0:
        out[:, :W - k] = x[:, k:]
    else:
        out[:, -k:] = x[:, :W + k]
    return out


def voxel_rows(xyz, mask, leaf: float, max_out: int):
    """Per-row voxel filter: the mean of each occupied leaf cell, cells in
    key order (x, y, z cell), the first ``max_out`` of each row kept."""
    n, W = mask.shape
    q = torch.clamp(torch.floor((xyz + 1024.0 * leaf) / leaf), 0, 2047).to(torch.int64)
    key = (q[..., 0] * 2048 + q[..., 1]) * 2048 + q[..., 2]
    key = torch.where(mask, key, torch.full_like(key, 1 << 40))
    ks, order = torch.sort(key, dim=1, stable=True)
    start = torch.ones_like(ks, dtype=torch.bool)
    start[:, 1:] = ks[:, 1:] != ks[:, :-1]
    ms = torch.gather(mask, 1, order)
    run = torch.cumsum((start & ms).to(torch.int64), dim=1) - 1
    run = torch.where(ms & (run < max_out), run, torch.full_like(run, max_out))
    xs = torch.gather(xyz, 1, order[..., None].expand(n, W, 3))
    acc = torch.zeros((n, max_out + 1, 4), dtype=xyz.dtype, device=xyz.device)
    acc.scatter_add_(1, run[..., None].expand(n, W, 4),
                     torch.cat([xs, torch.ones_like(xs[..., :1])], dim=-1))
    cnt = acc[:, :max_out, 3]
    return Cloud(acc[:, :max_out, :3] / torch.clamp(cnt, min=1.0)[..., None], cnt > 0)


def extract_features(xyz, count, L: dict):
    """Feature clouds of F compacted scans ((F, R, W, 3), counts (F, R)):
    curvature over ±5 neighbours on the ring; per ring span [5, count − 6]
    cut into sectors; per sector the sharpest points (curvature above the
    edge gate; the first ``max_sharp_per_sector`` sharp, all of them less
    sharp) and the flattest (below the surf gate), each pick suppressing its
    neighbours up to a gap; everything not a corner voxel-filtered per ring.
    Returns dict of ``Cloud``s, each (F, N, 3)."""
    F, R, W, _ = xyz.shape
    n = L["nms_radius"]
    p = xyz.reshape(F * R, W, 3)
    cnt = count.reshape(F * R, 1).to(torch.int64)
    idx = torch.arange(W, device=p.device)[None, :]
    valid = idx < cnt
    acc = -2.0 * n * p
    for k in list(range(-n, 0)) + list(range(1, n + 1)):
        acc = acc + _shift(p, k, 0.0)
    curv = torch.sum(acc * acc, dim=-1)
    eligible = (idx >= n) & (idx <= cnt - n - 1) & (cnt >= 3 * n + 2) & valid

    nxt = _shift(p, 1, 0.0)
    gap_ok = (torch.sum((nxt - p) ** 2, dim=-1) <= L["nms_gap_sq"]) & valid & _shift(valid, 1, False)
    reach_r = torch.zeros_like(cnt.expand(-1, W))
    reach_l = torch.zeros_like(reach_r)
    run_r = torch.ones_like(gap_ok)
    run_l = torch.ones_like(gap_ok)
    for k in range(n):
        run_r = run_r & _shift(gap_ok, k, False)
        run_l = run_l & _shift(gap_ok, -1 - k, False)
        reach_r = reach_r + run_r
        reach_l = reach_l + run_l

    S = L["n_sectors"]
    span = torch.clamp(cnt - 2 * n - 1, min=0)
    avail = eligible.clone()
    label = torch.zeros_like(eligible)
    corner_picks, flat_picks = [], []

    def take(score, pick, ok):
        nonlocal avail
        p_ = pick[:, None]
        lo = p_ - torch.gather(reach_l, 1, p_)
        hi = p_ + torch.gather(reach_r, 1, p_)
        hit = (idx >= lo) & (idx <= hi)
        avail = avail & ~(hit & ok[:, None])

    for j in range(S):
        sp = n + torch.div(span * j, S, rounding_mode="floor")
        ep = n + torch.div(span * (j + 1), S, rounding_mode="floor") - 1
        sector = (idx >= sp) & (idx <= ep)
        picks = []
        for _ in range(L["max_less_sharp_per_sector"]):
            score = torch.where(avail & sector, curv, torch.full_like(curv, -BIG))
            pick = torch.argmax(score, dim=1)
            ok = torch.gather(score, 1, pick[:, None])[:, 0] > L["curvature_edge_min"]
            take(score, pick, ok)
            picks.append((pick, ok))
        for pick, ok in picks:
            label.scatter_(1, pick[:, None], (torch.gather(label, 1, pick[:, None])[:, 0] | ok)[:, None])
        corner_picks.append(picks)
        fpicks = []
        for _ in range(L["max_flat_per_sector"]):
            score = torch.where(avail & sector, curv, torch.full_like(curv, BIG))
            pick = torch.argmin(score, dim=1)
            ok = torch.gather(score, 1, pick[:, None])[:, 0] < L["curvature_surf_max"]
            take(score, pick, ok)
            fpicks.append((pick, ok))
        flat_picks.append(fpicks)

    def cloud(pick_lists):
        pk = torch.stack([pk for picks in pick_lists for pk, _ in picks], dim=1)
        ok = torch.stack([ok for picks in pick_lists for _, ok in picks], dim=1)
        pts = torch.gather(p, 1, pk[..., None].expand(*pk.shape, 3))
        return Cloud(pts.reshape(F, -1, 3), ok.reshape(F, -1))

    ns = L["max_sharp_per_sector"]
    sharp = cloud([picks[:ns] for picks in corner_picks])
    less_sharp = cloud(corner_picks)
    flat = cloud(flat_picks)
    lf = voxel_rows(p, valid & ~label, L["surf_leaf_size"], L["max_less_flat"] // R)
    less_flat = Cloud(lf.xyz.reshape(F, -1, 3), lf.mask.reshape(F, -1))
    return {"sharp": sharp, "less_sharp": less_sharp, "flat": flat, "less_flat": less_flat}


def sequence_features(scans, L: dict, ar: Arith, frames=None, batch: int = 16):
    """Features of the frames of a sequence listed in ``frames`` (default
    all): frame 0 from its raw points, the others through the polar2 ingest.
    Returns a list with a dict of ``Cloud``s for each listed frame, None for
    the others."""
    want = sorted(set(range(len(scans)) if frames is None else frames))
    out = [None] * len(scans)
    for b in range(0, len(want), batch):
        ks = want[b:b + batch]
        part = [scan_from_points(scans[k], L, ar) if k == 0 else scan_from_polar2(scans[k], L, ar)
                for k in ks]
        f = extract_features(torch.stack([x for x, _ in part]), torch.stack([c for _, c in part]), L)
        for i, k in enumerate(ks):
            out[k] = {name: Cloud(v.xyz[i], v.mask[i]) for name, v in f.items()}
    return out


# ---------------------------------------------------------------------------
# nearest neighbours
# ---------------------------------------------------------------------------

def sqdist(ar: Arith, q, c):
    """(Q, C) squared distances as |q|² + |c|² − 2 q·c."""
    return (torch.sum(q * q, dim=-1)[:, None] + torch.sum(c * c, dim=-1)[None, :]
            - 2.0 * ar.mm(q, c.T))


def associate(ar: Arith, q, cand: Cloud, n_rings: int, nearby: float, block: int = 2048):
    """Per query: the nearest candidate (ring r0), r0's second nearest, and
    the nearest on a ring rw with 0 < |rw − r0| ≤ ``nearby``; their squared
    distances. Candidates are ring-major blocks."""
    R = n_rings
    B = cand.xyz.shape[0] // R
    outs = []
    for s in range(0, q.shape[0], block):
        d = sqdist(ar, q[s:s + block], cand.xyz)
        d = torch.where(cand.mask[None, :], d, torch.full_like(d, BIG)).reshape(-1, R, B)
        d2, i2 = torch.topk(d, 2, dim=2, largest=False)
        d1 = d2[..., 0]
        r0 = torch.argmin(d1, dim=1)
        rows = torch.arange(R, device=q.device)[None, :]
        dr = (rows - r0[:, None]).abs()
        win = (dr > 0) & (dr <= nearby)
        dwin = torch.where(win, d1, torch.full_like(d1, BIG))
        rw = torch.argmin(dwin, dim=1)
        ar_ = torch.arange(d.shape[0], device=q.device)
        flat = cand.xyz.reshape(R, B, 3)
        outs.append((flat[r0, i2[ar_, r0, 0]], flat[r0, i2[ar_, r0, 1]], flat[rw, i2[ar_, rw, 0]],
                     d1[ar_, r0], d2[ar_, r0, 1], dwin[ar_, rw]))
    return [torch.cat(x) for x in zip(*outs)]


def knn(ar: Arith, q, cand: Cloud, k: int, block: int = 4096):
    """The k nearest candidates of each query: (squared distances (Q, k),
    coordinates (Q, k, 3)), BIG where there is no candidate."""
    ds, ns = [], []
    for s in range(0, q.shape[0], block):
        d = sqdist(ar, q[s:s + block], cand.xyz)
        d = torch.where(cand.mask[None, :], d, torch.full_like(d, BIG))
        dk, ik = torch.topk(d, k, dim=1, largest=False)
        ds.append(dk)
        ns.append(cand.xyz[ik])
    return torch.cat(ds), torch.cat(ns)


# ---------------------------------------------------------------------------
# Gauss-Newton
# ---------------------------------------------------------------------------

def _huber(r_abs, delta):
    return torch.where(r_abs <= delta, torch.ones_like(r_abs), delta / torch.clamp(r_abs, min=1e-12))


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1).reshape(*v.shape[:-1], 3, 3)


def _edge_rows(ar: Arith, pose, p, a, b, mask, delta):
    """Point-to-line rows: r = (y−a)×(y−b)/|a−b| (3 a point), J = [b−a]×/|a−b|
    · [I | −[R p]×], Huber weights on |r|."""
    y = transform(ar, pose, p)
    ab = a - b
    nab = torch.clamp(torch.linalg.vector_norm(ab, dim=-1, keepdim=True), min=1e-9)
    r = torch.linalg.cross(y - a, y - b) / nab
    Rp = y - pose[1]
    dy = torch.cat([torch.eye(3, dtype=y.dtype, device=y.device).expand(len(y), 3, 3),
                    -_hat(Rp)], dim=-1)
    J = (_hat(-ab) / nab[..., None]) @ dy
    w = _huber(torch.linalg.vector_norm(r, dim=-1), delta) * mask
    return r.reshape(-1), J.reshape(-1, 6), w.repeat_interleave(3)


def _plane_rows(ar: Arith, pose, p, n, d, mask, delta):
    """Point-to-plane rows: r = n·y + d, J = [n | (R p)×n]."""
    y = transform(ar, pose, p)
    r = torch.sum(y * n, dim=-1) + d
    J = torch.cat([n, torch.linalg.cross(y - pose[1], n)], dim=-1)
    return r, J, _huber(r.abs(), delta) * mask


def gn_step(ar: Arith, pose, rows):
    """One damped Gauss-Newton step over the stacked rows (r, J, w):
    (JᵀWJ + 1e-4·diag) δ = −JᵀWr, then q ← exp(δθ) q, t ← t + δt."""
    r = torch.cat([x[0] for x in rows])
    J = torch.cat([x[1] for x in rows])
    w = torch.cat([x[2] for x in rows]).to(J.dtype)
    Jw = (J * w[:, None]).T
    H = ar.mm(Jw, J)
    g = ar.mm(Jw, r[:, None])[:, 0]
    H = H + torch.diag(1e-4 * torch.clamp(torch.diagonal(H), min=1e-6))
    delta = -torch.linalg.solve(H, g)
    if not bool(torch.isfinite(delta).all()):
        return pose
    q = quat_mul(rotvec_quat(delta[3:]), pose[0])
    return q / torch.linalg.vector_norm(q), pose[1] + delta[:3]


def _rounds(pose, outer_once, iters: int, tol: float):
    """The adaptive re-association loop: at least two rounds, then stop once a
    round moved the pose by no more than ``tol`` (m, ~rad)."""
    prev = pose
    for i in range(iters):
        if i >= 2 and tol > 0:
            s = torch.sign(torch.sum(pose[0] * prev[0]))
            dq = torch.max(torch.abs(pose[0] - prev[0] * s))
            dt = torch.max(torch.abs(pose[1] - prev[1]))
            if not bool((2.0 * dq > tol) | (dt > tol)):
                break
        prev = pose
        pose = outer_once(pose)
    return pose


def scan_to_scan(ar: Arith, curr: dict, prev: dict, init, O: dict):
    """T_last_curr from ``init``: rounds of association (sharp points to
    lines of the last less-sharp cloud, flat points to planes of the last
    less-flat cloud) and ``gn_iters`` Gauss-Newton iterations."""
    sharp, flat = curr["sharp"], curr["flat"]
    R, near, gate = O["n_rings"], O["nearby_scan"], O["dist_sq_threshold"]

    def outer_once(pose):
        a, _, b, d0, _, dw = associate(ar, transform(ar, pose, sharp.xyz), prev["less_sharp"], R, near)
        e_ok = sharp.mask & (d0 < gate) & (dw < gate)
        j, l, m, p0, p2, p3 = associate(ar, transform(ar, pose, flat.xyz), prev["less_flat"], R, near)
        p_ok = flat.mask & (p0 < gate) & (p2 < gate) & (p3 < gate)
        nrm = torch.linalg.cross(j - l, j - m)
        nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-9)
        dpl = -torch.sum(j * nrm, dim=-1)
        for _ in range(O["gn_iters"]):
            pose = gn_step(ar, pose, [
                _plane_rows(ar, pose, flat.xyz, nrm, dpl, p_ok, O["huber_delta"]),
                _edge_rows(ar, pose, sharp.xyz, a, b, e_ok, O["huber_delta"])])
        return pose

    return _rounds(init, outer_once, O["outer_iters"], O["outer_tol"])


# ---------------------------------------------------------------------------
# mapping
# ---------------------------------------------------------------------------

def voxel_hash(q):
    m = 0xFFFFFFFF
    return (((q[..., 0] * 73856093) & m) ^ ((q[..., 1] * 19349663) & m)
            ^ ((q[..., 2] * 83492791) & m)) & 0x7FFFFFFF


def _lexsort(*keys):
    """Stable lexicographic order, most significant key first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order


def voxel_filter(cloud: Cloud, leaf: float, max_out: int) -> Cloud:
    """Mean of each occupied leaf cell, cells ordered by their spatial hash,
    the first ``max_out`` kept."""
    q = torch.clamp(torch.floor((cloud.xyz + 1024.0 * leaf) / leaf), 0, 2047).to(torch.int64)
    cellk = (q[:, 0] * 2048 + q[:, 1]) * 2048 + q[:, 2]
    h = torch.where(cloud.mask, voxel_hash(q), torch.full_like(cellk, 1 << 40))
    cellk = torch.where(cloud.mask, cellk, torch.full_like(cellk, 1 << 40))
    order = _lexsort(h, cellk)
    cs, ms = cellk[order], cloud.mask[order]
    start = torch.ones_like(ms)
    start[1:] = cs[1:] != cs[:-1]
    run = torch.cumsum((start & ms).to(torch.int64), 0) - 1
    run = torch.where(ms & (run < max_out), run, torch.full_like(run, max_out))
    acc = torch.zeros((max_out + 1, 4), dtype=cloud.xyz.dtype, device=cloud.xyz.device)
    xs = cloud.xyz[order]
    acc.index_add_(0, run, torch.cat([xs, torch.ones_like(xs[:, :1])], dim=1))
    cnt = acc[:max_out, 3]
    return Cloud(acc[:max_out, :3] / torch.clamp(cnt, min=1.0)[:, None], cnt > 0)


def voxel_merge(map_c: Cloud, new: Cloud, center, leaf: float, cap: int, drop: float,
                quantum: int = 64) -> Cloud:
    """Insert world points into a bounded map: points beyond ``drop`` of the
    pose dropped; one point per leaf cell (the map's before a new one's);
    cells ordered by 16 m² distance buckets from the pose, then spatial hash;
    the first ``cap`` kept, so the farthest go first."""
    pts = torch.cat([map_c.xyz, new.xyz])
    mask = torch.cat([map_c.mask, new.mask])
    src = torch.cat([torch.zeros(len(map_c.mask), dtype=torch.int64, device=pts.device),
                     torch.ones(len(new.mask), dtype=torch.int64, device=pts.device)])
    d2 = torch.sum((pts - center) ** 2, dim=-1)
    mask = mask & (d2 < drop * drop)
    oq = quantum * leaf
    origin = (torch.floor(center / oq) - 1024 // quantum) * oq
    q = torch.clamp(torch.floor((pts - origin) / leaf), 0, 2047).to(torch.int64)
    cellk = (q[:, 0] * 2048 + q[:, 1]) * 4096 + q[:, 2]
    db = torch.clamp(d2 / 256.0, max=127.0).to(torch.int64)
    high = torch.where(mask, db * (1 << 31) + voxel_hash(q), torch.full_like(db, 1 << 38))
    cellk = torch.where(mask, cellk, torch.full_like(cellk, 1 << 40))
    order = _lexsort(high, cellk, src)
    cs, ms = cellk[order], mask[order]
    start = torch.ones_like(ms)
    start[1:] = cs[1:] != cs[:-1]
    start = start & ms
    keep = torch.sort((~start).to(torch.int8), stable=True).indices[:cap]
    return Cloud(pts[order][keep], start[keep])


def empty_map(M: dict, ar: Arith):
    def cloud(n):
        return Cloud(torch.zeros((n, 3), dtype=ar.dtype, device=ar.device),
                     torch.zeros(n, dtype=torch.bool, device=ar.device))
    return {"corner": cloud(M["map_corner_cap"]), "surf": cloud(M["map_surf_cap"])}


def line_fit(ar: Arith, nbrs, ok_nbr, ratio: float):
    """PCA line of 5 neighbours: centroid, dominant direction, and whether all
    are valid and λmax > ratio · λmid."""
    c = nbrs.mean(dim=1)
    d = nbrs - c[:, None]
    cov = ar.mm(d.transpose(1, 2), d) / nbrs.shape[1]
    lam, vec = torch.linalg.eigh(cov)
    ok = ok_nbr.all(dim=1) & (lam[:, 2] > ratio * torch.clamp(lam[:, 1], min=0.0))
    return c, vec[:, :, 2], ok


def plane_fit(ar: Arith, nbrs, ok_nbr, tol: float):
    """Plane n·p + d = 0 through 5 neighbours by least squares on A m = −1:
    unit normal, offset, and whether all are valid and within ``tol``."""
    AtA = ar.mm(nbrs.transpose(1, 2), nbrs)
    Atb = -nbrs.sum(dim=1)
    det = torch.linalg.det(AtA)
    safe = det.abs() > 1e-12
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    m = torch.linalg.solve(torch.where(safe[:, None, None], AtA, eye), Atb)
    m = torch.where(safe[:, None], m, torch.zeros_like(m))
    nm = torch.linalg.vector_norm(m, dim=-1)
    n = m / torch.clamp(nm, min=1e-12)[:, None]
    d = 1.0 / torch.clamp(nm, min=1e-12)
    resid = torch.abs(torch.sum(nbrs * n[:, None], dim=-1) + d[:, None])
    ok = ok_nbr.all(dim=1) & (nm > 1e-12) & (resid <= tol).all(dim=1)
    return n, d, ok


def solve_map_pose(ar: Arith, corner: Cloud, surf: Cloud, mp: dict, init, M: dict):
    """World pose of a frame against the map: rounds of 5-NN association,
    line and plane fits, ``gn_iters`` Gauss-Newton iterations."""
    k = M["knn"]

    def outer_once(pose):
        cd, cn = knn(ar, transform(ar, pose, corner.xyz), mp["corner"], k)
        c, u, lok = line_fit(ar, cn, cd < M["corner_nn_max_dist"] ** 2, M["line_eig_ratio"])
        e_ok = corner.mask & lok
        sd, sn = knn(ar, transform(ar, pose, surf.xyz), mp["surf"], k)
        n, d, pok = plane_fit(ar, sn, sd < 1.0, M["plane_fit_tol"])
        p_ok = surf.mask & pok
        for _ in range(M["gn_iters"]):
            pose = gn_step(ar, pose, [
                _edge_rows(ar, pose, corner.xyz, c + 0.1 * u, c - 0.1 * u, e_ok, M["huber_delta"]),
                _plane_rows(ar, pose, surf.xyz, n, d, p_ok, M["huber_delta"])])
        return pose

    return _rounds(init, outer_once, M["outer_iters"], M["outer_tol"])


def map_inputs(feats: dict, M: dict):
    """A frame's mapping inputs: its less-sharp and less-flat clouds
    voxel-filtered at the mapping leaves (lidar frame)."""
    return (voxel_filter(feats["less_sharp"], M["corner_leaf"], M["corner_slot"]),
            voxel_filter(feats["less_flat"], M["surf_leaf"], M["surf_slot"]))


def map_insert(ar: Arith, mp: dict, corner: Cloud, surf: Cloud, pose, M: dict):
    return {
        "corner": voxel_merge(mp["corner"], Cloud(transform(ar, pose, corner.xyz), corner.mask),
                              pose[1], M["corner_leaf"], M["map_corner_cap"], M["map_drop_radius"]),
        "surf": voxel_merge(mp["surf"], Cloud(transform(ar, pose, surf.xyz), surf.mask),
                            pose[1], M["surf_leaf"], M["map_surf_cap"], M["map_drop_radius"]),
    }


# ---------------------------------------------------------------------------
# chains (the control) and checks (teacher forcing)
# ---------------------------------------------------------------------------

def odometry_chain(ar: Arith, feats: list, O: dict):
    """World poses of every frame, the first at the identity: (q (N, 4),
    t (N, 3))."""
    pose_w = rel = identity(ar)
    qs, ts = [pose_w[0]], [pose_w[1]]
    for k in range(1, len(feats)):
        rel = scan_to_scan(ar, feats[k], feats[k - 1], rel, O)
        pose_w = compose(pose_w, rel)
        qs.append(pose_w[0])
        ts.append(pose_w[1])
    return torch.stack(qs), torch.stack(ts)


def slam_chain(ar: Arith, feats: list, O: dict, M: dict):
    """Odometry and mapped world poses of every frame; frames from the
    second on are refined against the map and merged into it."""
    oq, ot = odometry_chain(ar, feats, O)
    mp = empty_map(M, ar)
    corr = identity(ar)
    qs, ts = [oq[0]], [ot[0]]
    for k in range(1, len(feats)):
        corner, surf = map_inputs(feats[k], M)
        odom = (oq[k], ot[k])
        refined = solve_map_pose(ar, corner, surf, mp, compose(corr, odom), M)
        mp = map_insert(ar, mp, corner, surf, refined, M)
        corr = compose(refined, inverse(odom))
        qs.append(refined[0])
        ts.append(refined[1])
    return (oq, ot), (torch.stack(qs), torch.stack(ts))


def _gap(ref, q, t):
    """(translation gap m, rotation gap rad) of the program's pose (q, t)
    from the reference's."""
    return (float(torch.linalg.vector_norm(ref[1] - t)), float(rotation_angle(ref[0], q)))


def check_odometry(ar: Arith, feats: list, odom_q, odom_t, O: dict, frames):
    """Per frame k in ``frames`` (each ≥ 1): the program's motion
    T_{k−1}⁻¹ T_k against the reference's scan-to-scan solve of frame k from
    the program's motion of frame k−1 (the identity for frame 1). ``feats``
    needs frames k − 1 and k. Returns {k: (dt, dr)}."""
    poses = [(ar.t(q), ar.t(t)) for q, t in zip(odom_q, odom_t)]

    def motion(k):
        return compose(inverse(poses[k - 1]), poses[k]) if k >= 1 else identity(ar)

    return {k: _gap(scan_to_scan(ar, feats[k], feats[k - 1],
                                 motion(k - 1) if k > 1 else identity(ar), O), *motion(k))
            for k in frames}


def odometry_frames_needed(frames) -> list:
    return sorted({j for k in frames for j in (k - 1, k)})


def check_mapping(ar: Arith, feats: list, odom_q, odom_t, map_q, map_t, M: dict, frames):
    """Per frame k in ``frames`` (each ≥ 1): the program's mapped pose
    against the reference's refinement from the program's correction of
    frame k−1 composed with its odometry pose of frame k, against a map the
    reference built from its own features placed at the program's mapped
    poses of frames 1..k−1. ``feats`` needs frames 1..max(frames). Returns
    {k: (dt, dr)}."""
    odo = [(ar.t(q), ar.t(t)) for q, t in zip(odom_q, odom_t)]
    mapped = [(ar.t(q), ar.t(t)) for q, t in zip(map_q, map_t)]
    want = set(frames)
    mp = empty_map(M, ar)
    gaps = {}
    for k in range(1, max(want) + 1):
        corner, surf = map_inputs(feats[k], M)
        if k in want:
            corr = compose(mapped[k - 1], inverse(odo[k - 1])) if k > 1 else identity(ar)
            ref = solve_map_pose(ar, corner, surf, mp, compose(corr, odo[k]), M)
            gaps[k] = _gap(ref, *mapped[k])
        mp = map_insert(ar, mp, corner, surf, mapped[k], M)
    return gaps

