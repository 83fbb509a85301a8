"""The benchmark's one traffic generator: a street grid of box buildings,
one route per stream, and HDL-64 scans raycast along it on the device.

A traffic file (``benchmark/traffic/<name>.json``) holds only parameters:

* ``streams``, ``frames_per_sequence``;
* ``sensor``: ``azimuth_steps`` (rays a ring a turn), ``max_range``,
  ``min_hit``, ``noise_m`` (range noise σ), ``height_m``;
* ``scene``: ``block_m``, ``setback_m``, ``gap_m``, ``building_m``,
  ``depth_m``, ``height_m`` (each a [low, high] range), ``poles_per_100m``,
  ``pole_offset_m``, ``margin_m``;
* ``route``: ``speed_m_per_frame``, ``first_leg_frames``, ``turn_frames``
  ([low, high] ranges), ``turns`` (how many 90° turns a sequence makes).

Every stream's scene and route come from ``(seed, stream)``, so the same seed
gives the same scans. Every seed gives each stream the same structure (the
same number of frames, legs and turns); only the sizes within the ranges
and the directions of the turns change.

The scene is the synthetic corridor's (``data/synthetic.py`` of the program:
axis-aligned boxes and the ground plane z = 0, rays at the HDL-64 ring
elevations, azimuth-major, misses dropped) laid out as a grid of streets.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def hdl64_elevations_deg() -> np.ndarray:
    """Ring elevations (deg): rings 0-31 from 2° down by 1/3°, rings 32-63
    from -8.83° down by 1/2°."""
    return np.concatenate([2.0 - np.arange(32) / 3.0, -8.83 - np.arange(32) / 2.0])


def stream_rng(seed: int, stream: int, salt: str = "") -> np.random.Generator:
    """A generator drawn from (seed, stream, salt): any whole seed."""
    digest = hashlib.sha256(f"{int(seed)}:{int(stream)}:{salt}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def torch_seed(seed: int, stream: int, frame: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{int(stream)}:noise:{int(frame)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _u(rng, lo_hi) -> float:
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def _ui(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def route(rng, spec: dict, n_frames: int):
    """Sensor poses of one sequence: straight legs joined by 90° turns, each
    turn an arc over ``turn_frames`` frames. Returns (yaw (N,), xy (N, 2),
    corners (list of (x, y) where two legs' centrelines meet), headings (list
    of leg headings))."""
    r = spec["route"]
    v = _u(rng, r["speed_m_per_frame"])
    segs = []                                     # (kind, frames, sign)
    first = _ui(rng, r["first_leg_frames"])
    segs.append(("leg", first, 0))
    used = first
    for _ in range(r["turns"]):
        t = _ui(rng, r["turn_frames"])
        segs.append(("turn", t, 1 if rng.random() < 0.5 else -1))
        used += t
        gap = max(n_frames - used, 0) // max(r["turns"], 1)
        segs.append(("leg", gap, 0))
        used += gap
    segs.append(("leg", max(n_frames - used, 0) + 1, 0))

    yaw, xy = [], []
    psi, pos = 0.0, np.zeros(2)
    corners, headings = [], [0.0]
    for kind, frames, sign in segs:
        if kind == "leg":
            d = np.array([math.cos(psi), math.sin(psi)])
            for i in range(frames):
                yaw.append(psi)
                xy.append(pos + v * i * d)
            pos = pos + v * frames * d
        else:
            rad = v * frames / (math.pi / 2)
            d = np.array([math.cos(psi), math.sin(psi)])
            nrm = sign * np.array([-math.sin(psi), math.cos(psi)])
            centre = pos + rad * nrm
            corners.append(tuple(pos + rad * d))
            for i in range(frames):
                a = (math.pi / 2) * i / frames
                yaw.append(psi + sign * a)
                xy.append(centre - rad * nrm * math.cos(a) + rad * d * math.sin(a))
            psi = psi + sign * math.pi / 2
            pos = centre - rad * nrm * math.cos(math.pi / 2) + rad * d * math.sin(math.pi / 2)
            headings.append(psi)
    return np.asarray(yaw[:n_frames]), np.asarray(xy[:n_frames]), corners, headings


def poses(yaw: np.ndarray, xy: np.ndarray, height: float):
    """(R (N, 3, 3), t (N, 3)) sensor → world."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((len(yaw), 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
    t = np.concatenate([xy, np.full((len(yaw), 1), height)], axis=1)
    return R, t


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _street_lines(rng, through: list, lo: float, hi: float, block) -> list:
    """Street centrelines along one axis: every coordinate in ``through``
    (the route's streets) and more at block spacings out to [lo, hi]."""
    lines = sorted(set(round(x, 6) for x in through))
    x = lines[0]
    while x > lo:
        x -= _u(rng, block)
        lines.append(x)
    x = max(lines)
    while x < hi:
        x += _u(rng, block)
        lines.append(x)
    out = sorted(lines)
    # streets closer than a block's low end merge into one (the route's own
    # streets stay)
    keep = [out[0]]
    for x in out[1:]:
        if x - keep[-1] >= block[0] or any(abs(x - t) < 1e-6 for t in through):
            keep.append(x)
    return keep


def _side(rng, s: dict, a0: float, a1: float, street: float, inward: float, along_x: bool,
          boxes: list):
    """Buildings along one side of a block: facades ``setback`` from the
    street centreline, running from a0 to a1."""
    a = a0
    while a < a1:
        length = min(_u(rng, s["building_m"]), a1 - a)
        if length >= 2.0:
            off = _u(rng, s["setback_m"])
            depth = _u(rng, s["depth_m"])
            h = _u(rng, s["height_m"])
            b0, b1 = street + inward * off, street + inward * (off + depth)
            lo_b, hi_b = min(b0, b1), max(b0, b1)
            if along_x:
                boxes.append([[a, lo_b, 0.0], [a + length, hi_b, h]])
            else:
                boxes.append([[lo_b, a, 0.0], [hi_b, a + length, h]])
        a += length + _u(rng, s["gap_m"])


def street_scene(rng, spec: dict, xy: np.ndarray, corners: list, headings: list) -> np.ndarray:
    """Box buildings on a grid of axis-aligned streets through the route
    (whose legs run along x or y): (B, 2, 3) [min corner, max corner]."""
    s = spec["scene"]
    m = s["margin_m"]
    xs_route = [c[0] for c in corners]
    ys_route = [0.0] + [c[1] for c in corners]
    for h, c in zip(headings[1:], corners):
        if abs(math.sin(h)) < 0.5:
            ys_route.append(c[1])
        else:
            xs_route.append(c[0])
    if not xs_route:
        xs_route = [float(xy[-1, 0]) + _u(rng, s["block_m"]) / 2]
    lo = xy.min(axis=0) - m
    hi = xy.max(axis=0) + m
    xl = _street_lines(rng, xs_route, lo[0], hi[0], s["block_m"])
    yl = _street_lines(rng, ys_route, lo[1], hi[1], s["block_m"])
    boxes = []
    e = s["setback_m"][1]      # buildings keep clear of the cross streets
    for x0, x1 in zip(xl[:-1], xl[1:]):
        for y0, y1 in zip(yl[:-1], yl[1:]):
            _side(rng, s, x0 + e, x1 - e, y0, +1.0, True, boxes)    # south side, facing y0
            _side(rng, s, x0 + e, x1 - e, y1, -1.0, True, boxes)    # north side, facing y1
            _side(rng, s, y0 + e, y1 - e, x0, +1.0, False, boxes)   # west side, facing x0
            _side(rng, s, y0 + e, y1 - e, x1, -1.0, False, boxes)   # east side, facing x1
    # poles along every street, near the kerb, none inside an intersection
    for along_x, lines, cross in ((True, yl, xl), (False, xl, yl)):
        span = (cross[0], cross[-1])
        for c in lines:
            n = int(s["poles_per_100m"] * (span[1] - span[0]) / 100.0)
            for _ in range(n):
                a = _u(rng, span)
                off = _u(rng, s["pole_offset_m"]) * (1 if rng.random() < 0.5 else -1)
                h = _u(rng, [2.0, 5.0])
                if min(abs(a - x) for x in cross) < e:
                    continue
                p = (a, c + off) if along_x else (c + off, a)
                boxes.append([[p[0], p[1], 0.0], [p[0] + 0.25, p[1] + 0.25, h]])
    return np.asarray(boxes, dtype=np.float64)


def sequence(spec: dict, seed: int, stream: int):
    """One stream's scene and sensor poses: (boxes (B, 2, 3), R (N, 3, 3),
    t (N, 3)), all float64."""
    rng = stream_rng(seed, stream)
    n = spec["frames_per_sequence"]
    yaw, xy, corners, headings = route(rng, spec, n)
    boxes = street_scene(rng, spec, xy, corners, headings)
    R, t = poses(yaw, xy, spec["sensor"]["height_m"])
    return boxes, R, t


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def ray_dirs(n_azimuth: int, device, dtype=torch.float64) -> torch.Tensor:
    """(n_azimuth · 64, 3) unit rays in the sensor frame, azimuth-major:
    azimuth −π + (j + ½)·2π/n, x = cos e cos a, y = −cos e sin a."""
    elev = torch.deg2rad(torch.as_tensor(hdl64_elevations_deg(), dtype=dtype, device=device))
    az = -math.pi + (torch.arange(n_azimuth, dtype=dtype, device=device) + 0.5) \
        * (2.0 * math.pi / n_azimuth)
    ce, se = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(az), torch.sin(az)
    return torch.stack([torch.outer(ca, ce), torch.outer(-sa, ce),
                        se.expand(n_azimuth, -1)], dim=-1).reshape(-1, 3)


def ray_hits(origin: torch.Tensor, dirs: torch.Tensor, boxes: torch.Tensor,
             ground_z: float = 0.0, box_chunk: int = 48) -> torch.Tensor:
    """Nearest positive hit distance of each ray against the boxes (slab
    method) and the ground plane; +inf for a miss."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    best = torch.full(dirs.shape[:1], math.inf, dtype=dirs.dtype, device=dirs.device)
    for b in range(0, boxes.shape[0], box_chunk):
        bx = boxes[b:b + box_chunk]
        t0 = (bx[:, 0][:, None, :] - origin) * inv[None]
        t1 = (bx[:, 1][:, None, :] - origin) * inv[None]
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = torch.where(hit, torch.where(tmin > 0, tmin, torch.full_like(tmin, math.inf)),
                        torch.full_like(tmin, math.inf))
        best = torch.minimum(best, t.amin(dim=0))
    dz = dirs[:, 2]
    down = dz < -1e-9
    t_gnd = torch.where(down, (ground_z - origin[2]) / torch.where(down, dz, -torch.ones_like(dz)),
                        torch.full_like(dz, math.inf))
    return torch.minimum(best, t_gnd)


def render(spec: dict, boxes: np.ndarray, R: np.ndarray, t: np.ndarray, seed: int, stream: int,
           device) -> list:
    """Every frame's scan as a host float32 (n, 3) array in the sensor
    frame: hits within (min_hit, max_range), range noise added along x, y,
    z in the world frame, misses dropped."""
    sn = spec["sensor"]
    dev = torch.device(device)
    dirs_s = ray_dirs(sn["azimuth_steps"], dev)
    bx = torch.as_tensor(boxes, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev)
    out = []
    for k in range(len(t)):
        Rk = torch.as_tensor(R[k], dtype=torch.float64, device=dev)
        tk = torch.as_tensor(t[k], dtype=torch.float64, device=dev)
        dirs_w = dirs_s @ Rk.T
        near = torch.linalg.vector_norm(
            (bx[:, 0] + bx[:, 1]) / 2 - tk, dim=-1) < sn["max_range"] + 0.5 * torch.linalg.vector_norm(
                bx[:, 1] - bx[:, 0], dim=-1)
        th = ray_hits(tk, dirs_w, bx[near])
        hit = torch.isfinite(th) & (th < sn["max_range"]) & (th > sn["min_hit"])
        pts_w = tk + dirs_w[hit] * th[hit, None]
        if sn["noise_m"] > 0:
            gen.manual_seed(torch_seed(seed, stream, k))
            pts_w = pts_w + sn["noise_m"] * torch.randn(pts_w.shape, generator=gen,
                                                        dtype=pts_w.dtype, device=dev)
        out.append(((pts_w - tk) @ Rk).to(torch.float32).cpu().numpy())
    return out
