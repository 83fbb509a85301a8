"""Point-cloud layouts and filters, ported from
``lidar_visual_odometry_tpu/ops/pointcloud.py``.

Clouds are fixed-capacity tensors with validity masks, as in the reference:

* raw padded batch ``PointBatch``: (N, 3) xyz + (N,) mask;
* dense range image ``RangeImage``: the (rings, W) grid in azimuth order
  (``build_range_image``), which ``compact_rings`` compacts; the pipelines
  build the compacted grid in one pass (``build_compact_scan``);
* compacted rings ``CompactScan``: valid returns shifted to the front of each
  (ring, azimuth) row in scan order, so the ±5-neighbour curvature stencil sees
  consecutive returns (``scanRegistration.cpp:246-266``).

Multi-key stable sorts of the reference (``lax.sort`` with ``num_keys``) become
one stable ``torch.sort`` of an exact int64 key that packs the keys, followed by
gathers of the carried operands; ties keep input order, as ``is_stable=True``.
Keys wider than 63 bits sort in two stable passes, low keys first.

The host-side polar packer (``pack_polar_scan``, ``pack_polar_chunk``) is
numpy; the device decode (``polar_to_compact``) lands directly on the compacted
grid.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.segsum import segment_sum, segment_sum_batched


class PointBatch(NamedTuple):
    """Fixed-size padded point set (batched: (R, N, 3) + (R, N))."""

    xyz: torch.Tensor
    mask: torch.Tensor


class RangeImage(NamedTuple):
    """Dense (rings, W) scan grid in azimuth scan order."""

    xyz: torch.Tensor       # (R, W, 3)
    valid: torch.Tensor     # (R, W) bool
    rel_time: torch.Tensor  # (R, W) float32, fraction of the scan period


class CompactScan(NamedTuple):
    """Per-ring front-compacted points (scan order preserved)."""

    xyz: torch.Tensor       # (R, W, 3)
    valid: torch.Tensor     # (R, W) bool; valid[r, :count[r]] all True
    rel_time: torch.Tensor  # (R, W)
    count: torch.Tensor     # (R,) int32


def ring_index_hdl(xyz: torch.Tensor, n_scans: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Vertical angle → ring id (``scanRegistration.cpp:168-199``) for 16 / 32 /
    64-beam Velodynes. Returns (ring int32, in_fov bool)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    angle = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    if n_scans == 16:
        ring = torch.floor((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (ring >= 0) & (ring <= n_scans - 1)
    elif n_scans == 32:
        ring = torch.floor((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
        ok = (ring >= 0) & (ring <= n_scans - 1)
    elif n_scans == 64:
        upper = torch.floor((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        lower = n_scans // 2 + torch.floor((-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        ring = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 50)
    else:
        raise ValueError(f"unsupported n_scans={n_scans}")
    return ring, ok


def _recip32(c: float) -> float:
    """float32 reciprocal of a constant divisor.

    The reference's compiler (XLA) rewrites ``x / c`` for a constant ``c`` as
    ``x * (1 / c)``; cell and voxel indices are floors of such quotients, so
    the port multiplies by the same float32 reciprocal to land points in the
    same cells."""
    return float(np.float32(1.0) / np.float32(c))


def _float_order_bits(x: torch.Tensor) -> torch.Tensor:
    """Non-negative float32 → int64 with the same order (IEEE bit pattern)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def build_compact_scan(
    points: torch.Tensor,
    mask: torch.Tensor,
    *,
    n_scans: int,
    width: int,
    min_range: float,
    max_range: float = 1e9,
) -> CompactScan:
    """Raw (N, 3) cloud → front-compacted (rings, W) scan.

    Nearest return wins a (ring, column) cell (``scanRegistration.cpp:160-241``).
    One stable sort by (cell key, range²) puts each cell's winner first in its
    run, ring-major and azimuth-ordered — compacted scan order."""
    x, y = points[..., 0], points[..., 1]
    rng_sq = torch.sum(points * points, dim=-1)
    ring, in_fov = ring_index_hdl(points, n_scans)
    ok = (
        mask
        & in_fov
        & (rng_sq > min_range * min_range)
        & (rng_sq < max_range * max_range)
        & torch.all(torch.isfinite(points), dim=-1)
    )
    ori = -torch.atan2(y, x)
    col = torch.floor((ori + math.pi) * _recip32(2.0 * math.pi) * width).to(torch.int32)
    col = torch.clamp(col, 0, width - 1)
    ring_c = torch.clamp(ring, 0, n_scans - 1)
    sentinel = n_scans * width
    key = torch.where(ok, ring_c * width + col, torch.full_like(col, sentinel))

    # (key, range²) packed into one exact int64: key < 2^18, range² bits < 2^31
    packed = (key.to(torch.int64) << 31) | _float_order_bits(rng_sq)
    _, order = torch.sort(packed, stable=True)
    key_s = key[order].to(torch.int64)
    pts_s = points[order]

    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    winner = first & (key_s < sentinel)
    ring_s = torch.div(key_s, width, rounding_mode="floor")

    count = torch.zeros(n_scans + 1, dtype=torch.int64, device=points.device)
    count.scatter_add_(0, torch.where(winner, ring_s, n_scans), winner.to(torch.int64))
    count = count[:n_scans]
    starts = torch.cumsum(count, 0) - count
    start_pp = starts[torch.clamp(ring_s, max=n_scans - 1)]
    wrank = torch.cumsum(winner.to(torch.int64), 0) - 1
    pos = wrank - start_pp
    dst = torch.where(winner & (pos < width), ring_s * width + pos,
                      torch.full_like(pos, sentinel))

    rel = ((key_s % width).to(torch.float32) + 0.5) / width
    rows = torch.cat([pts_s, rel[:, None]], dim=1)
    rows = torch.where(winner[:, None], rows, torch.zeros_like(rows))
    # winners land on distinct cells; every other row lands on the dropped
    # sentinel row
    grid = torch.zeros((sentinel + 1, 4), dtype=points.dtype, device=points.device)
    grid.index_put_((dst,), rows)
    grid = grid[:sentinel].reshape(n_scans, width, 4)
    count = count.to(torch.int32)
    idx = torch.arange(width, dtype=torch.int32, device=points.device)[None, :]
    valid = idx < count[:, None]
    return CompactScan(grid[..., :3], valid, grid[..., 3], count)


def build_range_image(
    points: torch.Tensor,
    mask: torch.Tensor,
    *,
    n_scans: int,
    width: int,
    min_range: float,
    max_range: float = 1e9,
) -> RangeImage:
    """Raw (N, 3) cloud → dense (rings, W) grid (the ring bucketing of
    ``scanRegistration.cpp:160-241``): azimuth indexes the columns, and within
    a cell the nearest return wins (a scatter-min on range²; of equal ranges
    the last point, as the reference's scatter lands them in order). The
    arithmetic is the reference's run op by op, as its tests call it: a true
    division for the column. (Under ``jit`` the reference's compiler fuses
    the range into its comparisons, and on the CPU a farther return then wins
    some cells; ``build_compact_scan`` is the form the pipelines run.)"""
    x, y = points[..., 0], points[..., 1]
    rng_sq = torch.sum(points * points, dim=-1)
    ring, in_fov = ring_index_hdl(points, n_scans)
    ok = (
        mask
        & in_fov
        & (rng_sq > min_range * min_range)
        & (rng_sq < max_range * max_range)
        & torch.all(torch.isfinite(points), dim=-1)
    )
    ori = -torch.atan2(y, x)
    col = torch.floor((ori + math.pi) / (2.0 * math.pi) * width).to(torch.int64)
    col = torch.clamp(col, 0, width - 1)
    ring_c = torch.clamp(ring.to(torch.int64), 0, n_scans - 1)
    sentinel = n_scans * width
    flat = torch.where(ok, ring_c * width + col, torch.full_like(col, sentinel))

    dev = points.device
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)
    best = torch.full((sentinel + 1,), 1e30, dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, flat, torch.where(ok, rng_sq, big), reduce="amin")
    nearest = ok & (best[flat] == rng_sq)
    idx = torch.arange(points.shape[0], device=dev)
    last = torch.full((sentinel + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, torch.where(nearest, idx, -1), reduce="amax")
    winner = nearest & (last[flat] == idx)
    dst = torch.where(winner, flat, torch.full_like(flat, sentinel))
    xyz = torch.zeros((sentinel + 1, 3), dtype=points.dtype, device=dev)
    xyz.index_put_((dst,), torch.where(winner[:, None], points, torch.zeros_like(points)))
    valid = torch.zeros((sentinel + 1,), dtype=torch.bool, device=dev)
    valid.index_put_((dst,), winner)
    rel = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    return RangeImage(xyz[:sentinel].reshape(n_scans, width, 3),
                      valid[:sentinel].reshape(n_scans, width),
                      rel.expand(n_scans, width))


def compact_rings(ri: RangeImage) -> CompactScan:
    """Shift each ring's valid cells to the front, in scan order
    (``scanRegistration.cpp:256-266``)."""
    W = ri.valid.shape[1]
    order = torch.sort((~ri.valid).to(torch.uint8), dim=1, stable=True).indices
    xyz = torch.gather(ri.xyz, 1, order[..., None].expand(-1, -1, 3))
    rel_time = torch.gather(ri.rel_time, 1, order)
    count = ri.valid.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(W, dtype=torch.int32, device=ri.valid.device)[None, :]
    return CompactScan(xyz, idx < count[:, None], rel_time, count)


def voxel_downsample_batched(
    xyz: torch.Tensor,    # (R, W, 3)
    mask: torch.Tensor,   # (R, W)
    *,
    leaf: float,
    max_out: int,
    origin: float | None = None,
) -> PointBatch:
    """Per-row voxel-grid filter (≡ pcl::VoxelGrid, ``scanRegistration.cpp:401-407``):
    mean of the points per occupied voxel, at most ``max_out`` voxels per row.

    Each row sorts by voxel (kxy = qx·2048 + qy, then qz), numbers the runs of
    equal voxel, and sums every run with kernel K1 (``segment_sum_batched``);
    points beyond ``max_out`` voxels, and invalid points, land in the overflow
    bucket ``max_out``, which is dropped. Returns ((R, max_out, 3),
    (R, max_out))."""
    R, W = mask.shape
    if origin is None:
        origin = -1024.0 * leaf
    q = torch.clamp(torch.floor((xyz - origin) * _recip32(leaf)).to(torch.int32), 0, 2047)
    kxy = torch.where(mask, q[..., 0] * 2048 + q[..., 1],
                      torch.full_like(q[..., 0], 2**31 - 1))
    kz = q[..., 2]
    packed = (kxy.to(torch.int64) << 11) | kz.to(torch.int64)
    packed_s, order = torch.sort(packed, dim=1, stable=True)
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(R, W, 3))
    mask_s = torch.gather(mask, 1, order)

    is_start = torch.ones_like(mask_s)
    is_start[:, 1:] = packed_s[:, 1:] != packed_s[:, :-1]
    is_start = is_start & mask_s
    run_id = torch.cumsum(is_start.to(torch.int32), dim=1, dtype=torch.int32) - 1
    run_id = torch.where(mask_s, torch.clamp(run_id, max=max_out),
                         torch.full_like(run_id, max_out))

    vals = torch.cat([xyz_s.permute(0, 2, 1), mask_s.to(torch.float32)[:, None, :]],
                     dim=1).contiguous()                           # (R, 4, W)
    sums = segment_sum_batched(run_id.contiguous(), vals, n_segments=max_out + 1)
    sum_xyz = sums[:, :3, :max_out].permute(0, 2, 1)
    cnts = sums[:, 3, :max_out]
    out_mask = cnts > 0
    out_xyz = sum_xyz / torch.clamp(cnts[..., None], min=1.0)
    return PointBatch(out_xyz, out_mask)


def voxel_hash(q: torch.Tensor) -> torch.Tensor:
    """The reference's spatial hash of (..., 3) int32 voxel coordinates:
    ``(qx·73856093 ^ qy·19349663 ^ qz·83492791)`` in uint32, kept to its low
    31 bits, as int64."""
    q = q.to(torch.int64)
    m32 = 0xFFFFFFFF
    h = ((q[..., 0] * 73856093) & m32) ^ ((q[..., 1] * 19349663) & m32) \
        ^ ((q[..., 2] * 83492791) & m32)
    return h & 0x7FFFFFFF


def stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation of a stable lexicographic sort by ``keys`` (most significant
    first), each a non-negative int64 key below 2^63: one stable pass per key,
    least significant first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order


def voxel_downsample(
    xyz: torch.Tensor,    # (N, 3)
    mask: torch.Tensor,   # (N,)
    *,
    leaf: float,
    max_out: int,
    origin: float | None = None,
) -> PointBatch:
    """Flat voxel-grid filter (≡ pcl::VoxelGrid): mean of the points per
    occupied voxel, at most ``max_out`` voxels. Returns ((max_out, 3),
    (max_out,)).

    Points sort by (hash, kxy = qx·2048 + qy, qz), masked points last; runs of
    equal voxel are numbered and summed by kernel K1's flat ``segment_sum``.
    When more than ``max_out`` voxels are occupied the extras fall in the
    overflow bucket, and the hash order makes that an unbiased spatial
    subsample. With masked points sorting last the keys take 65 bits, so the
    stable sort runs in two passes: (kxy, qz), then the hash. Coverage is
    ±1024·leaf around ``origin``, clamped beyond."""
    if origin is None:
        origin = -1024.0 * leaf
    q = torch.clamp(torch.floor((xyz - origin) * _recip32(leaf)).to(torch.int32), 0, 2047)
    q64 = q.to(torch.int64)
    kxy = torch.where(mask, q64[:, 0] * 2048 + q64[:, 1], torch.full_like(q64[:, 0], 1 << 22))
    low = (kxy << 11) | q64[:, 2]
    h = torch.where(mask, voxel_hash(q), torch.full_like(kxy, 2**31 - 1))
    order = stable_order(h, low)
    low_s = low[order]
    xyz_s = xyz[order]
    mask_s = mask[order]

    is_start = torch.ones_like(mask_s)
    is_start[1:] = low_s[1:] != low_s[:-1]
    is_start = is_start & mask_s
    run_id = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32) - 1
    run_id = torch.where(mask_s, torch.clamp(run_id, max=max_out),
                         torch.full_like(run_id, max_out))

    vals = torch.cat([torch.where(mask_s[:, None], xyz_s, torch.zeros_like(xyz_s)).T,
                      mask_s.to(torch.float32)[None]], dim=0).contiguous()   # (4, N)
    acc = segment_sum(run_id.contiguous(), vals, n_segments=max_out + 1)
    sums = acc[:3, :max_out].T
    cnts = acc[3, :max_out]
    return PointBatch(sums / torch.clamp(cnts[:, None], min=1.0), cnts > 0)


# ---------------------------------------------------------------------------
# Polar packed ingest: 2 B (range only) or 4 B (range + angular offsets) per
# (ring, azimuth) cell; the decoded grid is already the range image.
# ---------------------------------------------------------------------------

POLAR_RANGE_Q = 131.072 / 65536.0  # 2 mm over [0, 131) m; 0 = empty cell


def ring_elevations(n_scans: int):
    """(nominal elevation rad (R,), max half-spacing rad) for the ring
    formulas of ``ring_index_hdl`` (``scanRegistration.cpp:168-199``)."""
    i = np.arange(n_scans, dtype=np.float64)
    if n_scans == 16:
        nom, half = -15.0 + 2.0 * i, 1.0
    elif n_scans == 32:
        nom, half = (i + 0.5) * 4.0 / 3.0 - 92.0 / 3.0, 2.0 / 3.0
    elif n_scans == 64:
        nom = np.where(i < 32, 2.0 - i / 3.0, -8.83 - (i - 32) / 2.0)
        half = 0.25
    else:
        raise ValueError(f"unsupported n_scans={n_scans}")
    return np.radians(nom).astype(np.float32), float(np.radians(half))


def _ring_index_np(xyz, n_scans: int):
    """numpy twin of ``ring_index_hdl`` (host packer side)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = np.degrees(np.arctan2(z, np.sqrt(x * x + y * y)))
    if n_scans == 16:
        ring = np.floor((angle + 15.0) / 2.0 + 0.5).astype(np.int32)
        ok = (ring >= 0) & (ring <= n_scans - 1)
    elif n_scans == 32:
        ring = np.floor((angle + 92.0 / 3.0) * 3.0 / 4.0).astype(np.int32)
        ok = (ring >= 0) & (ring <= n_scans - 1)
    elif n_scans == 64:
        upper = np.floor((2.0 - angle) * 3.0 + 0.5).astype(np.int32)
        lower = 32 + np.floor((-8.83 - angle) * 2.0 + 0.5).astype(np.int32)
        ring = np.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 50)
    else:
        raise ValueError(f"unsupported n_scans={n_scans}")
    return np.clip(ring, 0, n_scans - 1), ok


def pack_polar_scan(
    pts,
    *,
    n_scans: int,
    width: int,
    min_range: float,
    max_range: float,
    channels: int = 2,
) -> np.ndarray:
    """Host side: raw (n, ≥3) float scan → (R, W, channels) uint16 polar image.

    Channel 0 = quantized range (0 ⇒ empty cell); channel 1 = packed int8
    angular offsets ``(el_off << 8) | az_off`` (biased by 128) relative to the
    cell's ring elevation and azimuth-bin centre. Nearest return wins a cell.
    ``channels=1`` keeps the range only (2 B/cell)."""
    xyz = np.asarray(pts)[:, :3].astype(np.float32)
    rng = np.sqrt(np.sum(xyz * xyz, axis=1))
    ring, ok = _ring_index_np(xyz, n_scans)
    ok = ok & (rng > min_range) & (rng < max_range) & np.isfinite(xyz).all(axis=1)
    ori = -np.arctan2(xyz[:, 1], xyz[:, 0])
    col = np.clip(
        np.floor((ori + np.pi) / (2.0 * np.pi) * width).astype(np.int32), 0, width - 1
    )

    flat = ring * width + col
    rmin = np.full((n_scans * width,), np.inf, np.float32)
    np.minimum.at(rmin, flat[ok], rng[ok])
    win = ok & (rmin[flat] == rng)

    nominal, el_half = ring_elevations(n_scans)
    az_q = np.pi / width / 127.0
    el_q = el_half / 127.0

    qr = np.clip(np.rint(rng / POLAR_RANGE_Q), 1, 65535).astype(np.uint16)
    img = np.zeros((n_scans * width, channels), np.uint16)
    img[flat[win], 0] = qr[win]
    if channels >= 2:
        elev = np.arctan2(xyz[:, 2], np.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2))
        d_el = elev - nominal[ring]
        d_az = ori - (-np.pi + (col.astype(np.float32) + 0.5) * (2.0 * np.pi / width))
        qel = np.clip(np.rint(d_el / el_q), -127, 127).astype(np.int32) + 128
        qaz = np.clip(np.rint(d_az / az_q), -127, 127).astype(np.int32) + 128
        img[flat[win], 1] = ((qel[win] << 8) | qaz[win]).astype(np.uint16)
    return img.reshape(n_scans, width, channels)


def pack_polar_chunk(
    scans,
    *,
    n_scans: int,
    width: int,
    min_range: float,
    max_range: float,
    channels: int = 2,
) -> np.ndarray:
    """Pack a list of raw scans → (K, R, W, channels) uint16, one
    ``pack_polar_scan`` per frame."""
    out = np.zeros((len(scans), n_scans, width, channels), np.uint16)
    for i, pts in enumerate(scans):
        out[i] = pack_polar_scan(
            pts, n_scans=n_scans, width=width, min_range=min_range,
            max_range=max_range, channels=channels,
        )
    return out


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array → tensor on ``device``, without waiting for the card: a copy
    from pageable memory drains the stream first, so the bytes go through
    pinned memory and the copy is queued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def polar_image_to_tensor(img: np.ndarray, device) -> torch.Tensor:
    """Upload a uint16 polar image as int32 cells on ``device``.

    The bytes travel as 16-bit (the image is viewed as int16 for the copy) and
    widen on the device."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    return to_device(img.view(np.int16), device).to(torch.int32) & 0xFFFF


def polar_to_compact(
    img: torch.Tensor,  # (R, W, 2|1) int32 cells (polar_image_to_tensor)
    *,
    n_scans: int,
    width: int,
    min_range: float,
    max_range: float,
) -> CompactScan:
    """Device decode: polar image → front-compacted scan, one stable per-row
    sort that moves valid cells to the front.

    A single-channel image (range only) decodes at the nominal ring elevation
    and the azimuth-bin centre."""
    nominal, el_half = ring_elevations(n_scans)
    nominal = to_device(nominal, img.device)
    az_q = np.pi / width / 127.0
    el_q = el_half / 127.0

    rq = img[..., 0].to(torch.float32)
    r = rq * POLAR_RANGE_Q
    colf = torch.arange(width, dtype=torch.float32, device=img.device)[None, :]
    if img.shape[-1] >= 2:
        packed = img[..., 1]
        az_off = (packed & 0xFF).to(torch.float32) - 128.0
        el_off = (packed >> 8).to(torch.float32) - 128.0
        ori = -math.pi + (colf + 0.5) * (2.0 * math.pi / width) + az_off * az_q
        el = nominal[:, None] + el_off * el_q
    else:
        ori = (-math.pi + (colf + 0.5) * (2.0 * math.pi / width)).expand(rq.shape)
        el = nominal[:, None].expand(rq.shape)
    d = r * torch.cos(el)
    # ori = -atan2(y, x)  ⇒  x = d·cos(ori), y = -d·sin(ori)
    x = d * torch.cos(ori)
    y = -d * torch.sin(ori)
    z = r * torch.sin(el)
    valid = (rq > 0.5) & (r > min_range) & (r < max_range)
    rel = ((colf + 0.5) / width).expand(valid.shape)

    _, order = torch.sort((~valid).to(torch.int32), dim=1, stable=True)
    xyz = torch.stack([x, y, z], dim=-1)
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(*order.shape, 3))
    rel_s = torch.gather(rel, 1, order)
    count = valid.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(width, dtype=torch.int32, device=img.device)[None, :]
    return CompactScan(xyz_s, idx < count[:, None], rel_s, count)


def pad_points(xyz, n: int):
    """Host helper: pad an (m, 3) array to capacity n with a mask."""
    m = xyz.shape[0]
    if m > n:
        raise ValueError(f"cloud of {m} points exceeds capacity {n}")
    out = np.zeros((n, 3), dtype=np.float32)
    out[:m] = xyz[:, :3]
    mask = np.zeros((n,), dtype=bool)
    mask[:m] = True
    return out, mask
