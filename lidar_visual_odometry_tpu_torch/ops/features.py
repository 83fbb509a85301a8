"""Lidar feature extraction, ported from ``lidar_visual_odometry_tpu/ops/features.py``
(≡ A-LOAM scanRegistration, ``src/scanRegistration.cpp:256-407``).

* curvature = |Σ_{k=±1..5} p[i+k] − 10·p[i]|² along each compacted ring;
* each ring's eligible span [5, count−6] splits into 6 sectors with the
  reference's integer arithmetic;
* per sector, greedy descending-curvature corner picks (≤2 sharp, ≤20
  less-sharp, curvature > 0.1) and ascending flat picks (≤4, curvature < 0.1),
  each pick suppressing ±5 neighbours up to a > 0.05 m² gap;
* everything not labelled a corner feeds the less-flat cloud, voxel-filtered
  per ring at a 0.2 m leaf.

The greedy picks are sequential: each is one masked arg-max (or arg-min) over
the (rings, W) plane, all rings at once. ``torch.argmax``/``argmin`` return the
first extremum, as ``jnp`` does, so the same points are picked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pointcloud import CompactScan, voxel_downsample_batched


class FeatureCloud(NamedTuple):
    """Padded feature point set with per-point ring id and scan time."""

    xyz: torch.Tensor       # (N, 3)
    ring: torch.Tensor      # (N,) int32
    rel_time: torch.Tensor  # (N,) float32 in [0, 1)
    mask: torch.Tensor      # (N,) bool


class ScanFeatures(NamedTuple):
    sharp: FeatureCloud       # ≤ 2/sector corners
    less_sharp: FeatureCloud  # ≤ 20/sector corners (superset of sharp)
    flat: FeatureCloud        # ≤ 4/sector planar points
    less_flat: FeatureCloud   # voxel-downsampled remainder (labels ≤ 0)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift along axis 1 by k (positive → pull from the right)."""
    if k == 0:
        return x
    pad = torch.full_like(x[:, :abs(k)], fill)
    if k > 0:
        return torch.cat([x[:, k:], pad], dim=1)
    return torch.cat([pad, x[:, :k]], dim=1)


def curvature(cs: CompactScan) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point curvature and eligibility over the compacted rings.

    Eligible points have 5 neighbours on each side inside the ring, on rings
    with count ≥ 17 (the reference skips rings with end − start < 6)."""
    R, W = cs.valid.shape
    acc = -10.0 * cs.xyz
    for k in list(range(-5, 0)) + list(range(1, 6)):
        acc = acc + _shift(cs.xyz, k, 0.0)
    curv = acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1] + acc[..., 2] * acc[..., 2]

    idx = torch.arange(W, dtype=torch.int32, device=cs.xyz.device)[None, :]
    count = cs.count[:, None]
    eligible = (idx >= 5) & (idx <= count - 6) & (count >= 17)
    return curv, eligible


def _suppression_reach(cs: CompactScan) -> tuple[torch.Tensor, torch.Tensor]:
    """How far ±suppression extends from each point before a > 0.05 m² jump
    between consecutive returns stops it (``:319-342``). Returns
    (reach_left, reach_right), each (R, W) int32 in [0, 5]."""
    nxt = _shift(cs.xyz, 1, float("inf"))
    diff = nxt - cs.xyz
    gap_sq = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    gap_ok = (gap_sq <= 0.05) & cs.valid & _shift(cs.valid, 1, False)
    # reach_right[i] = longest run of ok gaps starting at i, capped at 5
    run = gap_ok.to(torch.int32)
    reach_r = run.clone()
    acc = run
    for k in range(1, 5):
        acc = acc & _shift(gap_ok, k, False).to(torch.int32)
        reach_r = reach_r + acc
    # reach_left[i] = reach over gaps (i-1, i-2, ...): same runs shifted
    gap_ok_l = _shift(gap_ok, -1, False)
    run = gap_ok_l.to(torch.int32)
    reach_l = run.clone()
    acc = run
    for k in range(1, 5):
        acc = acc & _shift(gap_ok_l, -k, False).to(torch.int32)
        reach_l = reach_l + acc
    return reach_l, reach_r


def _sector_bounds(count: torch.Tensor, n_sectors: int, j: int):
    """Sector j of the span [5, count−6] (``:285-287``, integer division)."""
    span = torch.clamp(count - 11, min=0)
    sp = 5 + torch.div(span * j, n_sectors, rounding_mode="floor")
    ep = 5 + torch.div(span * (j + 1), n_sectors, rounding_mode="floor") - 1
    return sp, ep


def extract_features(
    cs: CompactScan,
    *,
    n_sectors: int = 6,
    max_sharp: int = 2,
    max_less_sharp: int = 20,
    max_flat: int = 4,
    edge_gate: float = 0.1,
    surf_gate: float = 0.1,
    surf_leaf: float = 0.2,
    max_less_flat_per_ring: int = 512,
) -> ScanFeatures:
    R, W = cs.valid.shape
    dev = cs.xyz.device
    curv, eligible = curvature(cs)
    reach_l, reach_r = _suppression_reach(cs)
    idx = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    neg = torch.full_like(curv, -1e30)
    pos = torch.full_like(curv, 1e30)

    def suppress(avail, pick, on):
        """Clear availability in [pick − reach_l[pick], pick + reach_r[pick]]."""
        p = pick[:, None]
        rl = torch.gather(reach_l, 1, p)
        rr = torch.gather(reach_r, 1, p)
        hit = ((idx >= p - rl) & (idx <= p + rr)) | (idx == p)
        return avail & ~(hit & on[:, None])

    # Sequential over sectors (suppression crosses sector boundaries, like the
    # reference's ring-global cloudNeighborPicked), fixed pick counts inside.
    avail = eligible & cs.valid
    corner_picks, corner_ok, flat_picks, flat_ok = [], [], [], []
    corner_label = torch.zeros((R, W), dtype=torch.int8, device=dev)
    for j in range(n_sectors):
        sp, ep = _sector_bounds(cs.count, n_sectors, j)
        sector_mask = (idx >= sp[:, None]) & (idx <= ep[:, None])
        cps, coks = [], []
        for _ in range(max_less_sharp):          # corners: descending curvature
            score = torch.where(avail & sector_mask, curv, neg)
            pick = torch.argmax(score, dim=1)
            ok = torch.gather(score, 1, pick[:, None])[:, 0] > edge_gate
            avail = suppress(avail, pick, ok)
            cps.append(pick)
            coks.append(ok)
        cp, cok = torch.stack(cps, dim=1), torch.stack(coks, dim=1)   # (R, K)
        corner_picks.append(cp)
        corner_ok.append(cok)
        corner_label.scatter_reduce_(1, cp, cok.to(torch.int8), reduce="amax")
        fps, foks = [], []
        for _ in range(max_flat):                # flats: ascending curvature
            score = torch.where(avail & sector_mask, curv, pos)
            pick = torch.argmin(score, dim=1)
            ok = torch.gather(score, 1, pick[:, None])[:, 0] < surf_gate
            avail = suppress(avail, pick, ok)
            fps.append(pick)
            foks.append(ok)
        flat_picks.append(torch.stack(fps, dim=1))
        flat_ok.append(torch.stack(foks, dim=1))

    corner_picks = torch.stack(corner_picks, dim=1)   # (R, S, K)
    corner_ok = torch.stack(corner_ok, dim=1)
    flat_picks = torch.stack(flat_picks, dim=1)
    flat_ok = torch.stack(flat_ok, dim=1)
    ring_ids = torch.arange(R, dtype=torch.int32, device=dev)[:, None, None]

    def gather(picks, ok):
        flatp = picks.reshape(R, -1)
        xyz = torch.gather(cs.xyz, 1, flatp[..., None].expand(*flatp.shape, 3))
        rt = torch.gather(cs.rel_time, 1, flatp)
        return FeatureCloud(
            xyz.reshape(-1, 3), ring_ids.expand(picks.shape).reshape(-1),
            rt.reshape(-1), ok.reshape(-1),
        )

    less_sharp = gather(corner_picks, corner_ok)
    sharp = gather(corner_picks[:, :, :max_sharp], corner_ok[:, :, :max_sharp])
    flat = gather(flat_picks, flat_ok)

    # less-flat: everything not labelled a corner (labels ≤ 0 include flats,
    # scanRegistration.cpp:391-398), voxel-downsampled per ring
    lf_mask = cs.valid & (corner_label == 0)
    ds = voxel_downsample_batched(
        cs.xyz, lf_mask, leaf=surf_leaf, max_out=max_less_flat_per_ring
    )
    lf_ring = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(
        R, max_less_flat_per_ring
    )
    less_flat = FeatureCloud(
        ds.xyz.reshape(-1, 3),
        lf_ring.reshape(-1),
        torch.zeros((R * max_less_flat_per_ring,), dtype=torch.float32, device=dev),
        ds.mask.reshape(-1),
    )
    return ScanFeatures(sharp, less_sharp, flat, less_flat)
