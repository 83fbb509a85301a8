"""Nearest-neighbour searches, ported from ``lidar_visual_odometry_tpu/ops/knn.py``.

The A-LOAM ring-structured searches (``laserOdometry.cpp:384-561``) pick, per
query, the nearest candidate j0 (ring r0), for planes r0's runner-up, and the
nearest on a ring within ±``nearby_scan`` of r0, each gated at
``dist_sq_threshold``. Candidate clouds arrive ring-major as (R, B, 3) blocks
with (R, B) masks. Three formulations, as in the reference:

* ``associate_edges_coords`` / ``associate_planes_coords`` (the odometry
  path): coordinates through kernel K2 (``kernels.nn.associate_kernel``);
* ``associate_edges_ringblocked`` / ``associate_planes_ringblocked``: indices
  from the per-ring top-2 of ``ring_top2_best`` (kernel K7's index form);
  ``_ring_top2_with_coords`` is K7's coordinate form, and
  ``associate_*_coords_top2`` the reference's cross-ring selection over it
  (its off-TPU branch of ``associate_*_coords``);
* ``associate_edges`` / ``associate_planes``: dense masked arg-mins over the
  matrix-product distances of ``pairwise_sqdist``; ``ring_top2`` is the
  reference's per-ring top-2 in the same form.

The kernel formulations bake masked candidates to ``BAKE_FAR``, so a masked
slot reads its distance (~3e12) where the matrix-product forms read 1e30; the
gates reject both. B is taken as it is (the TPU path pads it to 128 lanes).
Off the odometry path only tests and ``chip_smoke.py`` call the ring-blocked
and dense forms. ``knn`` is the dense k-NN of the visual depth association
and, streamed in column blocks (``chunk``), of the sharded scan-to-map step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import nn

_BIG = 1e30


def pairwise_sqdist(q: torch.Tensor, c: torch.Tensor,
                    c_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 3) × (C, 3) → (Q, C) squared distances |q|² + |c|² − 2 q·c in
    full float32 (the product never runs in TF32: ``utils.device``);
    masked candidates → 1e30."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)[None, :]
    d = torch.clamp(qq + cc - 2.0 * (q @ c.T), min=0.0)
    if c_mask is not None:
        d = torch.where(c_mask[None, :], d, torch.full_like(d, _BIG))
    return d


def masked_argmin(d: torch.Tensor, extra_mask: torch.Tensor | None = None):
    """Per-row arg-min (first index on ties) with an optional (Q, C) mask →
    (idx (Q,), val (Q,))."""
    if extra_mask is not None:
        d = torch.where(extra_mask, d, torch.full_like(d, _BIG))
    idx = torch.argmin(d, dim=-1)
    return idx, d.gather(-1, idx[:, None])[:, 0]


def sqdist_by_axis(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q, 3) × (C, 3) → (Q, C) squared distances (qx−cx)² + (qy−cy)² +
    (qz−cz)², one elementwise operation at a time: each pair's value is the
    same bits whatever the shapes around it (a matrix product's rounding may
    depend on them)."""
    d = (q[:, None, 0] - c[None, :, 0]).square()
    d = d + (q[:, None, 1] - c[None, :, 1]).square()
    return d + (q[:, None, 2] - c[None, :, 2]).square()


def _smallest_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, values) of the k smallest entries of each row of the
    non-negative ``d``, ascending, the lower position first among equal
    values (as ``lax.top_k``), in one ``topk``: each entry's key is its
    float32 bits (monotonic for values ≥ +0) over its position, so the keys
    are unique and order by (value, position)."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)      # −0 → +0
    pos = torch.arange(d.shape[1], device=d.device)
    keys = torch.topk((bits << 32) | pos, k, dim=1, largest=False, sorted=True).values
    sel = keys & 0xFFFFFFFF
    return sel, d.gather(1, sel)


def knn(q_xyz: torch.Tensor, c_xyz: torch.Tensor, c_mask: torch.Tensor,
        k: int, *, chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense k-NN: (Q, k) indices and squared distances, ascending, the lower
    index first among equal distances (as ``lax.top_k``).

    ``chunk`` streams the candidates in blocks of ``chunk`` columns with a
    running top-k (peak memory Q × chunk, not Q × C), as the JAX package's
    does. Its running set starts as k slots of index 0 at distance 1e30 and
    comes first in every merge, so a masked candidate (at 1e30) never enters
    it: the result is the unmasked candidates' k best by (distance, index),
    padded with (index 0, 1e30), whatever the blocks. So only the unmasked
    candidates are searched, compacted in index order (one read of their
    count). The streamed distances are ``sqdist_by_axis``'s, so a pair's
    distance does not depend on the block it lands in: the sharded
    scan-to-map step's merge of the ranks' blocks then finds what one rank
    finds over the whole map."""
    if chunk is None or chunk >= c_xyz.shape[0]:
        return _smallest_k(pairwise_sqdist(q_xyz, c_xyz, c_mask), k)
    Q = q_xyz.shape[0]
    valid = torch.nonzero(c_mask).squeeze(1)
    cands = c_xyz[valid]
    best_d = torch.full((Q, k), _BIG, dtype=q_xyz.dtype, device=q_xyz.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=q_xyz.device)
    for base in range(0, valid.shape[0], chunk):
        d = torch.cat([best_d, sqdist_by_axis(q_xyz, cands[base:base + chunk])], dim=1)
        all_i = torch.cat([best_i, valid[base:base + chunk].expand(Q, -1)], dim=1)
        sel, best_d = _smallest_k(d, k)
        best_i = all_i.gather(1, sel)
    return best_i, best_d


class EdgeAssoc(NamedTuple):
    """Indices into the candidate cloud for the point-to-line factor."""

    j0: torch.Tensor     # nearest neighbour
    j2: torch.Tensor     # nearest on a different ring within ±nearby_scan
    valid: torch.Tensor


class PlaneAssoc(NamedTuple):
    j0: torch.Tensor     # nearest neighbour
    j2: torch.Tensor     # nearest other point on the same ring
    j3: torch.Tensor     # nearest on a different ring within ±nearby_scan
    valid: torch.Tensor


def associate_edges(q_xyz, q_mask, c_xyz, c_ring, c_mask, *,
                    dist_sq_threshold: float = 25.0, nearby_scan: float = 2.5) -> EdgeAssoc:
    """Corner association (≡ laserOdometry.cpp:384-465) over a flat cloud
    (C, 3) with rings (C,) and mask (C,): dense masked arg-mins."""
    d = pairwise_sqdist(q_xyz, c_xyz, c_mask)
    j0, d0 = masked_argmin(d)
    r0 = c_ring[j0]
    ring_diff = (c_ring[None, :].to(torch.float32) - r0[:, None].to(torch.float32)).abs()
    j2, d2 = masked_argmin(d, (ring_diff > 0.0) & (ring_diff <= nearby_scan))
    valid = q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
    return EdgeAssoc(j0, j2, valid)


def associate_planes(q_xyz, q_mask, c_xyz, c_ring, c_mask, *,
                     dist_sq_threshold: float = 25.0, nearby_scan: float = 2.5) -> PlaneAssoc:
    """Surf association (≡ laserOdometry.cpp:468-561), as ``associate_edges``:
    j2 is the nearest other point on j0's ring."""
    d = pairwise_sqdist(q_xyz, c_xyz, c_mask)
    j0, d0 = masked_argmin(d)
    r0 = c_ring[j0]
    ring_diff = (c_ring[None, :].to(torch.float32) - r0[:, None].to(torch.float32)).abs()
    col = torch.arange(c_xyz.shape[0], device=d.device)[None, :]
    j2, d2 = masked_argmin(d, (ring_diff == 0.0) & (col != j0[:, None]))
    j3, d3 = masked_argmin(d, (ring_diff > 0.0) & (ring_diff <= nearby_scan))
    valid = (q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
             & (d3 < dist_sq_threshold))
    return PlaneAssoc(j0, j2, j3, valid)


def ring_top2(q_xyz: torch.Tensor, c_blocks: torch.Tensor, m_blocks: torch.Tensor):
    """The reference's per-(query, ring) top-2 in matrix-product form:
    (dist (Q, R, 2), idx (Q, R, 2) int32 flat into R·B); masked candidates
    read 1e30, the runner-up is the arg-min with the winner set to 1e30."""
    R, B, _ = c_blocks.shape
    qq = torch.sum(q_xyz * q_xyz, dim=-1)[:, None, None]
    cc = torch.sum(c_blocks * c_blocks, dim=-1)[None]
    qc = torch.einsum("qd,rbd->qrb", q_xyz, c_blocks)
    d = torch.clamp(qq + cc - 2.0 * qc, min=0.0)
    d = torch.where(m_blocks[None], d, torch.full_like(d, _BIG))
    i1 = torch.argmin(d, dim=-1, keepdim=True)
    d1 = d.gather(-1, i1)
    d = d.scatter(-1, i1, _BIG)
    i2 = torch.argmin(d, dim=-1, keepdim=True)
    d2 = d.gather(-1, i2)
    base = torch.arange(R, dtype=torch.int32, device=d.device)[None, :, None] * B
    return torch.cat([d1, d2], -1), torch.cat([i1, i2], -1).to(torch.int32) + base


def ring_top2_best(q_xyz: torch.Tensor, c_blocks: torch.Tensor, m_blocks: torch.Tensor):
    """Per-(query, ring) top-2 (dist, idx) through kernel K7
    (``kernels.nn.ring_top2_pallas``; its plain version on a CPU tensor),
    masked candidates baked to BAKE_FAR."""
    return nn.ring_top2_pallas(q_xyz.contiguous(),
                               nn.bake_mask(c_blocks, m_blocks).contiguous())


def _ring_select(d1: torch.Tensor, nearby_scan: float):
    """From the per-ring best distances d1 (Q, R): the nearest ring r0 and
    its distance, and the nearest ring within ±nearby_scan of r0 (first
    ring on ties; 1e30 when no ring is in the window) and its distance."""
    r0 = torch.argmin(d1, dim=1)
    rings = torch.arange(d1.shape[1], dtype=torch.float32, device=d1.device)[None, :]
    rd = (rings - r0[:, None].to(torch.float32)).abs()
    d1m = torch.where((rd > 0.0) & (rd <= nearby_scan), d1, torch.full_like(d1, _BIG))
    rw = torch.argmin(d1m, dim=1)
    return r0, _take_ring(d1, r0), rw, _take_ring(d1m, rw)


def associate_edges_ringblocked(q_xyz, q_mask, c_blocks, m_blocks, *,
                                dist_sq_threshold: float = 25.0,
                                nearby_scan: float = 2.5) -> EdgeAssoc:
    """Corner association over ring-major blocks (the semantics of
    ``associate_edges``): indices flat into R·B."""
    dist, idx = ring_top2_best(q_xyz, c_blocks, m_blocks)
    r0, d0, r2, d2 = _ring_select(dist[:, :, 0], nearby_scan)
    j0 = _take_ring(idx[:, :, 0], r0)
    j2 = _take_ring(idx[:, :, 0], r2)
    valid = q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
    return EdgeAssoc(j0, j2, valid)


def associate_planes_ringblocked(q_xyz, q_mask, c_blocks, m_blocks, *,
                                 dist_sq_threshold: float = 25.0,
                                 nearby_scan: float = 2.5) -> PlaneAssoc:
    """Surf association over ring-major blocks: j0 the nearest, j2 ring r0's
    runner-up, j3 the nearest on a ring within ±nearby_scan of r0."""
    dist, idx = ring_top2_best(q_xyz, c_blocks, m_blocks)
    r0, d0, r3, d3 = _ring_select(dist[:, :, 0], nearby_scan)
    j0 = _take_ring(idx[:, :, 0], r0)
    d2 = _take_ring(dist[:, :, 1], r0)
    j2 = _take_ring(idx[:, :, 1], r0)
    j3 = _take_ring(idx[:, :, 0], r3)
    valid = (q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
             & (d3 < dist_sq_threshold))
    return PlaneAssoc(j0, j2, j3, valid)


def _ring_top2_with_coords(q_xyz: torch.Tensor, c_blocks: torch.Tensor,
                           m_blocks: torch.Tensor):
    """(dist (Q, R, 2), c1 (Q, R, 3), c2 (Q, R, 3)) through kernel K7's
    coordinate form (``kernels.nn.ring_top2_coords``; its plain version on a
    CPU tensor), masked candidates baked to BAKE_FAR."""
    return nn.ring_top2_coords(q_xyz.contiguous(),
                               nn.bake_mask(c_blocks, m_blocks).contiguous())


def _take_ring(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x (Q, R, ...) at the per-query ring r (Q,) → (Q, ...)."""
    index = r.reshape(-1, 1, *([1] * (x.ndim - 2))).expand(-1, 1, *x.shape[2:])
    return x.gather(1, index)[:, 0]


class EdgeAssocCoords(NamedTuple):
    a: torch.Tensor      # (Q, 3) nearest neighbour
    b: torch.Tensor      # (Q, 3) nearest on a different ring within the window
    valid: torch.Tensor


class PlaneAssocCoords(NamedTuple):
    j: torch.Tensor      # nearest
    l: torch.Tensor      # same-ring runner-up
    m: torch.Tensor      # different-ring nearest within the window
    valid: torch.Tensor


def associate_edges_coords(
    q_xyz: torch.Tensor,
    q_mask: torch.Tensor,
    c_blocks: torch.Tensor,
    m_blocks: torch.Tensor,
    *,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> EdgeAssocCoords:
    """Corner association (≡ laserOdometry.cpp:384-465): queries (Q, 3)
    against ring-major candidates (R, B, 3) with masks (R, B)."""
    out = nn.associate_kernel(q_xyz.contiguous(), nn.bake_mask(c_blocks, m_blocks),
                              nearby_scan=nearby_scan)
    valid = q_mask & (out[:, 9] < dist_sq_threshold) & (out[:, 11] < dist_sq_threshold)
    return EdgeAssocCoords(out[:, 0:3], out[:, 6:9], valid)


def associate_planes_coords(
    q_xyz: torch.Tensor,
    q_mask: torch.Tensor,
    c_blocks: torch.Tensor,
    m_blocks: torch.Tensor,
    *,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> PlaneAssocCoords:
    """Surf association (≡ laserOdometry.cpp:468-561), same inputs as
    ``associate_edges_coords``."""
    out = nn.associate_kernel(q_xyz.contiguous(), nn.bake_mask(c_blocks, m_blocks),
                              nearby_scan=nearby_scan)
    valid = (
        q_mask
        & (out[:, 9] < dist_sq_threshold)
        & (out[:, 10] < dist_sq_threshold)
        & (out[:, 11] < dist_sq_threshold)
    )
    return PlaneAssocCoords(out[:, 0:3], out[:, 3:6], out[:, 6:9], valid)


def associate_edges_coords_top2(q_xyz, q_mask, c_blocks, m_blocks, *,
                                dist_sq_threshold: float = 25.0,
                                nearby_scan: float = 2.5) -> EdgeAssocCoords:
    """``associate_edges_coords`` as the reference computes it off the TPU
    (its knn.py:347-361): the cross-ring selection over the per-ring top-2
    with coordinates of ``_ring_top2_with_coords`` (kernel K7)."""
    dist, c1, _ = _ring_top2_with_coords(q_xyz, c_blocks, m_blocks)
    r0, d0, r2, d2 = _ring_select(dist[:, :, 0], nearby_scan)
    valid = q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
    return EdgeAssocCoords(_take_ring(c1, r0), _take_ring(c1, r2), valid)


def associate_planes_coords_top2(q_xyz, q_mask, c_blocks, m_blocks, *,
                                 dist_sq_threshold: float = 25.0,
                                 nearby_scan: float = 2.5) -> PlaneAssocCoords:
    """``associate_planes_coords`` as the reference computes it off the TPU
    (its knn.py:387-408), over ``_ring_top2_with_coords`` (kernel K7)."""
    dist, c1, c2 = _ring_top2_with_coords(q_xyz, c_blocks, m_blocks)
    r0, d0, r3, d3 = _ring_select(dist[:, :, 0], nearby_scan)
    d2 = _take_ring(dist[:, :, 1], r0)
    valid = (q_mask & (d0 < dist_sq_threshold) & (d2 < dist_sq_threshold)
             & (d3 < dist_sq_threshold))
    return PlaneAssocCoords(_take_ring(c1, r0), _take_ring(c2, r0), _take_ring(c1, r3), valid)
