"""K2 and K7: ring-structured nearest neighbours, the counterparts of
``ops/pallas_nn.py`` ``associate_kernel`` (K2) and ``ring_top2_pallas`` /
``ring_top2_coords`` (K7, ``_ring_top2_kernel``).

``associate_kernel(q_xyz, c_blocks_baked, nearby_scan=...)`` returns (Q, 16)
float32 rows ``[c1r0 3 | c2r0 3 | c1rw 3 | d0 | d2same | dw | 0 0 0 0]``: the
nearest candidate overall (ring r0), r0's runner-up, and the nearest candidate
on a ring rw with ``0 < |rw - r0| <= nearby_scan`` (zero when no ring is in that
window), then their squared distances.

``ring_top2_pallas(q_xyz, c_blocks_baked)`` returns the two nearest candidates
of every (query, ring): dist (Q, R, 2) and idx (Q, R, 2) int32, flat into
R·B; ``ring_top2_coords`` returns dist (Q, R, 2) and their coordinates c1, c2
(Q, R, 3). Within a ring ties go to the first index; the runner-up is the
arg-min with the winner set to 1e30 (so with B = 1 it reads (1e30, the ring's
first index)).

Distances are ``(dx·dx + dy·dy) + dz·dz``, each operation rounded on its own.
A CUDA tensor goes to the hand-written kernels of ``csrc/nn.cu``; a CPU tensor
goes to the ``*_plain`` version. Each wrapper counts its launches, K7's two
output forms apart.

Candidates that are masked out must first be moved to ``BAKE_FAR`` with
``bake_mask``, so that they can never be nearest; they are ordinary far points
to every kernel. The TPU kernels' padding of B to 128 lanes is not needed
here: any B works for K7 (the card's kernel stages a ring larger than a
stage in pieces) and the plain versions; the card's K2 stages rings in
shared memory, which takes B up to 9,556 at R = 64 (beyond, its launch fails
and the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

BAKE_FAR = 1e6  # masked candidates are moved here (distance² ≈ 1e12)
_BIG = 1e30
_Q_BLOCK = 64  # plain version: queries per (Q, R, B) distance block

#: launches of the CUDA kernel of ``associate_kernel`` since the last reset
launches = 0
#: launches of K7 by ``ring_top2_pallas`` since the last reset
ring_top2_launches = 0
#: launches of K7 by ``ring_top2_coords`` since the last reset
ring_top2_coords_launches = 0


def bake_mask(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Move masked-out points to BAKE_FAR so they can never be nearest."""
    return torch.where(mask[..., None], xyz, torch.full_like(xyz, BAKE_FAR))


def associate_kernel_plain(
    q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor, *, nearby_scan: float = 2.5
) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rules: distance
    ((c−q)x² + (c−q)y²) + (c−q)z², first index on ties in a ring, first ring
    on ties across rings. Queries go in blocks so that the (queries, R, B)
    distance tensor stays small."""
    return torch.cat([
        _associate_block(q_xyz[i:i + _Q_BLOCK], c_blocks_baked, nearby_scan)
        for i in range(0, q_xyz.shape[0], _Q_BLOCK)
    ])


def _ring_top2_block(q_xyz, c):
    """Per (query, ring) of a query block: (i1, d1, i2, d2), each (Q, R)."""
    # d = (dx·dx + dy·dy) + dz·dz, each product and sum rounded on its own
    d = c[None, :, :, 0] - q_xyz[:, None, None, 0]            # (Q, R, B)
    d.mul_(d)
    t = c[None, :, :, 1] - q_xyz[:, None, None, 1]
    d.add_(t.mul_(t))
    t = torch.sub(c[None, :, :, 2], q_xyz[:, None, None, 2], out=t)
    d.add_(t.mul_(t))
    del t
    i1 = torch.argmin(d, dim=2, keepdim=True)                # (Q, R, 1)
    d1 = d.gather(2, i1)
    d.scatter_(2, i1, _BIG)                                   # the winner out
    i2 = torch.argmin(d, dim=2, keepdim=True)
    d2 = d.gather(2, i2)
    return i1[..., 0], d1[..., 0], i2[..., 0], d2[..., 0]


def _associate_block(q_xyz, c_blocks_baked, nearby_scan):
    Q = q_xyz.shape[0]
    R, B, _ = c_blocks_baked.shape
    c = c_blocks_baked
    i1, d1, i2, d2 = _ring_top2_block(q_xyz, c)               # (Q, R)

    r0 = torch.argmin(d1, dim=1, keepdim=True)               # (Q, 1)
    d0 = d1.gather(1, r0)
    d2same = d2.gather(1, r0)
    rows = torch.arange(R, device=q_xyz.device, dtype=torch.float32)[None, :]
    rdiff = (rows - r0.to(torch.float32)).abs()
    win = (rdiff > 0.0) & (rdiff <= nearby_scan)
    d1w = torch.where(win, d1, torch.full_like(d1, _BIG))
    rw = torch.argmin(d1w, dim=1, keepdim=True)
    dw = d1w.gather(1, rw)
    in_win = win.gather(1, rw)

    flat = c.reshape(R * B, 3)
    c1r0 = flat[(r0 * B + i1.gather(1, r0))[:, 0]]
    c2r0 = flat[(r0 * B + i2.gather(1, r0))[:, 0]]
    c1rw = flat[(rw * B + i1.gather(1, rw))[:, 0]]
    c1rw = torch.where(in_win, c1rw, torch.zeros_like(c1rw))
    pad = torch.zeros((Q, 4), dtype=torch.float32, device=q_xyz.device)
    return torch.cat([c1r0, c2r0, c1rw, d0, d2same, dw, pad], dim=1)


def ring_top2_pallas_plain(q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor):
    """Plain PyTorch version of ``ring_top2_pallas``, with the TPU kernel's
    rules (queries in blocks, as ``associate_kernel_plain``)."""
    R, B, _ = c_blocks_baked.shape
    parts = [_ring_top2_block(q_xyz[i:i + _Q_BLOCK], c_blocks_baked)
             for i in range(0, q_xyz.shape[0], _Q_BLOCK)]
    i1, d1, i2, d2 = (torch.cat(p) for p in zip(*parts))
    base = torch.arange(R, dtype=torch.int32, device=q_xyz.device)[None, :, None] * B
    idx = torch.stack([i1, i2], dim=-1).to(torch.int32) + base
    return torch.stack([d1, d2], dim=-1), idx


def ring_top2_coords_plain(q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor):
    """Plain PyTorch version of ``ring_top2_coords``: the winners'
    coordinates fetched by index."""
    dist, idx = ring_top2_pallas_plain(q_xyz, c_blocks_baked)
    flat = c_blocks_baked.reshape(-1, 3)
    return dist, flat[idx[..., 0].long()], flat[idx[..., 1].long()]


#: the C launchers of ``csrc/nn.cu`` by name, with their ctypes argument types
_ARGTYPES = {
    "lvo_associate": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                   ctypes.c_void_p],
    "lvo_ring_top2": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _launcher(name: str):
    return _build.launcher("nn", name, _ARGTYPES[name])


def _check(name, q_xyz, c_blocks_baked):
    if q_xyz.dim() != 2 or q_xyz.shape[1] != 3:
        raise ValueError(f"q_xyz must be (Q, 3), got {tuple(q_xyz.shape)}")
    if c_blocks_baked.dim() != 3 or c_blocks_baked.shape[2] != 3:
        raise ValueError(f"c_blocks_baked must be (R, B, 3), got {tuple(c_blocks_baked.shape)}")
    if q_xyz.dtype != torch.float32 or c_blocks_baked.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors")
    if c_blocks_baked.device != q_xyz.device or q_xyz.device.type != "cuda":
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if not (q_xyz.is_contiguous() and c_blocks_baked.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _ring_top2_launch(name, q_xyz, c_blocks_baked, coords):
    _check(name, q_xyz, c_blocks_baked)
    Q = q_xyz.shape[0]
    R, B, _ = c_blocks_baked.shape
    dev = q_xyz.device
    dist = torch.empty((Q, R, 2), dtype=torch.float32, device=dev)
    if coords:
        out = (torch.empty((Q, R, 3), dtype=torch.float32, device=dev),
               torch.empty((Q, R, 3), dtype=torch.float32, device=dev))
        ptrs = (None, out[0].data_ptr(), out[1].data_ptr())
    else:
        out = (torch.empty((Q, R, 2), dtype=torch.int32, device=dev),)
        ptrs = (out[0].data_ptr(), None, None)
    rc = _launcher("lvo_ring_top2")(q_xyz.data_ptr(), c_blocks_baked.data_ptr(),
                                    dist.data_ptr(), *ptrs, Q, R, B, _build.stream(q_xyz))
    _build.check(rc, name)
    return (dist,) + out


def ring_top2_pallas(q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor):
    """(Q, 3) queries, (R, B, 3) baked candidates → (dist (Q, R, 2),
    idx (Q, R, 2) int32 flat into R·B)."""
    if q_xyz.device.type == "cpu":
        return ring_top2_pallas_plain(q_xyz, c_blocks_baked)
    global ring_top2_launches
    out = _ring_top2_launch("ring_top2_pallas", q_xyz, c_blocks_baked, coords=False)
    ring_top2_launches += 1
    return out


def ring_top2_coords(q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor):
    """(Q, 3) queries, (R, B, 3) baked candidates → (dist (Q, R, 2),
    c1 (Q, R, 3), c2 (Q, R, 3))."""
    if q_xyz.device.type == "cpu":
        return ring_top2_coords_plain(q_xyz, c_blocks_baked)
    global ring_top2_coords_launches
    out = _ring_top2_launch("ring_top2_coords", q_xyz, c_blocks_baked, coords=True)
    ring_top2_coords_launches += 1
    return out


def associate_kernel(
    q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor, *, nearby_scan: float = 2.5
) -> torch.Tensor:
    """(Q, 3) queries, (R, B, 3) baked candidates → (Q, 16) rows."""
    if q_xyz.device.type == "cpu":
        return associate_kernel_plain(q_xyz, c_blocks_baked, nearby_scan=nearby_scan)
    global launches
    _check("associate_kernel", q_xyz, c_blocks_baked)
    Q = q_xyz.shape[0]
    R, B, _ = c_blocks_baked.shape
    out = torch.empty((Q, 16), dtype=torch.float32, device=q_xyz.device)
    rc = _launcher("lvo_associate")(q_xyz.data_ptr(), c_blocks_baked.data_ptr(), out.data_ptr(),
                                    Q, R, B, float(nearby_scan), _build.stream(q_xyz))
    _build.check(rc, "associate_kernel")
    launches += 1
    return out
