"""K2: ring-structured association, the counterpart of ``ops/pallas_nn.py``.

``associate_kernel(q_xyz, c_blocks_baked, nearby_scan=...)`` returns (Q, 16)
float32 rows ``[c1r0 3 | c2r0 3 | c1rw 3 | d0 | d2same | dw | 0 0 0 0]``: the
nearest candidate overall (ring r0), r0's runner-up, and the nearest candidate
on a ring rw with ``0 < |rw - r0| <= nearby_scan`` (zero when no ring is in that
window), then their squared distances. A CUDA tensor goes to the hand-written
kernel ``csrc/nn.cu``; a CPU tensor goes to ``associate_kernel_plain``.

Candidates that are masked out must first be moved to ``BAKE_FAR`` with
``bake_mask``, so that they can never be nearest. The TPU kernel's padding of
B to 128 lanes is not needed here: any B works.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

BAKE_FAR = 1e6  # masked candidates are moved here (distance² ≈ 1e12)
_BIG = 1e30
_Q_BLOCK = 64  # plain version: queries per (Q, R, B) distance block

#: launches of the CUDA kernel since the last reset
launches = 0


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


def _associate_block(q_xyz, c_blocks_baked, nearby_scan):
    Q = q_xyz.shape[0]
    R, B, _ = c_blocks_baked.shape
    c = c_blocks_baked
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
    del d
    i1, d1, i2, d2 = i1[..., 0], d1[..., 0], i2[..., 0], d2[..., 0]   # (Q, R)

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


def associate_kernel(
    q_xyz: torch.Tensor, c_blocks_baked: torch.Tensor, *, nearby_scan: float = 2.5
) -> torch.Tensor:
    """(Q, 3) queries, (R, B, 3) baked candidates → (Q, 16) rows."""
    if q_xyz.device.type == "cpu":
        return associate_kernel_plain(q_xyz, c_blocks_baked, nearby_scan=nearby_scan)
    global launches
    if q_xyz.dim() != 2 or q_xyz.shape[1] != 3:
        raise ValueError(f"q_xyz must be (Q, 3), got {tuple(q_xyz.shape)}")
    if c_blocks_baked.dim() != 3 or c_blocks_baked.shape[2] != 3:
        raise ValueError(f"c_blocks_baked must be (R, B, 3), got {tuple(c_blocks_baked.shape)}")
    if q_xyz.dtype != torch.float32 or c_blocks_baked.dtype != torch.float32:
        raise TypeError("associate_kernel takes float32 tensors")
    if c_blocks_baked.device != q_xyz.device or q_xyz.device.type != "cuda":
        raise ValueError("associate_kernel: both tensors must be on one CUDA device")
    if not (q_xyz.is_contiguous() and c_blocks_baked.is_contiguous()):
        raise ValueError("associate_kernel takes contiguous tensors")
    Q = q_xyz.shape[0]
    R, B, _ = c_blocks_baked.shape
    lib = _build.load("nn")
    fn = lib.lvo_associate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = torch.empty((4, R, Q), dtype=torch.float32, device=q_xyz.device)
    out = torch.empty((Q, 16), dtype=torch.float32, device=q_xyz.device)
    rc = fn(q_xyz.data_ptr(), c_blocks_baked.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), Q, R, B, float(nearby_scan),
            torch.cuda.current_stream(q_xyz.device).cuda_stream)
    _build.check(rc, "associate_kernel")
    launches += 1
    return out
