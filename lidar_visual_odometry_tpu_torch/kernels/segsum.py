"""K1: segment sums, the counterpart of ``ops/pallas_segsum.py``.

``segment_sum_batched(seg_id, vals, n_segments=S)`` computes
``out[r, c, s] = sum over w with seg_id[r, w] == s of vals[r, c, w]``;
``segment_sum(seg_id, vals, n_segments=S)`` is its flat form (``seg_id`` (W,),
``vals`` (C, W) → (C, S)), which the mapping voxel filter uses. A CUDA tensor
goes to the hand-written kernel ``csrc/segsum.cu``; a CPU tensor goes to the
plain version (``segment_sum_batched_plain``, ``segment_sum_plain``). Ids
outside ``[0, S)`` are dropped by both. Each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel by ``segment_sum_batched`` since the last reset
launches = 0
#: launches of the CUDA kernel by the flat ``segment_sum`` since the last reset
flat_launches = 0

#: points per row of the flat sum. Each row is one block of the kernel's
#: sorted-run path, whose cost per block is mostly S-wide (the start table of
#: S + 1 entries and the warp-per-segment loop) whatever the row width, so
#: rows are wide; 2048 still gives the mapping path's W 32768 sixteen blocks,
#: and keeps the (rows, C, S) partials at 1 MB for S 4097. A row's staged ids
#: and start table take (2048 + 4098) × 4 B = 24 KB of shared memory.
FLAT_ROW = 2048


def segment_sum_batched_plain(
    seg_id: torch.Tensor, vals: torch.Tensor, *, n_segments: int
) -> torch.Tensor:
    """Plain PyTorch version: one scatter-add along the point axis."""
    R, C, W = vals.shape
    ok = (seg_id >= 0) & (seg_id < n_segments)
    idx = torch.where(ok, seg_id, n_segments).to(torch.int64)
    out = torch.zeros((R, C, n_segments + 1), dtype=vals.dtype, device=vals.device)
    out.scatter_add_(2, idx[:, None, :].expand(R, C, W), vals)
    return out[:, :, :n_segments]


def _check(name, seg_id, vals, C):
    if seg_id.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 ids and float32 values")
    if vals.device != seg_id.device or seg_id.device.type != "cuda":
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if not (seg_id.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if C > 8:
        raise ValueError(f"{name} takes at most 8 channels, got {C}")


def segment_sum_batched(
    seg_id: torch.Tensor, vals: torch.Tensor, *, n_segments: int
) -> torch.Tensor:
    """(R, W) int32 ids, (R, C, W) float32 values → (R, C, n_segments)."""
    if seg_id.device.type == "cpu":
        return segment_sum_batched_plain(seg_id, vals, n_segments=n_segments)
    global launches
    R, W = seg_id.shape
    if vals.dim() != 3 or vals.shape[0] != R or vals.shape[2] != W:
        raise ValueError(f"vals {tuple(vals.shape)} does not match seg_id {(R, W)}")
    C = vals.shape[1]
    _check("segment_sum_batched", seg_id, vals, C)
    lib = _build.load("segsum")
    fn = lib.lvo_segment_sum_batched
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((R, C, n_segments), dtype=torch.float32, device=vals.device)
    rc = fn(seg_id.data_ptr(), vals.data_ptr(), out.data_ptr(), R, C, W, n_segments,
            torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(rc, "segment_sum_batched")
    launches += 1
    return out


def segment_sum_plain(seg_id: torch.Tensor, vals: torch.Tensor, *,
                      n_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the flat sum: one scatter-add."""
    return segment_sum_batched_plain(seg_id[None], vals[None], n_segments=n_segments)[0]


def segment_sum(seg_id: torch.Tensor, vals: torch.Tensor, *,
                n_segments: int) -> torch.Tensor:
    """(W,) int32 ids, (C, W) float32 values → (C, n_segments).

    On the card the point axis is cut into rows of ``FLAT_ROW`` points (the
    last one short), one kernel launch sums every row, and the row partials
    are added here, in row order."""
    if seg_id.device.type == "cpu":
        return segment_sum_plain(seg_id, vals, n_segments=n_segments)
    global flat_launches
    (W,) = seg_id.shape
    if vals.dim() != 2 or vals.shape[1] != W:
        raise ValueError(f"vals {tuple(vals.shape)} does not match seg_id {(W,)}")
    C = vals.shape[0]
    _check("segment_sum", seg_id, vals, C)
    lib = _build.load("segsum")
    fn = lib.lvo_segment_sum_flat
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    R = -(-W // FLAT_ROW)
    partials = torch.empty((R, C, n_segments), dtype=torch.float32, device=vals.device)
    rc = fn(seg_id.data_ptr(), vals.data_ptr(), partials.data_ptr(), C, W, FLAT_ROW,
            n_segments, torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(rc, "segment_sum")
    flat_launches += 1
    return partials.sum(dim=0)
