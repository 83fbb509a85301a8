"""K1: batched segment sum, the counterpart of ``ops/pallas_segsum.py``.

``segment_sum_batched(seg_id, vals, n_segments=S)`` computes
``out[r, c, s] = sum over w with seg_id[r, w] == s of vals[r, c, w]``. A CUDA
tensor goes to the hand-written kernel ``csrc/segsum.cu``; a CPU tensor goes to
``segment_sum_batched_plain``. Ids outside ``[0, S)`` are dropped by both.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset
launches = 0


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
    if seg_id.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("segment_sum_batched takes int32 ids and float32 values")
    if vals.device != seg_id.device or seg_id.device.type != "cuda":
        raise ValueError("segment_sum_batched: both tensors must be on one CUDA device")
    if not (seg_id.is_contiguous() and vals.is_contiguous()):
        raise ValueError("segment_sum_batched takes contiguous tensors")
    if C > 8:
        raise ValueError(f"segment_sum_batched takes at most 8 channels, got {C}")
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
