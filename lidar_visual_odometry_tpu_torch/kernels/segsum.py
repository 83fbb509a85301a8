"""K1: segment sums, the counterpart of ``ops/pallas_segsum.py``.

``segment_sum_batched(seg_id, vals, n_segments=S)`` computes
``out[r, c, s] = sum over w with seg_id[r, w] == s of vals[r, c, w]``;
``segment_sum(seg_id, vals, n_segments=S)`` is its flat form (``seg_id`` (W,),
``vals`` (C, W) → (C, S)), which the mapping voxel filter uses. A CUDA tensor
goes to the hand-written kernel ``csrc/segsum.cu``; a CPU tensor goes to the
plain version (``segment_sum_batched_plain``, ``segment_sum_plain``). Ids
outside ``[0, S)`` are dropped by both. Each wrapper counts its own launches.
On ids that never decrease along a row, as the voxel filters give them, the
card's sums equal ``segment_sum_run_order``'s bit for bit; ids in another
order take the kernel's slower general path, which adds in ascending w.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel by ``segment_sum_batched`` since the last reset
launches = 0
#: launches of the CUDA kernel by the flat ``segment_sum`` since the last reset
flat_launches = 0

#: the flat sum adds a run in pieces cut at multiples of FLAT_PIECE points of
#: W, each piece in the lane order, the pieces in turn: the order of the
#: earlier kernel, which summed rows of 2048 points and then added the row
#: partials. Kept so that the mapping path's voxel centroids, and so its
#: trajectory, stay bit for bit what they were. The kernel's own constant is
#: ``kFlatPiece`` in ``csrc/segsum.cu``.
FLAT_PIECE = 2048

#: the C launchers of ``csrc/segsum.cu`` by name, with the count of their int
#: arguments between the three pointers and the stream
_N_INTS = {"lvo_segment_sum_batched": 4, "lvo_segment_sum_flat": 3}
_fns: dict[str, object] = {}


def _launcher(name: str):
    """The C launcher ``name`` of ``csrc/segsum.cu`` with its ctypes
    signature, set once."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("segsum"), name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * _N_INTS[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device as a raw handle (without
    building a ``torch.cuda.Stream``, which costs more host time than the
    kernel)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
    if seg_id.dtype is not torch.int32 or vals.dtype is not torch.float32:
        raise TypeError(f"{name} takes int32 ids and float32 values")
    if not (seg_id.is_cuda and vals.is_cuda) or vals.get_device() != seg_id.get_device():
        raise ValueError(f"{name}: both tensors must be on one CUDA device")
    if not (seg_id.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if C > 8:
        raise ValueError(f"{name} takes at most 8 channels, got {C}")


def segment_sum_batched(
    seg_id: torch.Tensor, vals: torch.Tensor, *, n_segments: int
) -> torch.Tensor:
    """(R, W) int32 ids, (R, C, W) float32 values → (R, C, n_segments)."""
    if seg_id.is_cpu:
        return segment_sum_batched_plain(seg_id, vals, n_segments=n_segments)
    global launches
    R, W = seg_id.shape
    if vals.dim() != 3 or vals.shape[0] != R or vals.shape[2] != W:
        raise ValueError(f"vals {tuple(vals.shape)} does not match seg_id {(R, W)}")
    C = vals.shape[1]
    _check("segment_sum_batched", seg_id, vals, C)
    out = vals.new_empty((R, C, n_segments))
    rc = _launcher("lvo_segment_sum_batched")(
        seg_id.data_ptr(), vals.data_ptr(), out.data_ptr(), R, C, W, n_segments, _stream(vals))
    _build.check(rc, "segment_sum_batched")
    launches += 1
    return out


def segment_sum_plain(seg_id: torch.Tensor, vals: torch.Tensor, *,
                      n_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the flat sum: one scatter-add."""
    return segment_sum_batched_plain(seg_id[None], vals[None], n_segments=n_segments)[0]


def segment_sum(seg_id: torch.Tensor, vals: torch.Tensor, *,
                n_segments: int) -> torch.Tensor:
    """(W,) int32 ids, (C, W) float32 values → (C, n_segments), in one
    kernel launch on the card (runs added in pieces of ``FLAT_PIECE``)."""
    if seg_id.is_cpu:
        return segment_sum_plain(seg_id, vals, n_segments=n_segments)
    global flat_launches
    (W,) = seg_id.shape
    if vals.dim() != 2 or vals.shape[1] != W:
        raise ValueError(f"vals {tuple(vals.shape)} does not match seg_id {(W,)}")
    C = vals.shape[0]
    _check("segment_sum", seg_id, vals, C)
    out = vals.new_empty((C, n_segments))
    rc = _launcher("lvo_segment_sum_flat")(
        seg_id.data_ptr(), vals.data_ptr(), out.data_ptr(), C, W, n_segments, _stream(vals))
    _build.check(rc, "segment_sum")
    flat_launches += 1
    return out


def segment_sum_run_order(seg_id: torch.Tensor, vals: torch.Tensor, *,
                          n_segments: int) -> torch.Tensor:
    """The kernel's sums in the kernel's order, for ids that never decrease
    along a row: (R, W) ids and (R, C, W) values → (R, C, n_segments) as
    ``segment_sum_batched`` adds them, or the flat (W,) and (C, W) →
    (C, n_segments) as ``segment_sum`` does.

    In each run of equal ids, lane ``l`` adds the run's positions ``l, l+32,
    l+64, …`` in ascending order from +0.0; the 32 lane sums are then reduced
    by the butterfly of offsets 16, 8, 4, 2, 1 (after the step of offset
    ``o`` lane ``l < o`` holds ``a[l] + a[l + o]``), and lane 0 is the sum.
    The flat form first cuts each run at multiples of ``FLAT_PIECE`` points,
    sums each piece so, and adds the pieces in turn. Ids outside
    ``[0, n_segments)`` are dropped. No path calls this: it is the reference
    that the card checks hold both kernel forms to, bit for bit."""
    flat = seg_id.dim() == 1
    if flat:
        seg_id, vals = seg_id[None], vals[None]
    R, C, W = vals.shape
    if bool((seg_id[:, 1:] < seg_id[:, :-1]).any()):
        raise ValueError("segment_sum_run_order takes ids that never decrease along a row")
    piece = FLAT_PIECE if flat else W
    dev = seg_id.device
    w = torch.arange(W, device=dev).expand(R, W)
    run_start = torch.ones((R, W), dtype=torch.bool, device=dev)
    run_start[:, 1:] = seg_id[:, 1:] != seg_id[:, :-1]
    piece_start = run_start | (w % piece == 0)
    pos = w - torch.cummax(torch.where(piece_start, w, 0), dim=1).values
    piece_no = torch.cumsum(piece_start, dim=1) - 1          # per row
    rank = piece_no - torch.cummax(torch.where(run_start, piece_no, 0), dim=1).values
    r_i, w_i = torch.nonzero((seg_id >= 0) & (seg_id < n_segments), as_tuple=True)
    p_i = piece_no[r_i, w_i]
    lane_i, step_i = pos[r_i, w_i] % 32, pos[r_i, w_i] // 32
    lanes = torch.zeros((R, int(piece_no.max()) + 1, 32, C), dtype=vals.dtype, device=dev)
    for step in range(int(step_i.max()) + 1 if len(step_i) else 0):
        m = step_i == step            # one position per (piece, lane): one add each
        r, p, lane = r_i[m], p_i[m], lane_i[m]
        lanes[r, p, lane] = lanes[r, p, lane] + vals[r, :, w_i[m]]
    for o in (16, 8, 4, 2, 1):
        lanes[:, :, :o] = lanes[:, :, :o] + lanes[:, :, o:2 * o]
    # each piece's sum into its segment, the pieces of a run in turn
    r_i, w_i = torch.nonzero(piece_start & (seg_id >= 0) & (seg_id < n_segments), as_tuple=True)
    s_i, p_i, rank_i = seg_id[r_i, w_i].to(torch.int64), piece_no[r_i, w_i], rank[r_i, w_i]
    out = torch.zeros((R, n_segments, C), dtype=vals.dtype, device=dev)
    for k in range(int(rank_i.max()) + 1 if len(rank_i) else 0):
        m = rank_i == k
        out[r_i[m], s_i[m]] = out[r_i[m], s_i[m]] + lanes[r_i[m], p_i[m], 0]
    out = out.permute(0, 2, 1).contiguous()
    return out[0] if flat else out
