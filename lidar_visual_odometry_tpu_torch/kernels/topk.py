"""K4, K5, K5p and K8: streaming k-nearest neighbours, the counterparts of
``ops/pallas_nn.py`` ``block_topk_windowed`` (K4), ``block_topk`` (K5, and
K5p with ``packed=True``) and ``block_topk_coords`` (K8).

``block_topk_windowed(q, q_keys, c_sorted, c_keys)`` and ``block_topk(q,
c_baked)`` return ``(dist (Q, k), index (Q, k))``: per query the k smallest
(squared distance, index) pairs in that order, ties to the lower index, with
distance 1e30 and index 0 in slots no candidate filled. Distances are
``(dx·dx + dy·dy) + dz·dz``, each product and sum rounded on its own.

The windowed form reads a candidate chunk of ``c_tile`` points for a query
tile of ``q_tile`` points only when the chunk's cell-key range meets the
tile's range widened by ``grid_w + 1`` (the 3×3 cell neighbourhood of every
key in the tile). It is exact for every neighbour within one cell; beyond
that a slot may hold the sentinel. ``cell_keys`` and ``sort_by_cell`` build
its inputs.

``block_topk_coords(q, c_baked)`` returns ``(dist (Q, k), coords (Q, k, 3))``:
K5's slots with their candidates' coordinates; a distance above 1e29 reads
exactly 1e30, and a slot no candidate filled has zero coordinates.

``block_topk(q, c_baked, packed=True)`` orders by the int32 key
``(bits(d) & ~0x7FFF) | index``: the distance cut to 2⁻⁸ relative, ties of
the cut distance to the lower index. It returns the cut distance
``bits(key & ~0x7FFF)`` and ``key & 0x7FFF``; an unfilled slot holds the key
``PACKED_SENTINEL``. The index must fit the 15 low bits: with C > 32768 the
call is the unpacked one (K5, launched and counted as K5), as in the
reference.

The TPU kernels' ``q_tile`` and ``c_tile`` of the dense forms (and their
divisibility asserts) do not change the result and are not taken. (One
exception, a degenerate input: with fewer candidates than k in several chunks
the TPU's K8 may leave a real candidate's coordinates in an unfilled slot, and
its K5p returns INT_MAX keys, NaN distances, from the second unfilled slot on;
the port's unfilled slots are zero and ``PACKED_SENTINEL``.)

A CUDA tensor goes to the hand-written kernels of ``csrc/topk.cu`` (the
dense forms to one launch of ``topk_kernel``, a thread-block cluster a group
of queries; the windowed form to a pair of its own, a range pre-pass and the
search: two launches, counted as one call); a CPU tensor goes to the plain version
(``block_topk_windowed_plain`` applies the same (tile, chunk) rule, so the two
agree element by element). Each wrapper counts its calls that launch, K5p
apart from K5.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .nn import bake_mask

_BIG = 1e30
_FAR = float(np.float32(1e29))   # K8: a slot's distance above this reads 1e30
_IMAX = 2**31 - 1
_LOW = 0x7FFF                    # K5p: the index bits of a packed key
#: K5p: the key of a slot no candidate filled, a packed 1e30
PACKED_SENTINEL = int((np.float32(1e30).view(np.int32) & ~_LOW) | _LOW)
#: K5p: the most candidates a packed key can index
PACKED_MAX_C = _LOW + 1
_Q_BLOCK = 256  # plain dense version: queries per distance block

#: launches of the CUDA kernel by ``block_topk`` since the last reset
launches = 0
#: launches of the CUDA kernel by ``block_topk_windowed`` since the last reset
windowed_launches = 0
#: launches of the CUDA kernel by ``block_topk(packed=True)`` since the last reset
packed_launches = 0
#: launches of the CUDA kernel by ``block_topk_coords`` since the last reset
coords_launches = 0


def cell_keys(xyz: torch.Tensor, origin: torch.Tensor, *, cell: float,
              grid_w: int) -> torch.Tensor:
    """Raster key ``kx·W + ky`` of the 2D coarse cell grid anchored at
    ``origin`` (xy, (2,)). Points outside the grid clamp to its edge cells, on
    both sides alike. The cell index is a product with the float32 ``1/cell``,
    as in the reference."""
    inv = float(np.float32(1.0) / np.float32(cell))
    kx = torch.clamp(torch.floor((xyz[:, 0] - origin[0]) * inv).to(torch.int32), 0, grid_w - 1)
    ky = torch.clamp(torch.floor((xyz[:, 1] - origin[1]) * inv).to(torch.int32), 0, grid_w - 1)
    return kx * grid_w + ky


def sort_by_cell(xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor, *,
                 cell: float, grid_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bake and sort a candidate cloud by cell key for ``block_topk_windowed``:
    (sorted baked xyz (C, 3), sorted keys (C,)). Masked points get key
    INT32_MAX (last, never in a query window) and BAKE_FAR coordinates. The
    sort is stable; the reference's is not, so points of equal key may sit
    in another order (the same coordinates, other indices)."""
    baked = bake_mask(xyz, mask)
    keys = torch.where(mask, cell_keys(baked, origin, cell=cell, grid_w=grid_w),
                       torch.full_like(mask, _IMAX, dtype=torch.int32))
    keys_s, order = torch.sort(keys, stable=True)
    return baked[order].contiguous(), keys_s.contiguous()


def _sqdist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q, 3) × (n, 3) → (Q, n) as ((dx·dx + dy·dy) + dz·dz), one rounding
    per operation, as the kernel computes it."""
    d = q[:, None, 0] - c[None, :, 0]
    d.mul_(d)
    t = q[:, None, 1] - c[None, :, 1]
    d.add_(t.mul_(t))
    t = torch.sub(q[:, None, 2], c[None, :, 2], out=t)
    d.add_(t.mul_(t))
    return d


def _smallest(d: torch.Tensor, cand: torch.Tensor, k: int):
    """The k smallest of each row by (distance, position); ``cand`` maps a
    position to its candidate index (ascending). Short rows are filled with
    the sentinel."""
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((d.shape[0], pad), _BIG, dtype=d.dtype, device=d.device)], 1)
        cand = torch.cat([cand, torch.zeros(pad, dtype=cand.dtype, device=cand.device)])
    ds, order = torch.sort(d, dim=1, stable=True)
    ds, idx = ds[:, :k], cand[order[:, :k]]
    # a candidate no nearer than the sentinel loses to it, as in the kernel
    far = ~(ds < _BIG)
    return (torch.where(far, torch.full_like(ds, _BIG), ds),
            torch.where(far, torch.zeros_like(idx), idx))


def block_topk_plain(q_xyz: torch.Tensor, c_baked: torch.Tensor, *, k: int = 5):
    """Plain PyTorch version of the dense search (queries in blocks, so the
    distance block stays small)."""
    cand = torch.arange(c_baked.shape[0], dtype=torch.int32, device=q_xyz.device)
    ds, ii = [], []
    for i in range(0, q_xyz.shape[0], _Q_BLOCK):
        d, idx = _smallest(_sqdist(q_xyz[i:i + _Q_BLOCK], c_baked), cand, k)
        ds.append(d)
        ii.append(idx)
    return torch.cat(ds), torch.cat(ii)


def block_topk_coords_plain(q_xyz: torch.Tensor, c_baked: torch.Tensor, *, k: int = 5):
    """Plain PyTorch version of ``block_topk_coords``: the dense search, then
    the coordinates by index."""
    d, idx = block_topk_plain(q_xyz, c_baked, k=k)
    filled = (d < _BIG)[..., None]
    coords = torch.where(filled, c_baked[idx.long()], torch.zeros((), device=d.device))
    return torch.where(d > _FAR, torch.full_like(d, _BIG), d), coords


def block_topk_packed_plain(q_xyz: torch.Tensor, c_baked: torch.Tensor, *, k: int = 5):
    """Plain PyTorch version of ``block_topk(packed=True)`` (C ≤ 32768): the k
    smallest packed keys of each query, k sentinels standing in for unfilled
    slots."""
    cand = torch.arange(c_baked.shape[0], dtype=torch.int32, device=q_xyz.device)
    ds, ii = [], []
    for i in range(0, q_xyz.shape[0], _Q_BLOCK):
        d = _sqdist(q_xyz[i:i + _Q_BLOCK], c_baked)
        keys = (d.view(torch.int32) & ~_LOW) | cand
        keys = torch.cat([keys, torch.full((d.shape[0], k), PACKED_SENTINEL, dtype=torch.int32,
                                           device=d.device)], 1)
        keys = torch.sort(keys, dim=1).values[:, :k]
        ds.append((keys & ~_LOW).view(torch.float32))
        ii.append(keys & _LOW)
    return torch.cat(ds), torch.cat(ii)


def chunk_hits(q_keys: torch.Tensor, c_keys: torch.Tensor, *, q_tile: int, c_tile: int,
               grid_w: int) -> torch.Tensor:
    """(Q / q_tile, C / c_tile) bool: which candidate chunks each query tile
    reads (key ranges that meet, the tile's widened by grid_w + 1)."""
    reach = grid_w + 1
    qk = q_keys.to(torch.int64).reshape(-1, q_tile)
    ck = c_keys.to(torch.int64).reshape(-1, c_tile)
    qlo, qhi = qk.amin(1), qk.amax(1)
    clo, chi = ck.amin(1), ck.amax(1)
    return (clo[None, :] <= qhi[:, None] + reach) & (chi[None, :] >= qlo[:, None] - reach)


def block_topk_windowed_plain(q_xyz, q_keys, c_sorted, c_keys, *, k: int = 5,
                              q_tile: int = 256, c_tile: int = 512, grid_w: int = 256):
    """Plain PyTorch version with the kernel's (q_tile, c_tile) skip rule: each
    query tile searches the chunks ``chunk_hits`` gives it, in index order."""
    hits = chunk_hits(q_keys, c_keys, q_tile=q_tile, c_tile=c_tile, grid_w=grid_w)
    lane = torch.arange(c_tile, dtype=torch.int32, device=q_xyz.device)
    ds, ii = [], []
    for t in range(hits.shape[0]):
        q = q_xyz[t * q_tile:(t + 1) * q_tile]
        chunks = torch.nonzero(hits[t])[:, 0].to(torch.int32)
        cand = (chunks[:, None] * c_tile + lane[None, :]).reshape(-1)
        d, idx = _smallest(_sqdist(q, c_sorted[cand.to(torch.int64)]), cand, k)
        ds.append(d)
        ii.append(idx)
    return torch.cat(ds), torch.cat(ii)


#: the C launchers of ``csrc/topk.cu`` by name, with their ctypes argument types
_ARGTYPES = {
    "lvo_block_topk": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "lvo_block_topk_windowed": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}


def _launcher(name: str):
    return _build.launcher("topk", name, _ARGTYPES[name])


def _check_tensors(name, tensors, k):
    for t in tensors:
        if t.device != tensors[0].device or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if tensors[0].dtype != torch.float32 or tensors[1].dtype != torch.float32:
        raise TypeError(f"{name} takes float32 points")
    if not 1 <= k <= 8:
        raise ValueError(f"{name} takes 1 <= k <= 8, got {k}")


def _launch(name, q_xyz, c, k, packed=False, coords=False):
    """The dense forms (K5, K5p, K8): one launch of ``topk_kernel``. Its bulk
    copies read ``c`` from a 16-byte aligned address: a view that starts
    elsewhere is copied first."""
    _check_tensors(name, (q_xyz, c), k)
    if c.data_ptr() % 16:
        c = c.clone()
    Q, C = q_xyz.shape[0], c.shape[0]
    d = torch.empty((Q, k), dtype=torch.float32, device=q_xyz.device)
    if coords:
        out = torch.empty((Q, k, 3), dtype=torch.float32, device=q_xyz.device)
        ptrs = (None, out.data_ptr())
    else:
        out = torch.empty((Q, k), dtype=torch.int32, device=q_xyz.device)
        ptrs = (out.data_ptr(), None)
    rc = _launcher("lvo_block_topk")(
        q_xyz.data_ptr(), c.data_ptr(), d.data_ptr(), *ptrs, Q, C, k, int(packed),
        _build.stream(q_xyz))
    _build.check(rc, name)
    return d, out


def _launch_windowed(q_xyz, q_keys, c, c_keys, k, q_tile, c_tile, reach):
    """K4: the range pre-pass and the windowed search, two launches on the
    stream, with the pre-pass's (C / c_tile + Q / q_tile) int2 ranges in a
    scratch tensor of the caller's stream."""
    name = "block_topk_windowed"
    _check_tensors(name, (q_xyz, c, q_keys, c_keys), k)
    if q_keys.dtype != torch.int32 or c_keys.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 keys")
    Q, C = q_xyz.shape[0], c.shape[0]
    dev = q_xyz.device
    ranges = torch.empty((C // c_tile + Q // q_tile, 2), dtype=torch.int32, device=dev)
    d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    rc = _launcher("lvo_block_topk_windowed")(
        q_xyz.data_ptr(), q_keys.data_ptr(), c.data_ptr(), c_keys.data_ptr(), ranges.data_ptr(),
        d.data_ptr(), i.data_ptr(), Q, C, k, q_tile, c_tile, reach,
        _build.stream(q_xyz))
    _build.check(rc, name)
    return d, i


def _check_points(name, q_xyz, c):
    for t in (q_xyz, c):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} takes (n, 3) points, got {tuple(t.shape)}")


def block_topk_windowed(q_xyz: torch.Tensor, q_keys: torch.Tensor, c_sorted: torch.Tensor,
                        c_keys: torch.Tensor, *, k: int = 5, q_tile: int = 256,
                        c_tile: int = 512, grid_w: int = 256):
    """Cell-windowed k-NN: (dist (Q, k), index (Q, k)) into ``c_sorted``.

    q_xyz (Q, 3) with its keys (Q,) int32 (sorted by key, for efficiency
    only); c_sorted (C, 3) baked and sorted by key, c_keys (C,) int32.
    Q % q_tile == 0 and C % c_tile == 0."""
    _check_points("block_topk_windowed", q_xyz, c_sorted)
    Q, C = q_xyz.shape[0], c_sorted.shape[0]
    if Q % q_tile or C % c_tile or q_keys.shape != (Q,) or c_keys.shape != (C,):
        raise ValueError(f"block_topk_windowed: Q {Q} must divide by q_tile {q_tile}, "
                         f"C {C} by c_tile {c_tile}, with one key per point")
    kw = dict(k=k, q_tile=q_tile, c_tile=c_tile, grid_w=grid_w)
    if q_xyz.device.type == "cpu":
        return block_topk_windowed_plain(q_xyz, q_keys, c_sorted, c_keys, **kw)
    global windowed_launches
    out = _launch_windowed(q_xyz, q_keys, c_sorted, c_keys, k, q_tile, c_tile, grid_w + 1)
    windowed_launches += 1
    return out


def block_topk(q_xyz: torch.Tensor, c_baked: torch.Tensor, *, k: int = 5,
               packed: bool = False):
    """Dense k-NN: (dist (Q, k), index (Q, k)) into ``c_baked`` (C, 3), masked
    points baked to BAKE_FAR. Any Q and C. ``packed=True`` orders by the
    packed key (module note) when C ≤ 32768 and is ignored above."""
    _check_points("block_topk", q_xyz, c_baked)
    packed = packed and c_baked.shape[0] <= PACKED_MAX_C   # the index must fit 15 bits
    if q_xyz.device.type == "cpu":
        return (block_topk_packed_plain if packed else block_topk_plain)(q_xyz, c_baked, k=k)
    global launches, packed_launches
    out = _launch("block_topk", q_xyz, c_baked, k, packed=packed)
    if packed:
        packed_launches += 1
    else:
        launches += 1
    return out


def block_topk_coords(q_xyz: torch.Tensor, c_baked: torch.Tensor, *, k: int = 5):
    """Dense k-NN with coordinates: (dist (Q, k), coords (Q, k, 3)) from
    ``c_baked`` (C, 3), masked points baked to BAKE_FAR. Any Q and C."""
    _check_points("block_topk_coords", q_xyz, c_baked)
    if q_xyz.device.type == "cpu":
        return block_topk_coords_plain(q_xyz, c_baked, k=k)
    global coords_launches
    out = _launch("block_topk_coords", q_xyz, c_baked, k, coords=True)
    coords_launches += 1
    return out
