"""K9: the lidar front end's greedy feature selection, ``csrc/features.cu``.

Replaces no TPU kernel: the JAX package's selection is a ``lax.scan`` of
masked arg-max / arg-min steps (``lidar_visual_odometry_tpu/ops/features.py``)
that XLA compiles into its jitted program. Run eagerly, the same steps cost
about 17 launches each, 144 steps a frame at the defaults; the kernel makes
them one launch.

``select_features(curv, avail, reach_l, reach_r, count, *, n_sectors,
max_less_sharp, max_flat, edge_gate, surf_gate)`` takes the (R, W) float32
curvatures, the (R, W) bool availability, the (R, W) int32 suppression reaches
and the (R,) int32 ring counts, and returns ``corner_picks`` (R, S, K) int64,
``corner_ok`` (R, S, K) bool, ``flat_picks`` (R, S, F) int64, ``flat_ok``
(R, S, F) bool and ``corner_label`` (R, W) int8 (1 where an accepted corner
lies). A CPU tensor runs the plain version (``select_features_plain``, the
eager loop); a CUDA tensor launches the kernel, whose outputs equal the plain
version's bit for bit, or raises. The kernel takes W up to ``MAX_W`` (its ring
in shared memory, 9 bytes a point).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel by ``select_features`` since the last reset
launches = 0

#: the widest ring the kernel holds (``kMaxW`` in ``csrc/features.cu``)
MAX_W = 16384

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
             + [ctypes.c_void_p] * 6)


def sector_bounds(count: torch.Tensor, n_sectors: int, j: int):
    """Sector j of the span [5, count−6] (``scanRegistration.cpp:285-287``,
    integer division)."""
    span = torch.clamp(count - 11, min=0)
    sp = 5 + torch.div(span * j, n_sectors, rounding_mode="floor")
    ep = 5 + torch.div(span * (j + 1), n_sectors, rounding_mode="floor") - 1
    return sp, ep


def select_features_plain(curv, avail, reach_l, reach_r, count, *, n_sectors,
                          max_less_sharp, max_flat, edge_gate, surf_gate):
    """Plain PyTorch version: one masked arg-max (corners) or arg-min (flats)
    over the (R, W) plane a step, all rings at once. ``torch.argmax`` /
    ``argmin`` return the first extremum, as ``jnp`` does."""
    R, W = curv.shape
    dev = curv.device
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
    corner_picks, corner_ok, flat_picks, flat_ok = [], [], [], []
    corner_label = torch.zeros((R, W), dtype=torch.int8, device=dev)
    for j in range(n_sectors):
        sp, ep = sector_bounds(count, n_sectors, j)
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

    return (torch.stack(corner_picks, dim=1), torch.stack(corner_ok, dim=1),
            torch.stack(flat_picks, dim=1), torch.stack(flat_ok, dim=1), corner_label)


def _check(curv, avail, reach_l, reach_r, count, n_sectors, max_less_sharp, max_flat):
    if (curv.dtype is not torch.float32 or avail.dtype is not torch.bool
            or reach_l.dtype is not torch.int32 or reach_r.dtype is not torch.int32
            or count.dtype is not torch.int32):
        raise TypeError("select_features takes float32 curvatures, bool availability "
                        "and int32 reaches and counts")
    if curv.dim() != 2:
        raise ValueError(f"select_features takes (R, W) curvatures, got {tuple(curv.shape)}")
    R, W = curv.shape
    if any(t.shape != (R, W) for t in (avail, reach_l, reach_r)) or count.shape != (R,):
        shapes = [tuple(t.shape) for t in (avail, reach_l, reach_r, count)]
        raise ValueError(f"select_features: shapes {shapes} do not match curvatures {(R, W)}")
    tensors = (curv, avail, reach_l, reach_r, count)
    if not all(t.is_cuda and t.get_device() == curv.get_device() for t in tensors):
        raise ValueError("select_features: every tensor must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("select_features takes contiguous tensors")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"select_features takes 1 to {MAX_W} points a ring, got {W}")
    if min(n_sectors, max_less_sharp, max_flat) < 1:
        raise ValueError("select_features takes at least one sector, corner and flat a sector")


def select_features(curv, avail, reach_l, reach_r, count, *, n_sectors, max_less_sharp,
                    max_flat, edge_gate, surf_gate):
    """The greedy picks of every ring: in one kernel launch on the card, by
    ``select_features_plain`` on the CPU (see the module's docstring)."""
    kw = dict(n_sectors=n_sectors, max_less_sharp=max_less_sharp, max_flat=max_flat,
              edge_gate=edge_gate, surf_gate=surf_gate)
    if curv.is_cpu:
        return select_features_plain(curv, avail, reach_l, reach_r, count, **kw)
    _check(curv, avail, reach_l, reach_r, count, n_sectors, max_less_sharp, max_flat)
    return _launch(curv, avail, reach_l, reach_r, count, **kw)


def _launch(curv, avail, reach_l, reach_r, count, *, n_sectors, max_less_sharp, max_flat,
            edge_gate, surf_gate):
    """Launch the kernel on checked tensors into freshly allocated outputs
    (the kernel writes every element of each)."""
    global launches
    R, W = curv.shape
    dev = curv.device
    corner_picks = torch.empty((R, n_sectors, max_less_sharp), dtype=torch.int64, device=dev)
    corner_ok = torch.empty((R, n_sectors, max_less_sharp), dtype=torch.bool, device=dev)
    flat_picks = torch.empty((R, n_sectors, max_flat), dtype=torch.int64, device=dev)
    flat_ok = torch.empty((R, n_sectors, max_flat), dtype=torch.bool, device=dev)
    corner_label = torch.empty((R, W), dtype=torch.int8, device=dev)
    fn = _build.launcher("features", "lvo_select_features", _ARGTYPES)
    rc = fn(curv.data_ptr(), avail.data_ptr(), reach_l.data_ptr(), reach_r.data_ptr(),
            count.data_ptr(), R, W, n_sectors, max_less_sharp, max_flat, edge_gate, surf_gate,
            corner_picks.data_ptr(), corner_ok.data_ptr(), flat_picks.data_ptr(),
            flat_ok.data_ptr(), corner_label.data_ptr(), _build.stream(curv))
    _build.check(rc, "select_features")
    launches += 1
    return corner_picks, corner_ok, flat_picks, flat_ok, corner_label
