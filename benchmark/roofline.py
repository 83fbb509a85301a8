"""Peaks of the card and the least time each CUDA kernel of the path could
take, from the call's shapes.

A kernel's work is what its task needs, whatever implements it: each input
read once and each output written once, taken from the shapes that the
configuration fixes; operations counted only where the shapes fix them
(never the pairs that a search happens to visit). The bound of a call is
max(bytes / peak bandwidth, operations / peak float32 rate); a kernel's
roofline share is the sum of its calls' bounds over their summed device
time, so it cannot pass 100% unless the counts are too high."""

from __future__ import annotations

# Published dense peaks at the full power limit (NVIDIA data sheets):
# (HBM bytes/s, float32 FLOP/s outside the tensor cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
}

F32 = I32 = 4


def peaks(device_name: str):
    """(bytes/s, FLOP/s) of the card, or None for a card not in the table."""
    return PEAKS.get(device_name)


def bound_s(n_bytes: float, n_ops: float, device_name: str):
    pk = peaks(device_name)
    if pk is None:
        return None
    return max(n_bytes / pk[0], n_ops / pk[1])


def segsum_rows_calls(s: dict) -> list:
    """K1 rows, one call a frame: the per-ring less-flat voxel filter's sums
    (segment ids (R, W) int32, values (R, 4, W), sums (R, 4, S))."""
    L = s["lidar"]
    R, W = L["n_scans"], L["azimuth_bins"]
    S = L["max_less_flat"] // R + 1
    return [(R * W * I32 + R * 4 * W * F32 + R * 4 * S * F32, R * 4 * W)]


def segsum_flat_calls(s: dict) -> list:
    """K1 flat, two calls a mapped frame: the corner and surf voxel filters
    at the mapping leaves (ids (N,), values (4, N), sums (4, slot + 1))."""
    L, M = s["lidar"], s["mapping"]
    nc = L["n_scans"] * L["n_sectors"] * L["max_less_sharp_per_sector"]
    ns = L["max_less_flat"]
    return [(n * I32 + 4 * n * F32 + 4 * (slot + 1) * F32, 4 * n)
            for n, slot in ((nc, M["corner_slot"]), (ns, M["surf_slot"]))]


def associate_calls(s: dict) -> list:
    """K2, two calls an odometry round: corners against the last less-sharp
    cloud, flats against the last less-flat cloud (queries (Q, 3),
    candidates (R, B, 3), rows (Q, 16)). A nearest-neighbour search's
    operations depend on how it prunes, so bytes alone count."""
    L = s["lidar"]
    R, S = L["n_scans"], L["n_sectors"]
    calls = []
    for q, b in ((R * S * L["max_sharp_per_sector"], S * L["max_less_sharp_per_sector"]),
                 (R * S * L["max_flat_per_sector"], L["max_less_flat"] // R)):
        calls.append(((q * 3 + R * b * 3 + q * 16) * F32, 0))
    return calls


def gn_calls(s: dict) -> list:
    """K3, one call an odometry round: ``gn_iters`` Gauss-Newton iterations
    over the round's correspondences (edge rows p, a, b and weights; plane
    rows p, j, l, m and weights; the pose in and out). Operations: the
    normal equations alone, 21 + 6 multiply-adds a residual row (three a
    corner, one a flat) an iteration."""
    L, O = s["lidar"], s["odometry"]
    R, S = L["n_scans"], L["n_sectors"]
    ne, np_ = R * S * L["max_sharp_per_sector"], R * S * L["max_flat_per_sector"]
    n_bytes = (7 + 10 * ne + 13 * np_ + 8) * F32
    return [(n_bytes, O["gn_iters"] * (3 * ne + np_) * 54)]


def topk_windowed_calls(s: dict) -> list:
    """K4 (range pre-pass and search together), two calls a mapping round:
    corner and surf queries (Q, 3) and keys against the cell-sorted map
    (C, 3) and keys, k nearest (Q, k) distances and indices. Counted by
    bytes: the pairs a window reads depend on the map, not the shapes."""
    M = s["mapping"]
    k = M["knn"]
    return [((q * 3 + q + c * 3 + c + 2 * q * k) * F32, 0)
            for q, c in ((M["corner_slot"], M["map_corner_cap"]),
                         (M["surf_slot"], M["map_surf_cap"]))]


def share_pct(calls: list, n_launch: int, launches_per_call: int, device_s: float,
              device_name: str):
    """Roofline share (%) of ``n_launch`` kernel launches that took
    ``device_s`` in all, ``launches_per_call`` launches a call, the calls
    cycling through ``calls``; None where nothing was read or the card has
    no peaks in the table."""
    n_calls = n_launch // launches_per_call
    if n_calls == 0 or device_s <= 0:
        return None
    bounds = [bound_s(b, o, device_name) for b, o in calls]
    if any(b is None for b in bounds):
        return None
    total = sum(bounds[i % len(bounds)] for i in range(n_calls))
    return 100.0 * total / device_s
