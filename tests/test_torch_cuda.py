"""The port's CUDA kernels against their plain PyTorch versions, on the card,
the direct-VO chunk (which runs no kernel of the port) on the card against
the port on the CPU, the per-frame drivers' kernel launches, and resumed
runs of the four ``run_chunked``s bit for bit.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so that on a machine with a card and without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch
from _feature_cases import CRAFTED, SELECTION, crafted_scan, selection_inputs

from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.kernels import features as kfeat
from lidar_visual_odometry_tpu_torch.kernels import gn as kgn
from lidar_visual_odometry_tpu_torch.kernels import lk as klk
from lidar_visual_odometry_tpu_torch.kernels import nn as knn_k
from lidar_visual_odometry_tpu_torch.kernels import segsum as kseg
from lidar_visual_odometry_tpu_torch.kernels import topk as ktop

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _voxel_rows(gen, R, W, S, n_valid, p_new):
    """Ids as the voxel filters produce them: non-decreasing run ids (a new
    voxel with probability ``p_new`` a point) for ``n_valid`` points, then the
    overflow bucket S - 1 for the rest, whose values are zero."""
    seg = np.full((R, W), S - 1, np.int32)
    vals = gen.normal(scale=30.0, size=(R, 4, W)).astype(np.float32)
    for r in range(R):
        n = int(n_valid[r]) if np.ndim(n_valid) else n_valid
        seg[r, :n] = np.minimum(np.cumsum(gen.uniform(size=n) < p_new), S - 1)
        vals[r, :, n:] = 0.0
    return seg, vals


def _sum(seg, vals, S):
    """One kernel call of the form the shapes ask for, with its launch count."""
    kernels.reset_launch_counts()
    if seg.dim() == 1:
        got = kseg.segment_sum(seg, vals, n_segments=S)
        counts = kernels.launch_counts()
        assert counts["segment_sum"] == 1 and counts["segment_sum_batched"] == 0
    else:
        got = kseg.segment_sum_batched(seg, vals, n_segments=S)
        counts = kernels.launch_counts()
        assert counts["segment_sum_batched"] == 1 and counts["segment_sum"] == 0
    return got


def _equal_run_order(seg, vals, S):
    got = _sum(seg, vals, S)
    torch.testing.assert_close(got, kseg.segment_sum_run_order(seg, vals, n_segments=S),
                               rtol=0, atol=0)
    return got


def _close_to_plain(seg, vals, S, atol=1e-3):
    """Ids in no order: the kernel adds in ascending w, the plain version with
    atomics on the card. The same values in another order: rtol 1e-5, atol
    1e-3 for sums of up to W values of |v| ≲ 100, 1e-4 for |v| ≲ 4."""
    got = _sum(seg, vals, S)
    plain = (kseg.segment_sum_plain if seg.dim() == 1 else kseg.segment_sum_batched_plain)
    torch.testing.assert_close(got, plain(seg, vals, n_segments=S), rtol=1e-5, atol=atol)
    return got


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_matches_plain(dev, gen, sorted_ids):
    """The per-ring filter's shapes: sorted ids give the ordered sums bit for
    bit, ids in no order the plain version's within rounding."""
    seg = gen.integers(0, 513, (64, 2048))
    if sorted_ids:
        seg = np.sort(seg, axis=1)
    seg, vals = _on(dev, seg.astype(np.int32),
                    gen.normal(size=(64, 4, 2048)).astype(np.float32))
    if sorted_ids:
        _equal_run_order(seg, vals, 513)
    else:
        _close_to_plain(seg, vals, 513, atol=1e-4)   # values of normal scale 1


@pytest.mark.parametrize("W", [32768, 7680, 100])
def test_flat_segment_sum_matches_plain(dev, gen, W):
    """The mapping voxel filter's flat sum at S 4097, one launch a call:
    non-decreasing run ids with the masked points in the overflow bucket give
    the ordered sums bit for bit, ids in no order (some out of range) the
    plain version's within rounding."""
    S = 4097
    seg, vals = _voxel_rows(gen, 1, W, S, W * 3 // 4, 0.4)
    seg_t, vals_t = _on(dev, seg[0], vals[0])
    _equal_run_order(seg_t, vals_t, S)
    ids = _on(dev, gen.integers(-1, S + 1, W).astype(np.int32))[0]
    _close_to_plain(ids, vals_t, S)


@pytest.mark.parametrize("form", ["batched", "flat_less_flat", "flat_less_sharp"])
def test_segment_sum_path_shapes_equal_run_order(dev, gen, form):
    """The path's own shapes and run lengths: the per-ring filter (64 rows of
    2048 points, 800-1800 valid, S 513) and the two mapping filters (W 32768
    with 16000 valid at 15% new voxels, W 7680 with 5000 at 60%, S 4097)."""
    if form == "batched":
        seg, vals = _voxel_rows(gen, 64, 2048, 513, gen.integers(800, 1800, 64), 0.4)
        _equal_run_order(*_on(dev, seg, vals), 513)
        return
    W, n_valid, p_new = (32768, 16000, 0.15) if form == "flat_less_flat" else (7680, 5000, 0.6)
    seg, vals = _voxel_rows(gen, 1, W, 4097, n_valid, p_new)
    _equal_run_order(*_on(dev, seg[0], vals[0]), 4097)


@pytest.mark.parametrize("case", ["all_bucket", "long_runs", "out_of_range", "ragged_S"])
@pytest.mark.parametrize("flat", [False, True])
def test_segment_sum_edge_cases_equal_run_order(dev, gen, case, flat):
    """all_bucket: every point in the overflow bucket; long_runs: runs of 33
    points (one past a thread's share), 300 (longer than a block's 256
    threads) and 5000 (across the flat form's 2048-point cuts), around short
    runs; out_of_range: sorted ids
    from -3 to S + 3, the ones outside [0, S) dropped; ragged_S: S 50, not a
    multiple of the block's 32 segments, with runs on every segment-tile
    boundary."""
    R, W, S = (1, 8192, 4097) if flat else (8, 8192, 513)
    vals = gen.normal(scale=30.0, size=(R, 4, W)).astype(np.float32)
    if case == "all_bucket":
        seg = np.full((R, W), S - 1, np.int32)
    elif case == "long_runs":
        lengths = np.tile([3, 33, 1, 300, 7, 5000, 2], 4)
        seg = np.repeat(np.arange(len(lengths)), lengths)[:W]
        seg = np.broadcast_to(np.pad(seg, (0, W - len(seg)), constant_values=S - 1), (R, W))
    elif case == "out_of_range":
        seg = np.sort(gen.integers(-3, S + 3, (R, W)), axis=1)
    else:
        S = 50
        seg = np.sort(gen.integers(0, S, (R, W)), axis=1)
    seg_t, vals_t = _on(dev, np.ascontiguousarray(seg, dtype=np.int32), vals)
    if flat:
        seg_t, vals_t = seg_t[0].contiguous(), vals_t[0].contiguous()
    _equal_run_order(seg_t, vals_t, S)


def test_segment_sum_mixed_rows_and_repeat_calls(dev, gen):
    """Sorted and unsorted rows in one batched call: the sorted rows give the
    ordered sums bit for bit, the others the plain version's within rounding;
    two calls on the same inputs give the same bits."""
    seg, vals = _voxel_rows(gen, 64, 2048, 513, gen.integers(800, 1800, 64), 0.4)
    seg[1::2] = gen.integers(-1, 514, (32, 2048))
    seg_t, vals_t = _on(dev, seg, vals)
    got = _close_to_plain(seg_t, vals_t, 513)
    torch.testing.assert_close(
        got[0::2], kseg.segment_sum_run_order(seg_t[0::2], vals_t[0::2], n_segments=513),
        rtol=0, atol=0)
    torch.testing.assert_close(_sum(seg_t, vals_t, 513), got, rtol=0, atol=0)
    flat_seg, flat_vals = _on(dev, gen.integers(0, 4097, 7680).astype(np.int32),
                              vals[0, :, :1920].repeat(4, axis=1))
    once = _sum(flat_seg, flat_vals, 4097)
    torch.testing.assert_close(_sum(flat_seg, flat_vals, 4097), once, rtol=0, atol=0)


@pytest.mark.parametrize("flat", [False, True])
def test_segment_sum_sorted_after_unsorted(dev, gen, flat):
    """A call on sorted ids after calls on ids in no order gives the ordered
    sums bit for bit: nothing of one call carries into the next."""
    R, W, S = (1, 32768, 4097) if flat else (64, 2048, 513)
    seg, vals = _voxel_rows(gen, R, W, S, W // 2, 0.15)
    unsorted = gen.integers(-1, S + 1, (R, W)).astype(np.int32)
    seg_t, vals_t, unsorted_t = _on(dev, seg, vals, unsorted)
    if flat:
        seg_t, vals_t, unsorted_t = seg_t[0], vals_t[0], unsorted_t[0]
    for _ in range(2):
        _close_to_plain(unsorted_t, vals_t, S)
        _equal_run_order(seg_t, vals_t, S)


def _clustered(gen, n, centers, scale):
    return (centers[gen.integers(0, len(centers), n)]
            + gen.normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("C", [16384, 32768])
def test_block_topk_windowed_matches_plain(dev, gen, C):
    centers = gen.uniform(-60, 60, (40, 3)) * np.array([1.0, 1.0, 0.05])
    q, c = _on(dev, _clustered(gen, 4096, centers, 1.0), _clustered(gen, C, centers, 1.5))
    mask = torch.from_numpy(gen.uniform(size=C) > 0.2).to(dev)
    origin = torch.tensor([-256.0, -256.0], device=dev)
    c_sorted, c_keys = ktop.sort_by_cell(c, mask, origin, cell=2.0, grid_w=256)
    q_keys = ktop.cell_keys(q, origin, cell=2.0, grid_w=256)
    order = torch.argsort(q_keys, stable=True)
    q, q_keys = q[order].contiguous(), q_keys[order].contiguous()
    kernels.reset_launch_counts()
    d, i = ktop.block_topk_windowed(q, q_keys, c_sorted, c_keys)
    assert kernels.launch_counts()["block_topk_windowed"] == 1
    dp, ip = ktop.block_topk_windowed_plain(q, q_keys, c_sorted, c_keys)
    # the same chunks, the same float32 expression without contraction and the
    # same tie rule: identical distances and indices
    torch.testing.assert_close(d, dp, rtol=0, atol=0)
    torch.testing.assert_close(i, ip, rtol=0, atol=0)


def _windowed_calls(n, q, q_keys, c, c_keys, **kw):
    """``n`` calls of K4, each one launch-counter step; the last result."""
    kernels.reset_launch_counts()
    for step in range(1, n + 1):
        out = ktop.block_topk_windowed(q, q_keys, c, c_keys, **kw)
        assert kernels.launch_counts()["block_topk_windowed"] == step
    return out


@pytest.mark.parametrize("C", [16384, 32768])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["path", "one cell", "unsorted", "straddling"])
def test_block_topk_windowed_cases_bit_for_bit(dev, gen, C, k, case):
    """K4's own kernels on the path's layout (sorted cell keys), with every
    key in one cell (every chunk hits every tile: the dense worst case), with
    c_keys in no order (the pre-pass reads every key), and with q_tile 24,
    which puts 16-query blocks across two tiles; three calls each."""
    centers = gen.uniform(-60, 60, (40, 3)) * np.array([1.0, 1.0, 0.05])
    q = _clustered(gen, 4096 - (4096 % 24 if case == "straddling" else 0), centers, 1.0)
    c = _clustered(gen, C, centers, 1.5)
    q, c = (np.round(x * 8) / 8 for x in (q, c))        # ties of distance
    q, c = _on(dev, q.astype(np.float32), c.astype(np.float32))
    mask = torch.from_numpy(gen.uniform(size=C) > 0.2).to(dev)
    origin = torch.tensor([-256.0, -256.0], device=dev)
    kw = dict(k=k, q_tile=24 if case == "straddling" else 256, grid_w=256)
    c_sorted, c_keys = ktop.sort_by_cell(c, mask, origin, cell=2.0, grid_w=256)
    q_keys = ktop.cell_keys(q, origin, cell=2.0, grid_w=256)
    order = torch.argsort(q_keys, stable=True)
    q, q_keys = q[order].contiguous(), q_keys[order].contiguous()
    if case == "one cell":
        q_keys, c_keys = torch.full_like(q_keys, 777), torch.full_like(c_keys, 777)
    elif case == "unsorted":
        c_keys = c_keys[torch.randperm(C, device=dev)].contiguous()
    d, i = _windowed_calls(3, q, q_keys, c_sorted, c_keys, **kw)
    dp, ip = ktop.block_topk_windowed_plain(q, q_keys, c_sorted, c_keys, **kw)
    assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.parametrize("Q,C,k", [(4096, 32768, 5), (1000, 777, 3)])
def test_block_topk_matches_plain(dev, gen, Q, C, k):
    q, c = _on(dev, gen.normal(size=(Q, 3)).astype(np.float32) * 20,
               gen.normal(size=(C, 3)).astype(np.float32) * 20)
    baked = knn_k.bake_mask(c, torch.from_numpy(gen.uniform(size=C) > 0.3).to(dev))
    kernels.reset_launch_counts()
    d, i = ktop.block_topk(q, baked.contiguous(), k=k)
    assert kernels.launch_counts()["block_topk"] == 1
    dp, ip = ktop.block_topk_plain(q, baked, k=k)
    # as test_block_topk_windowed_matches_plain: identical
    torch.testing.assert_close(d, dp, rtol=0, atol=0)
    torch.testing.assert_close(i, ip, rtol=0, atol=0)


@pytest.mark.parametrize("B", [120, 512, 1])
def test_associate_matches_plain(dev, gen, B):
    c, m, q = _on(dev, gen.normal(size=(64, B, 3)).astype(np.float32) * 8,
                  gen.uniform(size=(64, B)) > 0.2,
                  gen.normal(size=(768, 3)).astype(np.float32) * 8)
    baked = knn_k.bake_mask(c, m).contiguous()
    # same distances bit for bit, same tie rules → the same winners
    torch.testing.assert_close(knn_k.associate_kernel(q, baked),
                               knn_k.associate_kernel_plain(q, baked), rtol=0, atol=0)


def _assoc_calls(q, baked, n, **kw):
    """``n`` calls of K2, each one launch-counter step; the last result."""
    kernels.reset_launch_counts()
    for step in range(1, n + 1):
        out = knn_k.associate_kernel(q, baked, **kw)
        assert kernels.launch_counts()["associate_kernel"] == step
    return out


@pytest.mark.parametrize("B", [1, 7, 120, 512, 513])
def test_associate_staged_rings_bit_for_bit(dev, gen, B):
    """The staged-ring K2 at B that are and are not multiples of 4 (16-byte
    and 4-byte staging), Q 771 not a multiple of the 8-query block, each
    candidate duplicated within its ring and ring 0 copied to ring 5 (ties
    to the first index and to the first ring): the plain version's bits."""
    c = gen.integers(-64, 64, size=(64, B, 3)).astype(np.float32) / 8
    c[:, 1::2] = c[:, 0:B - 1:2]
    c[5] = c[0]
    q = gen.integers(-64, 64, size=(771, 3)).astype(np.float32) / 8
    q[:8] = c[0, 0]                                      # distance 0 on rings 0 and 5
    c, m, q = _on(dev, c, gen.uniform(size=(64, B)) > 0.2, q)
    baked = knn_k.bake_mask(c, m).contiguous()
    out = _assoc_calls(q, baked, 3)
    assert torch.equal(out, knn_k.associate_kernel_plain(q, baked))


def test_associate_empty_window_and_second_stream(dev, gen):
    """nearby_scan 0.5 leaves every ring window empty (c1rw zero, dw 1e30);
    two calls on a second stream give the default stream's result."""
    c, m, q = _on(dev, gen.normal(size=(64, 120, 3)).astype(np.float32) * 8,
                  gen.uniform(size=(64, 120)) > 0.2,
                  gen.normal(size=(300, 3)).astype(np.float32) * 8)
    baked = knn_k.bake_mask(c, m).contiguous()
    out = _assoc_calls(q, baked, 1, nearby_scan=0.5)
    want = knn_k.associate_kernel_plain(q, baked, nearby_scan=0.5)
    assert torch.equal(out, want)
    assert bool((out[:, 6:9] == 0).all()) and bool((out[:, 11] == 1e30).all())
    want = knn_k.associate_kernel_plain(q, baked)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = _assoc_calls(q, baked, 2)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert torch.equal(got, want)


def test_associate_rings_all_at_infinity(dev, gen):
    """Every candidate 1e20 away, so every squared distance overflows to
    +inf: the plain version's rows (ring 0, its index 0 as arg-min, the
    runner-up rule's (1e30, 0)), with no read outside the rings."""
    c = np.full((64, 120, 3), 1e20, np.float32)
    c[..., 1] = np.arange(64 * 120).reshape(64, 120)        # every candidate its own point
    q = (gen.integers(-8, 9, size=(300, 3)) / 8).astype(np.float32)
    q, c = _on(dev, q, c)
    out = _assoc_calls(q, c, 1)
    torch.cuda.synchronize()
    assert torch.equal(out, knn_k.associate_kernel_plain(q, c))


@pytest.mark.parametrize("B", [120, 512, 1])
def test_ring_top2_matches_plain(dev, gen, B):
    """K7, both output forms: K2's distances and tie rules, so identical."""
    c, m, q = _on(dev, gen.normal(size=(64, B, 3)).astype(np.float32) * 8,
                  gen.uniform(size=(64, B)) > 0.2,
                  gen.normal(size=(1536, 3)).astype(np.float32) * 8)
    baked = knn_k.bake_mask(c, m).contiguous()
    kernels.reset_launch_counts()
    d, i = knn_k.ring_top2_pallas(q, baked)
    dc, c1, c2 = knn_k.ring_top2_coords(q, baked)
    counts = kernels.launch_counts()
    assert counts["ring_top2_pallas"] == 1 and counts["ring_top2_coords"] == 1
    assert counts["associate_kernel"] == 0
    dp, ip = knn_k.ring_top2_pallas_plain(q, baked)
    _, c1p, c2p = knn_k.ring_top2_coords_plain(q, baked)
    for got, want in ((d, dp), (i, ip), (dc, dp), (c1, c1p), (c2, c2p)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _ring_top2_bit_for_bit(q, baked):
    """K7 on the card in both output forms, one launch each, against their
    plain versions bit for bit; returns (dist, idx, c1, c2)."""
    kernels.reset_launch_counts()
    d, i = knn_k.ring_top2_pallas(q, baked)
    dc, c1, c2 = knn_k.ring_top2_coords(q, baked)
    counts = kernels.launch_counts()
    assert counts["ring_top2_pallas"] == 1 and counts["ring_top2_coords"] == 1
    dp, ip = knn_k.ring_top2_pallas_plain(q, baked)
    _, c1p, c2p = knn_k.ring_top2_coords_plain(q, baked)
    for got, want in ((d, dp), (i, ip), (dc, dp), (c1, c1p), (c2, c2p)):
        assert torch.equal(got, want)
    return d, i, c1, c2


@pytest.mark.parametrize("case", ["far", "overflow", "winner first", "all overflow"])
def test_ring_top2_runner_up_at_1e30(dev, gen, case):
    """Rings whose candidates other than the winner lie at or above 1e30 in
    squared distance (2e15 away, or 1e20 away, whose square overflows to
    +inf), with the winner at index 0 or at an index that moves from ring to
    ring across the segments: the TPU's runner-up (1e30, the winner's index)
    and the winner's coordinates, as the plain versions give them."""
    R, B, Q = 64, 120, 768
    far = 1e20 if "overflow" in case else 2e15
    c = np.zeros((R, B, 3), np.float32)
    c[..., 0] = far
    win = gen.integers(1, B, R) if case in ("far", "overflow") else np.zeros(R, int)
    if case != "all overflow":
        c[np.arange(R), win] = gen.integers(-8, 9, size=(R, 3)) / 8
    q = (gen.integers(-8, 9, size=(Q, 3)) / 8).astype(np.float32)
    q, c = _on(dev, q, c)
    d, i, c1, c2 = _ring_top2_bit_for_bit(q, c)
    base = torch.arange(R, device=dev, dtype=torch.int32)[None, :] * B
    assert bool((i[..., 1] == i[..., 0]).all()) and bool((d[..., 1] == 1e30).all())
    assert torch.equal(i[..., 0] - base, torch.from_numpy(win).to(dev, torch.int32)[None, :]
                       .expand(Q, R))
    assert torch.equal(c2, c1)


def _ring_tie_case(gen, Q, R, B, reach=3):
    """Queries and rings on a 1/8 grid within ±reach, so every distance is
    exact; each ring holds at most 40 distinct points repeated in shuffled
    copies, so that exact ties lie in different segments and staged pieces;
    a tenth of the candidates masked (baked far)."""
    n = max(1, min(B // 2, 40))
    uniq = gen.integers(-8 * reach, 8 * reach + 1, size=(R, n, 3)) / 8
    copies = [uniq[:, gen.permutation(n)] for _ in range(-(-B // n))]
    c = np.concatenate(copies, axis=1)[:, :B].astype(np.float32)
    q = (gen.integers(-8 * reach, 8 * reach + 1, size=(Q, 3)) / 8).astype(np.float32)
    return q, c, gen.uniform(size=(R, B)) > 0.1


@pytest.mark.parametrize("Q,R,B", [
    (768, 64, 120),       # the edge call's shape
    (1536, 64, 512),      # the plane call's shape
    (100, 64, 1), (100, 9, 2), (65, 7, 3), (129, 5, 5), (300, 13, 31), (300, 3, 33),
    (77, 1, 512),         # one ring: eight segments
    (1000, 11, 513),      # Q not a multiple of a block's queries, B of a quad
    (2048, 66, 2501),     # 4 rings a block, the last group of 2; three pieces, 4-byte copies
    (4225, 64, 1000),     # 8 rings a block, one segment each; two pieces
    (257, 2, 20000),      # a ring of five pieces
])
def test_ring_top2_ties_across_segments_bit_for_bit(dev, gen, Q, R, B):
    """The redesigned K7 on exact ties spread over segments and pieces: the
    plain versions' bits, so the split and the merge keep the first index."""
    q, c, m = _on(dev, *_ring_tie_case(gen, Q, R, B))
    d, _, _, _ = _ring_top2_bit_for_bit(q, knn_k.bake_mask(c, m).contiguous())
    if B > 1:
        assert bool((d[..., 0] == d[..., 1]).any())          # ties were exercised


def test_ring_top2_repeated_second_stream_and_unaligned(dev, gen):
    """Three calls, a candidate view that starts 4 bytes into its storage
    (4-byte copies) and two calls on a second stream: the same bits."""
    q, c, m = _on(dev, *_ring_tie_case(gen, 768, 64, 120))
    baked = knn_k.bake_mask(c, m).contiguous()
    first = _ring_top2_bit_for_bit(q, baked)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(_ring_top2_bit_for_bit(q, baked), first))
    view = torch.empty(baked.numel() + 1, device=dev)[1:].view(baked.shape)
    view.copy_(baked)
    assert view.data_ptr() % 16 == 4
    assert all(torch.equal(a, b) for a, b in zip(_ring_top2_bit_for_bit(q, view), first))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = [knn_k.ring_top2_pallas(q, baked), knn_k.ring_top2_coords(q, baked)]
    torch.cuda.current_stream(dev).wait_stream(side)
    assert all(torch.equal(a, b) for a, b in zip(on_side[0] + on_side[1][1:], first))


@pytest.mark.parametrize("Q,C,k", [(4096, 32768, 5), (1000, 777, 3), (64, 3, 5)])
def test_block_topk_coords_and_packed_match_plain(dev, gen, Q, C, k):
    """K8 and K5p: K5's loop with another epilogue or a packed key, so
    identical to their plain versions (C 3 < k: the unfilled-slot rules)."""
    q, c = _on(dev, gen.normal(size=(Q, 3)).astype(np.float32) * 20,
               gen.normal(size=(C, 3)).astype(np.float32) * 20)
    baked = knn_k.bake_mask(c, torch.from_numpy(gen.uniform(size=C) > 0.3).to(dev)).contiguous()
    kernels.reset_launch_counts()
    d, co = ktop.block_topk_coords(q, baked, k=k)
    dk, ik = ktop.block_topk(q, baked, k=k, packed=True)
    counts = kernels.launch_counts()
    assert counts["block_topk_coords"] == 1 and counts["block_topk_packed"] == 1
    assert counts["block_topk"] == 0
    dp, cop = ktop.block_topk_coords_plain(q, baked, k=k)
    dkp, ikp = ktop.block_topk_packed_plain(q, baked, k=k)
    for got, want in ((d, dp), (co, cop), (dk, dkp), (ik, ikp)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_block_topk_packed_above_32768_launches_k5(dev, gen):
    q, c = _on(dev, gen.normal(size=(256, 3)).astype(np.float32) * 20,
               gen.normal(size=(32769, 3)).astype(np.float32) * 20)
    kernels.reset_launch_counts()
    d, i = ktop.block_topk(q, c, k=5, packed=True)
    counts = kernels.launch_counts()
    assert counts["block_topk"] == 1 and counts["block_topk_packed"] == 0
    dp, ip = ktop.block_topk_plain(q, c, k=5)
    torch.testing.assert_close(d, dp, rtol=0, atol=0)
    torch.testing.assert_close(i, ip, rtol=0, atol=0)


def _tie_cloud(gen, Q, C, reach=3):
    """Queries and candidates on a 1/8 grid within ±reach, so every distance
    is exact; the candidates are at most 300 distinct points repeated in
    shuffled copies, so that exact ties of distance and of position lie in
    different staged chunks and in different cluster pieces; a tenth of them
    masked (baked far)."""
    uniq = gen.integers(-8 * reach, 8 * reach + 1, size=(max(1, min(C, 300)), 3)) / 8
    copies = [uniq[gen.permutation(len(uniq))] for _ in range(-(-C // len(uniq)))]
    c = np.concatenate(copies)[:C].astype(np.float32)
    q = (gen.integers(-8 * reach, 8 * reach + 1, size=(Q, 3)) / 8).astype(np.float32)
    return q, c, gen.uniform(size=C) > 0.1


def _dense_forms_bit_for_bit(q, baked, k):
    """K5, K8 and K5p on the card, one launch each (K5p with C > 32768 is
    K5), against their plain versions bit for bit; returns the three outputs."""
    C = baked.shape[0]
    kernels.reset_launch_counts()
    got = (ktop.block_topk(q, baked, k=k), ktop.block_topk_coords(q, baked, k=k),
           ktop.block_topk(q, baked, k=k, packed=True))
    counts = kernels.launch_counts()
    packed = C <= ktop.PACKED_MAX_C
    assert counts["block_topk"] == (1 if packed else 2) and counts["block_topk_coords"] == 1
    assert counts["block_topk_packed"] == (1 if packed else 0)
    want = (ktop.block_topk_plain(q, baked, k=k), ktop.block_topk_coords_plain(q, baked, k=k),
            (ktop.block_topk_packed_plain if packed else ktop.block_topk_plain)(q, baked, k=k))
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    return got


@pytest.mark.parametrize("Q,C,k", [
    (4096, 32768, 5),     # the surf call's shape, K5p's largest C
    (4096, 32769, 5),     # one candidate too many for a packed key: K5p is K5
    (4096, 16384, 8),     # the corner call's shape
    (64, 32768, 5),       # two query groups: eight cluster pieces
    (1000, 5003, 1),      # Q and C not multiples of the block's queries or the chunk
    (777, 2049, 8),       # a last chunk of one candidate
    (33, 3, 5),           # fewer candidates than k and than pieces
    (5, 1, 8),
])
def test_dense_topk_ties_across_pieces_bit_for_bit(dev, gen, Q, C, k):
    """The redesigned dense kernel (K5, K8, K5p) on exact ties spread over
    chunks and cluster pieces: the plain versions' bits, so the split and
    the merge keep the lower index."""
    q, c, m = _tie_cloud(gen, Q, C)
    q, c, m = _on(dev, q, c, m)
    d, i = _dense_forms_bit_for_bit(q, knn_k.bake_mask(c, m).contiguous(), k)[0]
    if k > 1 and C >= 2 * k:
        assert bool((d[:, 1:] == d[:, :-1]).any())          # ties were exercised


def test_dense_topk_repeated_second_stream_and_unaligned(dev, gen):
    """Three calls, a call on a second stream and a candidate view that
    starts 12 bytes into its storage (copied to a 16-byte boundary for the
    bulk copies): the same bits every time."""
    q, c, m = _tie_cloud(gen, 4096, 32769)
    q, c, m = _on(dev, q, c, m)
    baked = knn_k.bake_mask(c, m).contiguous()
    first = _dense_forms_bit_for_bit(q, baked[1:], 5)
    for _ in range(2):
        again = _dense_forms_bit_for_bit(q, baked[1:], 5)
        assert all(torch.equal(a, b) for g, w in zip(again, first) for a, b in zip(g, w))
    view = baked[1:]
    assert view.data_ptr() % 16 == 12
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = (ktop.block_topk(q, view, k=5), ktop.block_topk_coords(q, view, k=5),
                   ktop.block_topk(q, view, k=5, packed=True))
    torch.cuda.current_stream(dev).wait_stream(side)
    assert all(torch.equal(a, b) for g, w in zip(on_side, first) for a, b in zip(g, w))


def test_gn_inner_loop_matches_plain(dev, gen):
    ne, npl = 768, 1536
    pts = [gen.uniform(-10, 10, (3, n)).astype(np.float32) for n in (ne,) * 3 + (npl,) * 4]
    w = [(gen.uniform(size=(1, n)) > 0.2).astype(np.float32) for n in (ne, npl)]
    q0 = np.array([0.999, 0.02, -0.03, 0.01], np.float32)
    q0 /= np.linalg.norm(q0)
    args = _on(dev, q0, np.array([0.3, -0.1, 0.05], np.float32), *pts[:3], w[0], *pts[3:], w[1])
    q, t = kgn.gn_inner_loop(*args)
    qr, tr = kgn.gn_inner_loop_plain(*args)
    # float32 sums in another order and fused multiply-adds in the kernel
    torch.testing.assert_close(t, tr, rtol=0, atol=1e-4)
    torch.testing.assert_close(q * torch.sign(torch.dot(q, qr)), qr, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def corridor_pair():
    """Two consecutive frames of the bench corridor's camera (640 × 192) and
    the three-level pyramids, on the host."""
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.ops import image

    seq = synthetic.SyntheticSequence(n_frames=3, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    cam = dict(fx=240.0, fy=240.0, cx=320.0, cy=96.0, width=640, height=192)
    imgs = [torch.from_numpy(synthetic.render_image(
        seq.scene, *synthetic.camera_from_velodyne_pose(*seq.pose(k)), **cam)[0])
        for k in (0, 1)]
    return [image.build_pyramid(im, 3) for im in imgs]


@pytest.mark.parametrize("level,affine,iters,fixed,eps", [
    (0, True, 10, False, 0.01), (1, False, 4, False, 0.01), (2, False, 4, False, 0.01),
    (0, False, 10, True, 0.01), (0, True, 10, False, 0.0), (1, False, 4, False, 0.0),
])
def test_lk_level_matches_plain(dev, gen, corridor_pair, level, affine, iters, fixed, eps):
    """K6 at the camera path's shapes (768 features, win 13), interior and
    border features, a fifth of the rows inactive."""
    pyr0, pyr1 = corridor_pair
    i0, i1 = pyr0[level].to(dev), pyr1[level].to(dev)
    H, W = i0.shape
    N = 768
    uv = np.stack([gen.uniform(0, W - 1, N), gen.uniform(0, H - 1, N)], -1)
    uv[:96, 0] = gen.uniform(0, 9, 96)              # within win/2 + 2 px of a border
    uv[96:192, 1] = H - 1 - gen.uniform(0, 9, 96)
    guess = gen.normal(0, 1.0 / 2 ** level, (N, 2))
    act = gen.uniform(size=N) > 0.2
    fa = gen.normal(0, 0.01, (N, 4)) if fixed else None
    uv, guess, fa_t = _on(dev, uv.astype(np.float32), guess.astype(np.float32),
                          (fa if fixed else np.zeros((N, 4))).astype(np.float32))
    act = torch.from_numpy(act).to(dev)
    kw = dict(win=13, iters=iters, eps=eps, affine=affine, return_affine=affine,
              return_iters=True)
    kernels.reset_launch_counts()
    got = klk.lk_level(i0, i1, uv, guess, act, fa_t if fixed else None, **kw)
    assert kernels.launch_counts()["lk_level"] == 1
    want = klk.lk_level_plain(i0, i1, uv, guess, act, fa_t if fixed else None, **kw)
    # the same samples, products and sums in the same order, each rounded on
    # its own: every output bit for bit
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _lk_case(gen, dev, H, W, N, win, level, mode):
    """Features over the whole level, a quarter of them within win/2 + 2 px
    of a border, a fifth inactive; guesses of about a pixel at level 0."""
    uv = np.stack([gen.uniform(0, W - 1, N), gen.uniform(0, H - 1, N)], -1)
    edge = N // 8
    uv[:edge, 0] = gen.uniform(0, win / 2 + 2, edge)
    uv[edge:2 * edge, 1] = H - 1 - gen.uniform(0, win / 2 + 2, edge)
    guess = gen.normal(0, 1.0 / 2 ** level, (N, 2))
    act = gen.uniform(size=N) > 0.2
    fa = gen.normal(0, 0.01, (N, 4)).astype(np.float32) if mode == "fixed" else None
    uv_t, guess_t = _on(dev, uv.astype(np.float32), guess.astype(np.float32))
    fa_t = _on(dev, fa)[0] if fa is not None else None
    return uv_t, guess_t, torch.from_numpy(act).to(dev), fa_t


@pytest.mark.parametrize("mode", ["2x2", "affine", "fixed"])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("win", [9, 13, 25, 11])
def test_lk_level_windows_bit_for_bit(dev, gen, corridor_pair, win, level, mode):
    """K6's instances (win 9, 13 and 25 unrolled, 11 the runtime-window one)
    at every level of the corridor pair, in every solve mode: N 770 at level 0
    and 20 above (neither a multiple of the block's 4 features), eps 0 at
    level 1 (every feature runs all its iterations). Every output equals the
    plain version's bit for bit."""
    pyr0, pyr1 = corridor_pair
    i0, i1 = pyr0[level].to(dev), pyr1[level].to(dev)
    H, W = i0.shape
    N = 770 if level == 0 else 20
    uv, guess, act, fa = _lk_case(gen, dev, H, W, N, win, level, mode)
    affine = mode == "affine"
    kw = dict(win=win, iters=10 if level == 0 else 4, eps=0.0 if level == 1 else 0.01,
              affine=affine, return_affine=affine, return_iters=True)
    kernels.reset_launch_counts()
    got = klk.lk_level(i0, i1, uv, guess, act, fa, **kw)
    assert kernels.launch_counts()["lk_level"] == 1
    want = klk.lk_level_plain(i0, i1, uv, guess, act, fa, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert bool(want[1].any())      # some features were tracked, not only returned


@pytest.mark.parametrize("affine", [False, True])
def test_lk_level_all_inactive(dev, gen, corridor_pair, affine):
    """No active row: every row returns its guess, ok False, no iteration,
    zero affine parameters."""
    i0, i1 = corridor_pair[0][0].to(dev), corridor_pair[1][0].to(dev)
    H, W = i0.shape
    uv, guess, _, _ = _lk_case(gen, dev, H, W, 36, 13, 0, "2x2")
    act = torch.zeros(36, dtype=torch.bool, device=dev)
    kw = dict(win=13, iters=10, eps=0.01, affine=affine, return_affine=affine,
              return_iters=True)
    got = klk.lk_level(i0, i1, uv, guess, act, **kw)
    want = klk.lk_level_plain(i0, i1, uv, guess, act, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(got[0], guess, rtol=0, atol=0)
    assert not bool(got[1].any()) and not bool(got[-1].any())


def _rotation(w):
    """Rotation matrix of the axis-angle vector ``w`` (Rodrigues)."""
    th = float(np.linalg.norm(w))
    k = np.asarray(w) / th
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * K @ K


def _gn_args(gen, dev, ne, npl):
    """Correspondences consistent with a known pose (R, t) that maps scan
    points into the map; identity start; a fifth of the weights zero."""
    R = _rotation([0.02, -0.03, 0.04])
    t = np.array([0.3, -0.15, 0.1])
    a = gen.uniform(-10, 10, (ne, 3))
    d = gen.normal(size=(ne, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p_e = (a + gen.uniform(-0.5, 1.5, (ne, 1)) * d - t) @ R       # R^T (x - t)
    j = gen.uniform(-10, 10, (npl, 3))
    n = gen.normal(size=(npl, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1 = np.cross(n, [0.3, 0.7, 0.64])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    p_p = (j + 0.3 * t1 + 0.2 * t2 - t) @ R
    rows = [x.T.astype(np.float32) for x in (p_e, a, a + d)]
    rows += [(gen.uniform(size=(1, ne)) > 0.2).astype(np.float32)]
    rows += [x.T.astype(np.float32) for x in (p_p, j, j + t1, j + t2)]
    rows += [(gen.uniform(size=(1, npl)) > 0.2).astype(np.float32)]
    return _on(dev, np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32), *rows), t


def _gn_close(got, want):
    """The tolerance of K3 against its plain version: float32 sums in
    another order, fused multiply-adds in the kernel."""
    (q, t), (qr, tr) = got, want
    torch.testing.assert_close(t, tr, rtol=0, atol=1e-4)
    torch.testing.assert_close(q * torch.sign(torch.dot(q, qr)), qr, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_iters", [0, 1, 4, 8])
@pytest.mark.parametrize("ne,npl", [(768, 1536), (0, 1536), (768, 0), (5, 7), (1000, 3001)])
def test_gn_inner_loop_cluster_matches_plain(dev, gen, ne, npl, n_iters):
    """K3 at the path's counts, with one kind of correspondence absent, at
    counts that fill no warp, and past the registers the cluster's threads
    keep (3001 planes: some threads read theirs again each iteration). A
    second call on the same inputs gives the same bits; no iteration returns
    the start pose."""
    args, t_true = _gn_args(gen, dev, ne, npl)
    kernels.reset_launch_counts()
    got = kgn.gn_inner_loop(*args, n_iters=n_iters)
    again = kgn.gn_inner_loop(*args, n_iters=n_iters)
    assert kernels.launch_counts()["gn_inner_loop"] == 2
    _gn_close(got, kgn.gn_inner_loop_plain(*args, n_iters=n_iters))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if n_iters == 0:
        assert torch.equal(got[0], args[0]) and torch.equal(got[1], args[1])
    if n_iters == 8 and ne + npl > 100:
        np.testing.assert_allclose(got[1].cpu().numpy(), t_true, atol=2e-3)


def test_gn_inner_loop_zero_weights_and_nan(dev, gen):
    """All weights zero: H = λ·1e-6·I, g = 0, a zero step. A NaN point with
    weight 1: the step is not finite and the pose stays, bit for bit."""
    args, _ = _gn_args(gen, dev, 768, 1536)
    q0 = torch.tensor([0.96, 0.1, -0.2, 0.17], device=dev)
    q0 = q0 / q0.norm()
    t0 = torch.tensor([0.3, -0.1, 0.05], device=dev)
    zero = list(args)
    zero[0], zero[1] = q0, t0
    zero[5], zero[10] = torch.zeros_like(args[5]), torch.zeros_like(args[10])
    got = kgn.gn_inner_loop(*zero, n_iters=4)
    _gn_close(got, kgn.gn_inner_loop_plain(*zero, n_iters=4))
    torch.testing.assert_close(got[1], t0, rtol=0, atol=1e-7)
    bad = list(args)
    bad[0], bad[1] = q0, t0
    bad[2] = args[2].clone()
    bad[2][1, 17] = float("nan")
    bad[5] = torch.ones_like(args[5])
    got = kgn.gn_inner_loop(*bad, n_iters=4)
    want = kgn.gn_inner_loop_plain(*bad, n_iters=4)
    for g, w, start in zip(got, want, (q0, t0)):
        assert torch.equal(g, start) and torch.equal(w, start)


def test_gn_inner_loop_second_stream(dev, gen):
    """Launched on a stream of its own, K3 gives the default stream's bits."""
    args, _ = _gn_args(gen, dev, 768, 1536)
    want = kgn.gn_inner_loop(*args, n_iters=4)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = kgn.gn_inner_loop(*args, n_iters=4)
    side.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        kseg.segment_sum_batched(torch.zeros((2, 8), dtype=torch.int64, device=dev),
                                 torch.zeros((2, 4, 8), device=dev), n_segments=3)
    with pytest.raises(ValueError):
        knn_k.associate_kernel(torch.zeros((4, 3), device=dev),
                               torch.zeros((2, 5, 3), device=dev).transpose(0, 1))
    with pytest.raises(ValueError):
        kgn.gn_inner_loop(*[torch.zeros(s, device=dev) for s in
                            ((4,), (3,), (3, 5), (3, 5), (3, 5), (1, 4),
                             (3, 6), (3, 6), (3, 6), (3, 6), (1, 6))])
    with pytest.raises(TypeError):
        kseg.segment_sum(torch.zeros(8, dtype=torch.int64, device=dev),
                         torch.zeros((4, 8), device=dev), n_segments=3)
    pts = torch.zeros((512, 3), device=dev)
    keys = torch.zeros(512, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ktop.block_topk_windowed(pts[:100], keys[:100], pts, keys, q_tile=64)
    with pytest.raises(TypeError):
        ktop.block_topk(pts.double(), pts.double())
    with pytest.raises(TypeError):
        ktop.block_topk(pts.double(), pts.double(), packed=True)
    with pytest.raises(ValueError):
        ktop.block_topk_coords(pts, pts.T)
    with pytest.raises(ValueError):
        knn_k.ring_top2_pallas(pts[:4], torch.zeros((2, 5, 3), device=dev).transpose(0, 1))
    with pytest.raises(ValueError):
        knn_k.ring_top2_coords(pts[:4], torch.zeros((2, 5, 3)))
    img = torch.zeros((48, 160), device=dev)
    uv = torch.zeros((8, 2), device=dev)
    with pytest.raises(ValueError):
        klk.lk_level(img, img, uv, uv, win=13, affine=True, fixed_affine=torch.zeros((8, 4), device=dev))
    with pytest.raises(ValueError):
        klk.lk_level(img[:16], img[:16], uv, uv, win=13)
    with pytest.raises(TypeError):
        klk.lk_level(img, img, uv, uv, torch.ones(8, device=dev), win=13)


# --------------------------------------------------------------------- K9

_SELECT_KW = dict(n_sectors=6, max_less_sharp=20, max_flat=4, edge_gate=0.1, surf_gate=0.1)


def _select_bit_for_bit(args, **kw):
    """K9 in one launch against its plain version on the card: every output
    the same bits, dtypes and shapes."""
    kw = {**_SELECT_KW, **kw}
    kernels.reset_launch_counts()
    got = kfeat.select_features(*args, **kw)
    assert kernels.launch_counts()["feature_select"] == 1
    want = kfeat.select_features_plain(*args, **kw)
    for name, g, w in zip(("corner_picks", "corner_ok", "flat_picks", "flat_ok",
                           "corner_label"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} elements differ"
    return got


def _selection_of(scan, dev):
    """The selection's inputs from a compacted scan, computed on the card."""
    from lidar_visual_odometry_tpu_torch.ops import features as F
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc

    cs = pc.CompactScan(*_on(dev, scan["xyz"], scan["valid"], scan["rel_time"], scan["count"]))
    curv, eligible = F.curvature(cs)
    reach_l, reach_r = F._suppression_reach(cs)
    return cs, (curv, eligible & cs.valid, reach_l, reach_r, cs.count)


@pytest.mark.parametrize("W", [600, 1024, 2048, 5000])
@pytest.mark.parametrize("case", SELECTION)
def test_select_features_matches_plain_bit_for_bit(dev, gen, case, W):
    """Direct inputs: ties, curvatures equal to the gates, NaN, ±inf, −0,
    ±1e30 and beyond, reaches and counts out of range."""
    _select_bit_for_bit(_on(dev, *selection_inputs(case, 64, W, gen)))


def test_select_features_widest_ring_and_other_sizes(dev, gen):
    """MAX_W (the shared-memory opt-in), one ring, and non-default counts."""
    _select_bit_for_bit(_on(dev, *selection_inputs("random", 4, kfeat.MAX_W, gen)))
    _select_bit_for_bit(_on(dev, *selection_inputs("ties_and_gate", 1, 300, gen)))
    _select_bit_for_bit(_on(dev, *selection_inputs("nan_inf_zero", 64, 2048, gen)),
                        n_sectors=4, max_less_sharp=7, max_flat=2, edge_gate=0.05,
                        surf_gate=0.25)
    _select_bit_for_bit(_on(dev, *selection_inputs("random", 64, 2048, gen)), n_sectors=33,
                        max_less_sharp=40, max_flat=37)


@pytest.mark.parametrize("case", CRAFTED)
def test_select_features_crafted_rings_bit_for_bit(dev, case):
    scan, kw = crafted_scan(case, 256)
    _, args = _selection_of(scan, dev)
    kw = {k: v for k, v in kw.items() if k in _SELECT_KW}
    _select_bit_for_bit(args, **kw)


def test_select_features_rendered_scan_one_launch_no_sync(dev):
    """A rendered 64 × 2048 scan: the kernel's picks are the plain version's;
    ``extract_features`` launches K9 once a call and never synchronises."""
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.ops import features as F
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc

    pts = synthetic.SyntheticSequence(n_frames=2, width=1800, noise=0.01).scan(1)
    p, = _on(dev, pts)
    cs = pc.build_compact_scan(p, torch.ones(len(pts), dtype=torch.bool, device=dev),
                               n_scans=64, width=2048, min_range=0.1, max_range=120.0)
    curv, eligible = F.curvature(cs)
    reach_l, reach_r = F._suppression_reach(cs)
    _, cok, _, fok, _ = _select_bit_for_bit((curv, eligible & cs.valid, reach_l, reach_r,
                                             cs.count))
    assert int(cok.sum()) > 1000 and int(fok.sum()) > 500
    F.extract_features(cs)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            feats = F.extract_features(cs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launch_counts()["feature_select"] == 3
    assert int(feats.less_sharp.mask.sum()) == int(cok.sum())


def test_select_features_rejects_bad_input(dev, gen):
    args = _on(dev, *selection_inputs("random", 8, 128, gen))
    with pytest.raises(TypeError):
        kfeat.select_features(args[0].double(), *args[1:], **_SELECT_KW)
    with pytest.raises(TypeError):
        kfeat.select_features(*args[:2], args[2].long(), *args[3:], **_SELECT_KW)
    wide = torch.zeros((8, 256), device=dev)
    with pytest.raises(ValueError):
        kfeat.select_features(wide[:, ::2], *args[1:], **_SELECT_KW)
    with pytest.raises(ValueError):
        kfeat.select_features(args[0], args[1], args[2].T.contiguous().T, *args[3:], **_SELECT_KW)
    big = _on(dev, *selection_inputs("random", 2, kfeat.MAX_W + 1, gen))
    with pytest.raises(ValueError):
        kfeat.select_features(*big, **_SELECT_KW)
    with pytest.raises(ValueError):
        kfeat.select_features(*args[:4], args[4][:4], **_SELECT_KW)
    with pytest.raises(ValueError):
        kfeat.select_features(*args, **{**_SELECT_KW, "max_flat": 0})


def _direct_scene(n_frames=6):
    """The small direct-VO scene of tests/test_torch_direct.py: a 320 × 96
    camera moving 0.35 m and 0.004 rad a frame down the corridor, clouds
    sampled from the rendered depth."""
    from lidar_visual_odometry_tpu_torch.data import synthetic

    cam = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)
    scene = synthetic.BoxScene.corridor(0)
    rng = np.random.default_rng(0)
    imgs, clouds, masks = [], [], []
    for k in range(n_frames):
        R, t = synthetic.camera_from_velodyne_pose(synthetic.yaw_matrix(0.004 * k),
                                                   np.asarray([0.35 * k, 0.0, 1.5]))
        img, depth = synthetic.render_image(scene, R, t, **cam)
        ys, xs = rng.integers(0, 96, 8192), rng.integers(0, 320, 8192)
        z = depth[ys, xs]
        ok = np.isfinite(z)
        z = np.where(ok, z, 1.0)
        clouds.append(np.stack([(xs - 160.0) / 120.0 * z, (ys - 48.0) / 120.0 * z, z],
                               axis=-1).astype(np.float32))
        imgs.append(img.astype(np.float32))
        masks.append(ok)
    return cam, imgs, clouds, masks


@pytest.mark.parametrize("run_ba, tol", [(False, 5e-4), (True, 5e-3)])
def test_direct_vo_chunked_on_the_card_matches_the_cpu(dev, run_ba, tol):
    """The small chunk on the card against the port on the CPU. With the BA
    on, the fifth frame's BA has two iterates whose χ² lie within 2e-5
    (tests/test_torch_direct.py), so a different summation order may keep
    the other one, 3.4e-3 m away."""
    from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked
    from lidar_visual_odometry_tpu_torch.ops.camera import Pinhole
    from lidar_visual_odometry_tpu_torch.utils.config import VisualConfig

    c, imgs, clouds, masks = _direct_scene()
    cfg = VisualConfig(pyramid_levels=3, keyframe_window=3)
    out = {}
    for d in ("cpu", dev):
        cam = Pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                      torch.zeros(5, device=d))
        out[str(d)] = DirectVOChunked(cam, cfg, point_cap=512, run_window_ba=run_ba,
                                      device=d).run_chunked(imgs, clouds, masks, chunk=4)
    (ct, cq, _), (gt, gq, _) = out["cpu"], out[str(dev)]
    assert np.isfinite(gt).all() and gt.shape == (6, 3)
    np.testing.assert_allclose(gt, ct, atol=tol)
    np.testing.assert_allclose(gq, cq, atol=tol)


def _small_system(camera=False):
    """tests/test_torch_drivers.py's lidar configuration (1024 azimuth bins,
    small map caps, the default local caps of the host cube map, which five
    frames do not fill), with tests/test_torch_camlidar.py's 320 × 96 camera
    for the camera paths."""
    from lidar_visual_odometry_tpu_torch.utils import config as C

    kw = dict(lidar=C.LidarConfig(azimuth_bins=1024), odometry=C.OdometryConfig(outer_iters=4),
              mapping=C.MappingConfig(outer_iters=2, gn_iters=4, corner_slot=1024,
                                      surf_slot=1024, map_corner_cap=2048, map_surf_cap=2048))
    if camera:
        r_sc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
        kw.update(
            camera=C.CameraConfig(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96),
            visual=C.VisualConfig(depth_cloud_cap=4096, lk_window=9, lk_levels=3,
                                  lk_reverse_levels=1, lk_iters_coarse=4, max_tracked=128,
                                  grid_rows=4, grid_cols=6),
            extrinsic=C.ExtrinsicConfig(
                matrix=tuple(tuple(float(v) for v in row) + (0.0,) for row in r_sc.T)))
    return C.SystemConfig(**kw)


def _corridor(n=5):
    """Five scans of the corridor at 600 azimuth steps and their 320 × 96
    images."""
    from lidar_visual_odometry_tpu_torch.data import synthetic

    seq = synthetic.SyntheticSequence(n_frames=n, width=600, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    scans = [seq.scan(k) for k in range(n)]
    images = [synthetic.render_image(seq.scene, *synthetic.camera_from_velodyne_pose(*seq.pose(k)),
                                     fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320,
                                     height=96)[0] for k in range(n)]
    return scans, images


@pytest.mark.parametrize("driver", ["odometry", "slam_device_map", "slam_host_map", "camlidar"])
def test_per_frame_drivers_launch_their_kernels(dev, driver):
    """The per-frame drivers on the card: every kernel of their path
    launches (K6 four times a tracked frame), and the positions agree with
    the port on the CPU (the kernels' plain versions) within the CPU tests'
    parity tolerances against the JAX package: 2e-4 m for odometry, 1e-2 m
    mapped, 5e-3 m visual."""
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline

    scans, images = _corridor()
    odometry = ("segment_sum_batched", "associate_kernel", "gn_inner_loop", "feature_select")
    out, counts = {}, None
    for d in (dev, "cpu"):
        kernels.reset_launch_counts()
        if driver == "odometry":
            out[str(d)] = OdometryPipeline(_small_system(), capacity=65536, device=d).run(
                scans).positions
            path = odometry
        elif driver.startswith("slam"):
            out[str(d)] = FullPipeline(_small_system(), capacity=65536,
                                       device_map=driver == "slam_device_map",
                                       device=d).run(scans)[1].positions
            path = odometry + ("segment_sum", "block_topk_windowed")
        else:
            out[str(d)] = CamLidarPipeline(_small_system(camera=True), capacity=65536,
                                           device=d).run(scans, images).visual_positions
            path = odometry + ("lk_level",)
        if counts is None:
            counts = kernels.launch_counts()
    assert min(counts[k] for k in path) > 0, counts
    assert kernels.launch_counts()[path[0]] == 0    # the CPU run launches nothing
    if driver == "camlidar":
        assert counts["lk_level"] == 4 * (len(scans) - 1)
    tol = {"odometry": 2e-4, "camlidar": 5e-3}.get(driver, 1e-2)
    assert np.isfinite(out[str(dev)]).all()
    np.testing.assert_allclose(out[str(dev)], out["cpu"], atol=tol)


@pytest.mark.parametrize("path", ["odometry", "slam", "camlidar", "direct"])
def test_resumed_run_is_bit_for_bit_on_the_card(dev, tmp_path, path):
    """Each ``run_chunked`` with its default ingest, stopped after frame 2 at
    a snapshot and resumed, equals its uninterrupted run on the card bit for
    bit."""
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
    from lidar_visual_odometry_tpu_torch.ops.camera import Pinhole
    from lidar_visual_odometry_tpu_torch.utils.config import VisualConfig

    scans, images = _corridor()

    def run(**kw):
        if path == "odometry":
            r = OdometryPipeline(_small_system(), capacity=65536, device=dev).run_chunked(
                scans, chunk=2, **kw)
            return r.positions, r.quaternions
        if path == "slam":
            o, m = FullPipeline(_small_system(), capacity=65536, device=dev).run_chunked(
                scans, chunk=2, map_skip=1, **kw)
            return o.positions, m.positions, m.quaternions
        if path == "camlidar":
            r = CamLidarPipeline(_small_system(camera=True), capacity=65536,
                                 device=dev).run_chunked(scans, images, chunk=2, **kw)
            return r.lidar_positions, r.visual_positions, r.visual_quats
        c, imgs, clouds, masks = _direct_scene()
        cam = Pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                      torch.zeros(5, device=dev))
        t, q, _ = DirectVOChunked(cam, VisualConfig(pyramid_levels=3, keyframe_window=3),
                                  point_cap=512, device=dev).run_chunked(imgs, clouds, masks,
                                                                         chunk=2, **kw)
        return t, q

    full = run()
    ckpt = str(tmp_path / "run.npz")
    stopped = run(checkpoint_path=ckpt, checkpoint_every=2, stop_after=2)
    resumed = run(checkpoint_path=ckpt, resume=True)
    for f, s, r in zip(full, stopped, resumed, strict=True):
        assert np.isfinite(f).all()
        np.testing.assert_array_equal(s, f[:3])
        np.testing.assert_array_equal(r, f)


@pytest.mark.parametrize("mode", [dict(coupled=True), dict(mapping=True),
                                  dict(coupled=True, mapping=True, map_skip=2)])
def test_coupled_and_mapping_modes_on_the_card_match_the_cpu(dev, mode):
    """``run_chunked`` in the coupled and mapping modes (``camlidar_coupled_chunk``,
    ``camlidar_slam_chunk``) on the card: every kernel of the path launches
    (K6 four times a tracked frame), and the trajectories agree with the
    port on the CPU within the CPU tests' parity tolerances against the JAX
    package (tests/test_torch_coupled*.py): 2e-3 m lidar, 5e-3 m visual,
    1e-2 m mapped."""
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline

    scans, images = _corridor()
    out = {}
    for d in (dev, "cpu"):
        kernels.reset_launch_counts()
        out[str(d)] = CamLidarPipeline(_small_system(camera=True), capacity=65536,
                                       device=d).run_chunked(scans, images, chunk=2,
                                                             ingest="polar2", **mode)
        if d == dev:
            counts = kernels.launch_counts()
    path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop", "lk_level")
    if mode.get("mapping"):
        path += ("segment_sum", "block_topk_windowed")
    assert min(counts[k] for k in path) > 0, counts
    assert counts["lk_level"] == 4 * (len(scans) - 1)
    card, cpu = out[str(dev)], out["cpu"]
    names = ("lidar_positions", 2e-3), ("visual_positions", 5e-3), ("mapped_positions", 1e-2)
    for name, tol in names[:3 if mode.get("mapping") else 2]:
        assert np.isfinite(getattr(card, name)).all(), name
        np.testing.assert_allclose(getattr(card, name), getattr(cpu, name), atol=tol,
                                   err_msg=name)


def test_solve_window_on_the_card_matches_the_cpu(dev, gen):
    """One window solve (eight states, six iterations, the Jacobian by
    ``torch.func.jacfwd``) on CUDA tensors against the same call on CPU
    tensors: float32 Cholesky factorisations with 1e8 on the prior's
    diagonal, 1e-4 apart."""
    from lidar_visual_odometry_tpu_torch.models import backend
    from lidar_visual_odometry_tpu_torch.ops import se3

    def unit(n):
        q = gen.normal(size=(n, 4))
        q[:, 0] += 8.0
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)

    k = 8
    arrays = dict(q=unit(k), p=gen.normal(size=(k, 3)), v=gen.normal(size=(k, 3)),
                  dq=unit(k - 1), dv=gen.normal(size=(k - 1, 3)), dp=gen.normal(size=(k - 1, 3)),
                  dt=np.full(k - 1, 0.1), rq=unit(k - 1), rt=0.5 * gen.normal(size=(k - 1, 3)))
    out = {}
    for d in ("cpu", dev):
        t = {name: torch.tensor(a, dtype=torch.float32, device=d) for name, a in arrays.items()}
        out[str(d)] = backend.solve_window(
            backend.WindowState(t["q"], t["p"], t["v"]),
            backend.ImuDelta(t["dq"], t["dv"], t["dp"], t["dt"]), se3.Pose(t["rq"], t["rt"]),
            imu_weight=1.0, odom_weight=20.0, n_iters=6)
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert b.is_cuda and torch.isfinite(b).all()
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-4)


def test_gloo_fleet_on_the_card(dev):
    """Two gloo ranks on the one card with CUDA tensors (NCCL refuses two
    ranks on one GPU), started by ``parallel.launch``: the distributed SLAM
    driver on ``tests/test_parallel.py``'s 4-frame sequence. The ranks agree
    within 1e-6 and lie within 5e-4 m (odometry) and 5e-3 m (mapped) of
    ``FullPipeline(device_map=False).run`` on the card (``test_parallel.py``'s
    bounds)."""
    import os

    import _torch_mp_worker as W
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline
    from lidar_visual_odometry_tpu_torch.parallel import launch

    seq = synthetic.SyntheticSequence(n_frames=4, width=900, noise=0.005)
    scans = [seq.scan(k) for k in range(4)]
    ranks = launch.launch("_torch_mp_worker:slam", 2,
                          {"n": np.int64(4), **{f"scan{k}": s for k, s in enumerate(scans)}},
                          backend="gloo", device="cuda",
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    for key in ("odom", "mapped"):
        np.testing.assert_allclose(ranks[0][key], ranks[1][key], atol=1e-6, err_msg=key)
    odo, mapped = FullPipeline(W.SLAM_CFG, capacity=W.SLAM_CAPACITY, device_map=False,
                               device=dev).run(scans)
    np.testing.assert_allclose(ranks[0]["odom"], odo.positions, atol=5e-4)
    np.testing.assert_allclose(ranks[0]["mapped"], mapped.positions, atol=5e-3)


def test_chunked_knn_distances_do_not_depend_on_the_blocks(dev, gen):
    """The sharded scan-to-map step's search on the card at its shapes (8192
    surf queries, a 32768-point submap, 2048-column chunks): a pair's
    distance is the same bits whatever the block around it, so the k best of
    two rank blocks, merged by (distance, block, slot), are the k best of the
    whole submap, and another chunk width gives the same bits."""
    from lidar_visual_odometry_tpu_torch.ops import knn

    q, c = _on(dev, gen.normal(0, 20, (8192, 3)).astype(np.float32),
               gen.normal(0, 20, (32768, 3)).astype(np.float32))
    (mask,) = _on(dev, gen.uniform(size=32768) < 0.7)
    want_i, want_d = knn.knn(q, c, mask, 5, chunk=2048)
    got_i, got_d = knn.knn(q, c, mask, 5, chunk=1000)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    parts = []
    for b in range(2):
        i, d = knn.knn(q, c[b * 16384:(b + 1) * 16384], mask[b * 16384:(b + 1) * 16384], 5,
                       chunk=2048)
        parts.append(torch.stack([d, (i + b * 16384).to(torch.float32)], -1))
    cand = torch.stack(parts, 1).reshape(8192, 10, 2)
    sel, merged_d = knn._smallest_k(cand[..., 0], 5)
    assert torch.equal(merged_d, want_d)
    assert torch.equal(cand[..., 1].gather(1, sel).to(torch.int64), want_i)
