"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so that on a machine with a card and without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu_torch import kernels
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
    # its own: identical flags and iteration counts; displacements within
    # the stated tolerance (median 1e-4 px, max 2·eps + 1e-4 px)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[-1], want[-1], rtol=0, atol=0)
    diff = (got[0] - want[0]).abs()
    assert float(diff.median()) <= 1e-4 and float(diff.max()) <= 2 * eps + 1e-4, diff.max()
    if affine:
        assert float((got[2] - want[2]).abs().max()) <= 1e-3


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
