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


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_matches_plain(dev, gen, sorted_ids):
    seg = gen.integers(0, 513, (64, 2048))
    if sorted_ids:
        seg = np.sort(seg, axis=1)
    seg, vals = _on(dev, seg.astype(np.int32),
                    gen.normal(size=(64, 4, 2048)).astype(np.float32))
    kernels.reset_launch_counts()
    got = kseg.segment_sum_batched(seg, vals, n_segments=513)
    assert kernels.launch_counts()["segment_sum_batched"] == 1
    # sums of the same values in another fixed order (the plain version adds
    # with atomics on the card): rtol 1e-5, atol 1e-4 for |v| ≲ 4
    torch.testing.assert_close(got, kseg.segment_sum_batched_plain(seg, vals, n_segments=513),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("W", [32768, 7680, 100])
def test_flat_segment_sum_matches_plain(dev, gen, W):
    """The mapping voxel filter's flat sum: non-decreasing run ids with the
    masked points (zero values) in the overflow bucket S - 1, and ids in no
    order."""
    S = 4097
    n_valid = W * 3 // 4
    seg = np.full(W, S - 1, np.int32)
    seg[:n_valid] = np.minimum(np.cumsum(gen.uniform(size=n_valid) < 0.4), S - 1)
    vals = gen.normal(scale=30.0, size=(4, W)).astype(np.float32)
    vals[:, n_valid:] = 0.0             # masked points carry zeros, as on the path
    for ids in (seg, gen.integers(-1, S + 1, W).astype(np.int32)):
        ids_t, vals_t = _on(dev, ids, vals)
        kernels.reset_launch_counts()
        got = kseg.segment_sum(ids_t, vals_t, n_segments=S)
        counts = kernels.launch_counts()
        assert counts["segment_sum"] == 1 and counts["segment_sum_batched"] == 0
        # the same values summed per row of 2048 points and then over rows,
        # against one scatter-add (atomics on the card): rtol 1e-5, atol 1e-3
        # for sums of up to W values of |v| ≲ 100
        torch.testing.assert_close(got, kseg.segment_sum_plain(ids_t, vals_t, n_segments=S),
                                   rtol=1e-5, atol=1e-3)


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
