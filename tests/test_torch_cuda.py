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
from lidar_visual_odometry_tpu_torch.kernels import nn as knn_k
from lidar_visual_odometry_tpu_torch.kernels import segsum as kseg

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


@pytest.mark.parametrize("B", [120, 512, 1])
def test_associate_matches_plain(dev, gen, B):
    c, m, q = _on(dev, gen.normal(size=(64, B, 3)).astype(np.float32) * 8,
                  gen.uniform(size=(64, B)) > 0.2,
                  gen.normal(size=(768, 3)).astype(np.float32) * 8)
    baked = knn_k.bake_mask(c, m).contiguous()
    # same distances bit for bit, same tie rules → the same winners
    torch.testing.assert_close(knn_k.associate_kernel(q, baked),
                               knn_k.associate_kernel_plain(q, baked), rtol=0, atol=0)


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
