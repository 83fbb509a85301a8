"""K1's ordered reference, ``kernels.segsum.segment_sum_run_order``.

The CUDA kernel (``csrc/segsum.cu``) sums each run of equal ids in a fixed
order: lane ``l`` of a warp adds the run's positions ``l, l+32, …`` in
ascending order, and a butterfly of offsets 16, 8, 4, 2, 1 adds the lanes.
``segment_sum_run_order`` is that order in PyTorch; the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold both kernel forms to
it bit for bit. Here, on the CPU, it is held to a loop written out lane by
lane, to the plain scatter-add and to the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.ops import pallas_segsum
from lidar_visual_odometry_tpu_torch.kernels import segsum as kseg


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lane_loop(seg, vals, S, piece=None):
    """The kernel's order written out: for each run (cut into pieces at
    multiples of ``piece`` points, if given), 32 lane sums in float32, then
    the butterfly's pairwise tree for lane 0; the pieces added in turn."""
    R, C, W = vals.shape
    out = np.zeros((R, C, S), np.float32)
    for r in range(R):
        w = 0
        while w < W:
            e = w
            while e < W and seg[r, e] == seg[r, w]:
                e += 1
            if 0 <= seg[r, w] < S:
                cuts = [w] + [x for x in range(w + 1, e) if piece and x % piece == 0] + [e]
                for c in range(C):
                    total = np.float32(0.0)
                    for pb, pe in zip(cuts[:-1], cuts[1:]):
                        a = np.zeros(32, np.float32)
                        for p in range(pe - pb):
                            a[p % 32] = np.float32(a[p % 32] + vals[r, c, pb + p])
                        for o in (16, 8, 4, 2, 1):
                            a[:o] = a[:o] + a[o:2 * o]
                        total = np.float32(total + a[0])
                    out[r, c, seg[r, w]] = total
            w = e
    return out


def _sorted_rows(rng, R, W, S, long_run):
    """Sorted ids with runs of a few points, ids out of [0, S) at both ends,
    and in row 0 one run of ``long_run`` points."""
    seg = np.sort(rng.integers(-2, S + 2, (R, W)), axis=1).astype(np.int32)
    if long_run:
        mid = int(seg[0, W // 2])
        seg[0, W // 2:W // 2 + long_run] = mid
        seg[0] = np.maximum.accumulate(seg[0])
    return seg


@pytest.mark.parametrize("long_run", [0, 32, 33, 100, 700])
def test_run_order_matches_the_lane_loop(rng, long_run):
    seg = _sorted_rows(rng, 3, 1024, 40, long_run)
    vals = (rng.normal(size=(3, 4, 1024)) * 1e3).astype(np.float32)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=40)
    np.testing.assert_array_equal(got.numpy(), _lane_loop(seg, vals, 40))


@pytest.mark.parametrize("start,length", [(2046, 5), (2030, 40), (1000, 3300)])
def test_flat_run_order_adds_pieces_of_2048(rng, start, length):
    """The flat form cuts runs at multiples of FLAT_PIECE points: a short run
    across one cut, a long run across one, a run across two; and a short
    run across the cut at 4096."""
    W, S = 6144, 300
    seg = np.sort(rng.integers(0, S, W)).astype(np.int32)
    for b, n in ((start, length), (4094, 5)):
        seg[b:b + n] = seg[b]
    seg = np.maximum.accumulate(seg)
    vals = (rng.normal(size=(4, W)) * 1e3).astype(np.float32)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=S)
    assert kseg.FLAT_PIECE == 2048
    np.testing.assert_array_equal(got.numpy(), _lane_loop(seg[None], vals[None], S, 2048)[0])


def test_flat_run_order_of_four_points_across_a_cut():
    """Positions 2046-2049 in one run: the flat form adds (v0 + v1) +
    (v2 + v3), pieces cut at 2048; the batched form's one tree is
    (v0 + v2) + (v1 + v3). With v0 = v2 = 2^-24, v1 = 1, v3 = 0 the first
    gives 1, the second 1 + 2^-23."""
    tiny = np.float32(2.0 ** -24)
    seg = np.zeros(2050, np.int32)
    seg[2046:] = 1
    vals = np.zeros((1, 2050), np.float32)
    vals[0, 2046:] = [tiny, 1.0, tiny, 0.0]
    flat = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=2)
    rows = kseg.segment_sum_run_order(_t(seg[None]), _t(vals[None]), n_segments=2)
    assert flat[0, 1].item() == 1.0
    assert rows[0, 0, 1].item() == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("R,W,S", [(4, 2048, 513), (1, 4096, 257), (2, 100, 7)])
def test_run_order_equals_plain_on_a_grid(rng, R, W, S):
    """Values on a 1/8 grid: every partial sum is exact, so every order of
    addition gives the same bits."""
    seg = _sorted_rows(rng, R, W, S, long_run=min(W // 3, 600))
    vals = (rng.integers(-800, 800, (R, 4, W)) / 8).astype(np.float32)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=S)
    torch.testing.assert_close(
        got, kseg.segment_sum_batched_plain(_t(seg), _t(vals), n_segments=S), rtol=0, atol=0)
    flat = kseg.segment_sum_run_order(_t(seg[0]), _t(vals[0]), n_segments=S)
    torch.testing.assert_close(
        flat, kseg.segment_sum_plain(_t(seg[0]), _t(vals[0]), n_segments=S), rtol=0, atol=0)


def test_run_order_equals_pallas_on_a_grid(rng):
    seg = np.clip(_sorted_rows(rng, 4, 2048, 513, long_run=900), 0, 512)
    vals = (rng.integers(-800, 800, (4, 4, 2048)) / 8).astype(np.float32)
    want = pallas_segsum.segment_sum_batched(
        jnp.asarray(seg), jnp.asarray(vals), n_segments=513, interpret=True)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=513)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_order_agrees_with_plain_on_random_values(rng):
    """Sums of the same values in another order: float32 rounding only."""
    seg = _sorted_rows(rng, 8, 2048, 513, long_run=1200)
    vals = rng.normal(scale=30.0, size=(8, 4, 2048)).astype(np.float32)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=513)
    want = kseg.segment_sum_batched_plain(_t(seg), _t(vals), n_segments=513)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_run_order_of_three_points():
    """A 3-point run sums as (v0 + v2) + v1: positions 0 and 2 meet at the
    butterfly's offset-2 step, position 1 at the offset-1 step. With v1 = 1
    and v0 = v2 = 2^-24 that is 1 + 2^-23; adding in point order would round
    twice to 1."""
    tiny = np.float32(2.0 ** -24)
    vals = np.array([[[tiny, 1.0, tiny]]], np.float32)
    seg = np.zeros((1, 3), np.int32)
    got = kseg.segment_sum_run_order(_t(seg), _t(vals), n_segments=1)
    assert got.item() == (tiny + tiny) + np.float32(1.0) == 1.0 + 2.0 ** -23
    assert np.float32(np.float32(tiny + np.float32(1.0)) + tiny) == 1.0


def test_run_order_refuses_unsorted_ids():
    with pytest.raises(ValueError):
        kseg.segment_sum_run_order(_t(np.array([[0, 2, 1]], np.int32)),
                                   _t(np.ones((1, 1, 3), np.float32)), n_segments=3)
