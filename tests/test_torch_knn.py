"""The port's k-NN entry points off the product path against the JAX package
on the CPU: kernel K7 (``ring_top2_pallas`` / ``ring_top2_coords``), K8
(``block_topk_coords``) and K5p (``block_topk(packed=True)``) as plain
versions against the Pallas kernels in interpret mode, and the ring-blocked
and dense associations of ``ops/knn.py`` against the JAX functions (XLA on the
CPU).

In interpret mode XLA's CPU code contracts the kernels' distance
``dx·dx + dy·dy + dz·dz`` into fused multiply-adds, where the port rounds each
operation alone: on random inputs distances then differ by up to 2 ulp (two contracted
operations). On
inputs whose coordinates are multiples of 1/8 every product and sum is exact,
so there the two agree bit for bit, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import pallas_nn
from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.kernels import nn as knn_k
from lidar_visual_odometry_tpu_torch.kernels import topk as ktop
from lidar_visual_odometry_tpu_torch.ops import knn

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(rng, shape, reach=24):
    """Coordinates on a 1/8 grid within ±reach: every distance is exact."""
    return (rng.integers(-8 * reach, 8 * reach + 1, shape) / 8.0).astype(np.float32)


def _baked(c, m):
    return np.asarray(pallas_nn.bake_mask(jnp.asarray(c), jnp.asarray(m)))


# --------------------------------------------------------------------- K7


@pytest.mark.parametrize("R,B,Q", [(16, 128, 96), (8, 120, 64)])
def test_ring_top2_plain_matches_pallas(rng, R, B, Q):
    c = rng.normal(size=(R, B, 3)).astype(np.float32) * 8
    m = rng.uniform(size=(R, B)) > 0.2
    m[3] = False                                    # a ring with no candidate
    q = rng.normal(size=(Q, 3)).astype(np.float32) * 8
    baked = _baked(c, m)
    d_j, i_j = pallas_nn.ring_top2_pallas(jnp.asarray(q), jnp.asarray(baked), interpret=True)
    dc_j, c1_j, c2_j = pallas_nn.ring_top2_coords(jnp.asarray(q), jnp.asarray(baked),
                                                  interpret=True)
    kernels.reset_launch_counts()
    d_t, i_t = knn_k.ring_top2_pallas(_t(q), _t(baked))
    dc_t, c1_t, c2_t = knn_k.ring_top2_coords(_t(q), _t(baked))
    counts = kernels.launch_counts()
    assert counts["ring_top2_pallas"] == counts["ring_top2_coords"] == 0   # the CPU runs plain

    assert i_t.dtype == torch.int32 and d_t.shape == (Q, R, 2) and c1_t.shape == (Q, R, 3)
    # the same winners; distances within 2 ulp (the fused multiply-adds of
    # XLA's CPU code, module note)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_max_ulp(d_t.numpy(), np.asarray(d_j), maxulp=2)
    np.testing.assert_array_equal(dc_t.numpy(), d_t.numpy())
    np.testing.assert_array_max_ulp(dc_t.numpy(), np.asarray(dc_j), maxulp=2)
    # coordinates: the winners' own, exactly (the one-hot products are exact)
    flat = baked.reshape(-1, 3)
    np.testing.assert_array_equal(c1_t.numpy(), np.asarray(c1_j))
    np.testing.assert_array_equal(c2_t.numpy(), np.asarray(c2_j))
    np.testing.assert_array_equal(c1_t.numpy(), flat[i_t.numpy()[..., 0]])


def test_ring_top2_bit_for_bit_on_grid(rng):
    """Exact distances, many ties: distances and indices bit for bit, first
    index on ties within a ring."""
    R, B, Q = 8, 128, 64
    c = _grid(rng, (R, B, 3), reach=3)
    q = _grid(rng, (Q, 3), reach=3)
    d_j, i_j = pallas_nn.ring_top2_pallas(jnp.asarray(q), jnp.asarray(c), interpret=True)
    _, c1_j, c2_j = pallas_nn.ring_top2_coords(jnp.asarray(q), jnp.asarray(c), interpret=True)
    d_t, i_t = knn_k.ring_top2_pallas(_t(q), _t(c))
    _, c1_t, c2_t = knn_k.ring_top2_coords(_t(q), _t(c))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(c1_t.numpy(), np.asarray(c1_j))
    np.testing.assert_array_equal(c2_t.numpy(), np.asarray(c2_j))
    assert int((d_t[..., 0] == d_t[..., 1]).sum()) > 0          # ties were exercised


def test_ring_top2_ties_and_single_candidate_rings():
    """Ties go to the first index of a ring; with B = 1 the runner-up is the
    TPU kernel's (1e30, the ring's first index) and its coordinates the
    winner's."""
    c = np.array([[[1.0, 0, 0], [-1.0, 0, 0], [0, 2.0, 0]],
                  [[0, 0, 3.0], [0, 1.0, 0], [0, -1.0, 0]]], np.float32)
    d, i = knn_k.ring_top2_pallas(torch.zeros((1, 3)), _t(c))
    np.testing.assert_array_equal(i.numpy(), [[[0, 1], [4, 5]]])
    np.testing.assert_array_equal(d.numpy(), [[[1.0, 1.0], [1.0, 1.0]]])
    c1 = c[:, :1]
    q = np.array([[0.5, 0, 0]], np.float32)
    d, i = knn_k.ring_top2_pallas(_t(q), _t(c1))
    dc, k1, k2 = knn_k.ring_top2_coords(_t(q), _t(c1))
    d_j, i_j = pallas_nn.ring_top2_pallas(jnp.asarray(q), jnp.asarray(c1), interpret=True)
    _, k1_j, k2_j = pallas_nn.ring_top2_coords(jnp.asarray(q), jnp.asarray(c1), interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(i.numpy(), [[[0, 0], [1, 1]]])
    assert d[0, 0, 1] == np.float32(1e30)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(k2_j))
    np.testing.assert_array_equal(k2.numpy(), k1.numpy())


#: rings whose candidates other than the winner lie at or above 1e30 in
#: squared distance from the origin: (ring, winner's index, its distance)
RUNNER_UP_AT_1E30 = {
    "far": ([(2e15, 0, 0), (1, 0, 0), (2e15, 0, 0)], 1, 1.0),
    "overflow": ([(1e20, 0, 0), (0, 0.5, 0), (1e20, 0, 0)], 1, 0.25),   # 1e40: +inf
    "winner first": ([(0, 0, 1), (2e15, 0, 0), (2e15, 0, 0)], 0, 1.0),
    "all overflow": ([(1e20, 0, 0), (0, 1e20, 0), (0, 0, 1e20)], 0, np.inf),
}


@pytest.mark.parametrize("case", sorted(RUNNER_UP_AT_1E30))
def test_ring_top2_runner_up_at_1e30(case):
    """The TPU kernel's runner-up when no other candidate of the ring is below
    1e30: the winner's slot set to 1e30, then the first arg-min, which is the
    winner itself, so (1e30, the winner's index) and the winner's coordinates.
    The inputs are exact (one nonzero component a difference), so the plain
    versions give the interpret-mode kernel's bits."""
    ring, win, d_win = RUNNER_UP_AT_1E30[case]
    c = np.array([ring, [(0, 0, 0.5), (0, 3, 0), (0, 0, -0.5)]], np.float32)
    q = np.zeros((2, 3), np.float32)
    d_j, i_j = pallas_nn.ring_top2_pallas(jnp.asarray(q), jnp.asarray(c), interpret=True)
    dc_j, c1_j, c2_j = pallas_nn.ring_top2_coords(jnp.asarray(q), jnp.asarray(c), interpret=True)
    d, i = knn_k.ring_top2_pallas_plain(_t(q), _t(c))
    dc, c1, c2 = knn_k.ring_top2_coords_plain(_t(q), _t(c))
    for got, want in ((d, d_j), (i, i_j), (dc, dc_j), (c1, c1_j), (c2, c2_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(d.numpy()[0], np.float32([[d_win, 1e30], [0.25, 0.25]]))
    np.testing.assert_array_equal(i.numpy()[0], [[win, win], [3, 5]])
    np.testing.assert_array_equal(c2.numpy()[:, 0], c1.numpy()[:, 0])


# -------------------------------------------------- ring-blocked and dense


def _assoc_case(rng, R=16, B=32, Q=64):
    c = rng.normal(size=(R * B, 3)).astype(np.float32) * 4
    cm = rng.uniform(size=R * B) > 0.2
    q = rng.normal(size=(Q, 3)).astype(np.float32) * 4
    qm = rng.uniform(size=Q) > 0.1
    rings = np.repeat(np.arange(R, dtype=np.int32), B)
    return c, cm, q, qm, rings, (R, B)


def test_ringblocked_association_matches_jax(rng):
    """The port's ring-blocked associations (K7's plain version on baked
    candidates) against the JAX functions on the CPU (its XLA ``ring_top2``:
    matrix-product distances, masked slots at 1e30). No gate and no winner
    flips on these inputs: equal valid masks, equal indices where valid."""
    c, cm, q, qm, _, (R, B) = _assoc_case(rng)
    cb, mb = c.reshape(R, B, 3), cm.reshape(R, B)
    args_j = (jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cb), jnp.asarray(mb))
    args_t = (_t(q), _t(qm), _t(cb), _t(mb))
    ea_j, ea_t = jknn.associate_edges_ringblocked(*args_j), knn.associate_edges_ringblocked(*args_t)
    v = np.asarray(ea_j.valid)
    np.testing.assert_array_equal(ea_t.valid.numpy(), v)
    assert v.sum() > 20
    for a, b in ((ea_j.j0, ea_t.j0), (ea_j.j2, ea_t.j2)):
        np.testing.assert_array_equal(b.numpy()[v], np.asarray(a)[v])
    pa_j, pa_t = jknn.associate_planes_ringblocked(*args_j), knn.associate_planes_ringblocked(*args_t)
    v = np.asarray(pa_j.valid)
    np.testing.assert_array_equal(pa_t.valid.numpy(), v)
    assert v.sum() > 20
    for a, b in ((pa_j.j0, pa_t.j0), (pa_j.j2, pa_t.j2), (pa_j.j3, pa_t.j3)):
        np.testing.assert_array_equal(b.numpy()[v], np.asarray(a)[v])


def test_dense_association_matches_jax(rng):
    """``associate_edges`` / ``associate_planes`` over a flat cloud with
    rings: the same matrix-product distances (rounded by another product
    routine) and masked arg-mins; equal valid masks and indices where valid."""
    c, cm, q, qm, rings, _ = _assoc_case(rng)
    args_j = tuple(jnp.asarray(a) for a in (q, qm, c, rings, cm))
    args_t = tuple(_t(a) for a in (q, qm, c, rings, cm))
    ea_j, ea_t = jknn.associate_edges(*args_j), knn.associate_edges(*args_t)
    v = np.asarray(ea_j.valid)
    np.testing.assert_array_equal(ea_t.valid.numpy(), v)
    for a, b in ((ea_j.j0, ea_t.j0), (ea_j.j2, ea_t.j2)):
        np.testing.assert_array_equal(b.numpy()[v], np.asarray(a)[v])
    pa_j, pa_t = jknn.associate_planes(*args_j), knn.associate_planes(*args_t)
    v = np.asarray(pa_j.valid)
    np.testing.assert_array_equal(pa_t.valid.numpy(), v)
    for a, b in ((pa_j.j0, pa_t.j0), (pa_j.j2, pa_t.j2), (pa_j.j3, pa_t.j3)):
        np.testing.assert_array_equal(b.numpy()[v], np.asarray(a)[v])
    # and the ring-blocked form finds the same neighbours as the dense one
    R, B = 16, 32
    blk = knn.associate_planes_ringblocked(_t(q), _t(qm), _t(c.reshape(R, B, 3)),
                                           _t(cm.reshape(R, B)))
    np.testing.assert_array_equal(blk.valid.numpy(), v)
    np.testing.assert_array_equal(blk.j3.numpy()[v], pa_t.j3.numpy()[v])


def test_ring_top2_xla_form_matches_jax(rng):
    """The matrix-product ``ring_top2``: the same indices everywhere (masked
    slots included); distances within the products' cancellation, 1e-4 m²
    at |q|², |c|² ≲ 500 m²."""
    c, cm, q, _, _, (R, B) = _assoc_case(rng)
    d_j, i_j = jknn.ring_top2(jnp.asarray(q), jnp.asarray(c.reshape(R, B, 3)),
                              jnp.asarray(cm.reshape(R, B)))
    d_t, i_t = knn.ring_top2(_t(q), _t(c.reshape(R, B, 3)), _t(cm.reshape(R, B)))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-4)


def test_coords_from_ring_top2_match_indices_and_k2(rng):
    """``associate_*_coords_top2`` (K7's coordinate form) against the
    ring-blocked indices (K7's index form), the odometry path's K2 and the
    JAX ``associate_*_coords`` (its XLA branch): equal valid masks and equal
    coordinates where valid, as tests/test_knn_extra.py holds the JAX side."""
    c, cm, q, qm, _, (R, B) = _assoc_case(rng)
    cb, mb = c.reshape(R, B, 3), cm.reshape(R, B)
    args_t = (_t(q), _t(qm), _t(cb), _t(mb))
    args_j = tuple(jnp.asarray(a) for a in (q, qm, cb, mb))
    flat = c                                         # valid slots are never baked

    ea_i = knn.associate_edges_ringblocked(*args_t)
    ea_c = knn.associate_edges_coords_top2(*args_t)
    ea_k = knn.associate_edges_coords(*args_t)
    ea_j = jknn.associate_edges_coords(*args_j)
    v = ea_i.valid.numpy()
    for other in (ea_c.valid, ea_k.valid):
        np.testing.assert_array_equal(other.numpy(), v)
    np.testing.assert_array_equal(np.asarray(ea_j.valid), v)
    for idx, name in ((ea_i.j0, "a"), (ea_i.j2, "b")):
        want = flat[idx.numpy()][v]
        for got in (ea_c, ea_k):
            np.testing.assert_array_equal(getattr(got, name).numpy()[v], want)
        np.testing.assert_array_equal(np.asarray(getattr(ea_j, name))[v], want)

    pa_i = knn.associate_planes_ringblocked(*args_t)
    pa_c = knn.associate_planes_coords_top2(*args_t)
    pa_k = knn.associate_planes_coords(*args_t)
    pa_j = jknn.associate_planes_coords(*args_j)
    v = pa_i.valid.numpy()
    for other in (pa_c.valid, pa_k.valid):
        np.testing.assert_array_equal(other.numpy(), v)
    np.testing.assert_array_equal(np.asarray(pa_j.valid), v)
    for idx, name in ((pa_i.j0, "j"), (pa_i.j2, "l"), (pa_i.j3, "m")):
        want = flat[idx.numpy()][v]
        for got in (pa_c, pa_k):
            np.testing.assert_array_equal(getattr(got, name).numpy()[v], want)
        np.testing.assert_array_equal(np.asarray(getattr(pa_j, name))[v], want)


def test_masked_argmin_matches_jax(rng):
    d = rng.normal(size=(16, 40)).astype(np.float32)
    d[:, 7] = d[:, 3]                                # ties go to the first index
    m = rng.uniform(size=(16, 40)) > 0.5
    m[0] = False                                     # a row with nothing left
    for mask in (None, m):
        i_j, v_j = jknn.masked_argmin(jnp.asarray(d), None if mask is None else jnp.asarray(mask))
        i_t, v_t = knn.masked_argmin(_t(d), None if mask is None else _t(mask))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


# --------------------------------------------------------------- K8, K5p


def _topk_case(rng, Q=256, C=1024, grid=False):
    if grid:
        q, c = _grid(rng, (Q, 3), reach=4), _grid(rng, (C, 3), reach=4)
    else:
        q = rng.normal(size=(Q, 3)).astype(np.float32) * 10
        c = rng.normal(size=(C, 3)).astype(np.float32) * 10
    mask = rng.uniform(size=C) > 0.3
    return q, _baked(c, mask)


def test_block_topk_coords_plain_matches_pallas(rng):
    """tests/test_pallas_gn.py's shapes and tiles (q_tile 128, c_tile 256;
    the port takes no tiles): the same neighbours, their coordinates exactly,
    distances within 2 ulp."""
    q, baked = _topk_case(rng)
    d_j, c_j = pallas_nn.block_topk_coords(jnp.asarray(q), jnp.asarray(baked), k=5, q_tile=128,
                                           c_tile=256, interpret=True)
    kernels.reset_launch_counts()
    d_t, c_t = ktop.block_topk_coords(_t(q), _t(baked), k=5)
    assert kernels.launch_counts()["block_topk_coords"] == 0
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_max_ulp(d_t.numpy(), np.asarray(d_j), maxulp=2)
    # K5's slots with coordinates
    d5, i5 = ktop.block_topk(_t(q), _t(baked), k=5)
    np.testing.assert_array_equal(d_t.numpy(), d5.numpy())
    np.testing.assert_array_equal(c_t.numpy(), baked[i5.numpy()])


@pytest.mark.parametrize("grid", [False, True])
def test_block_topk_packed_plain_matches_pallas(rng, grid):
    """Packed keys: indices and quantised distances exact (on the grid the
    cut distances tie often; ties go to the lower index on both sides)."""
    q, baked = _topk_case(rng, grid=grid)
    d_j, i_j = pallas_nn.block_topk(jnp.asarray(q), jnp.asarray(baked), k=5, q_tile=128,
                                    c_tile=256, interpret=True, packed=True)
    kernels.reset_launch_counts()
    d_t, i_t = ktop.block_topk(_t(q), _t(baked), k=5, packed=True)
    counts = kernels.launch_counts()
    assert counts["block_topk_packed"] == counts["block_topk"] == 0
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    # each slot's distance is K5's cut to its top 8 mantissa bits
    d5, _ = ktop.block_topk(_t(q), _t(baked), k=5)
    np.testing.assert_array_equal(d_t.numpy().view(np.int32),
                                  d5.numpy().view(np.int32) & ~0x7FFF)


def test_block_topk_packed_tie_rule_and_sentinel():
    """The key orders by the cut distance, then the index; slots no candidate
    fills hold the packed 1e30 (index 0x7FFF)."""
    one_up = np.nextafter(np.float32(1.0), np.float32(2.0))
    c = np.array([[one_up, 0, 0], [1.0, 0, 0], [0, 0, 2.0]], np.float32)
    q = np.zeros((8, 3), np.float32)
    d, i = ktop.block_topk(_t(q), _t(c), k=2, packed=True)
    np.testing.assert_array_equal(i.numpy(), [[0, 1]] * 8)          # K5 has [1, 0]
    np.testing.assert_array_equal(d.numpy(), 1.0)
    assert ktop.block_topk(_t(q), _t(c), k=2)[1][0].tolist() == [1, 0]
    d_j, i_j = pallas_nn.block_topk(jnp.asarray(q), jnp.asarray(c), k=4, q_tile=8, c_tile=3,
                                    interpret=True, packed=True)
    d, i = ktop.block_topk(_t(q), _t(c), k=4, packed=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    assert i[0, 3] == 0x7FFF and d.numpy()[0, 3].view(np.int32) == ktop.PACKED_SENTINEL & ~0x7FFF
    # two slots short: the port repeats the sentinel; the TPU kernel's
    # equality mask takes every sentinel copy out at once and returns INT_MAX
    # (a NaN distance) from the second empty slot on
    d, i = ktop.block_topk(_t(q), _t(c), k=5, packed=True)
    np.testing.assert_array_equal(i.numpy()[:, 3:], 0x7FFF)
    np.testing.assert_array_equal(d.numpy()[:, 3:].view(np.int32), ktop.PACKED_SENTINEL & ~0x7FFF)
    d_j, i_j = pallas_nn.block_topk(jnp.asarray(q), jnp.asarray(c), k=5, q_tile=8, c_tile=3,
                                    interpret=True, packed=True)
    assert np.isnan(np.asarray(d_j)[0, 4]) and np.asarray(i_j)[0, 4] == 0x7FFF
    np.testing.assert_array_equal(d.numpy()[:, :4], np.asarray(d_j)[:, :4])


def test_block_topk_packed_above_32768_is_unpacked(rng):
    """C > 32768 leaves no room for the index: the call is the unpacked one
    (exact distances), as in the reference, and launches nothing here."""
    C = 32769
    c = _grid(rng, (C, 3), reach=16)
    q = _grid(rng, (8, 3), reach=16)
    kernels.reset_launch_counts()
    d, i = ktop.block_topk(_t(q), _t(c), k=5, packed=True)
    assert set(kernels.launch_counts().values()) == {0}
    d5, i5 = ktop.block_topk(_t(q), _t(c), k=5)
    np.testing.assert_array_equal(d.numpy(), d5.numpy())
    np.testing.assert_array_equal(i.numpy(), i5.numpy())
    d_j, i_j = pallas_nn.block_topk(jnp.asarray(q), jnp.asarray(c), k=5, q_tile=8,
                                    c_tile=10923, interpret=True, packed=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))


def test_block_topk_coords_sentinels():
    """A slot no candidate fills reads 1e30 with zero coordinates; a real
    candidate above 1e29 reads exactly 1e30 and keeps its coordinates."""
    c = np.array([[1.0, 0, 0], [0, 2.0, 0], [0, 0, 3.0]], np.float32)
    q = np.zeros((8, 3), np.float32)
    d, co = ktop.block_topk_coords(_t(q), _t(c), k=5)
    d_j, co_j = pallas_nn.block_topk_coords(jnp.asarray(q), jnp.asarray(c), k=5, q_tile=8,
                                            c_tile=3, interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(co.numpy(), np.asarray(co_j))
    np.testing.assert_array_equal(d.numpy()[0], np.float32([1, 4, 9, 1e30, 1e30]))
    np.testing.assert_array_equal(co.numpy()[:, 3:], 0.0)
    # d = 2.5e29 to every candidate (the offsets vanish in float32): a tie
    far = np.array([[5e14, 0, 0], [0, 0, 0], [0, 0, 0]], np.float32)
    d, co = ktop.block_topk_coords(_t(far), _t(c), k=2)
    d_j, co_j = pallas_nn.block_topk_coords(jnp.asarray(far), jnp.asarray(c), k=2, q_tile=3,
                                            c_tile=3, interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(co.numpy(), np.asarray(co_j))
    assert d[0, 0] == np.float32(1e30) and co[0, 0].tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("form", ["index", "packed", "coords"])
def test_dense_topk_plain_matches_pallas_on_ties(rng, form):
    """K5, K5p and K8's plain versions against the Pallas kernels (interpret
    mode) on exact ties: candidates on a 1/8 grid, 100 distinct points
    repeated in shuffled copies across the reference's four 256-candidate
    chunks (the card's kernel splits and merges across chunks and cluster
    pieces; this holds the rule both must keep). K5 and K5p: distances and
    indices bit for bit, ties to the lower index; K8: distances and
    coordinates bit for bit (its reference returns no index)."""
    Q, C, k = 256, 1024, 5
    uniq = _grid(rng, (100, 3), reach=3)
    c = np.concatenate([uniq[rng.permutation(100)] for _ in range(-(-C // 100))])[:C]
    q = _grid(rng, (Q, 3), reach=3)
    baked = _baked(c, rng.uniform(size=C) > 0.1)
    args_j = (jnp.asarray(q), jnp.asarray(baked))
    kw = dict(k=k, q_tile=128, c_tile=256, interpret=True)
    if form == "coords":
        d_j, c_j = pallas_nn.block_topk_coords(*args_j, **kw)
        d_t, c_t = ktop.block_topk_coords_plain(_t(q), _t(baked), k=k)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    else:
        d_j, i_j = pallas_nn.block_topk(*args_j, packed=form == "packed", **kw)
        plain = ktop.block_topk_packed_plain if form == "packed" else ktop.block_topk_plain
        d_t, i_t = plain(_t(q), _t(baked), k=k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert bool((d_t[:, 1:] == d_t[:, :-1]).any())                # ties were exercised
