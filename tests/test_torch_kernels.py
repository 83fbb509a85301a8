"""The port's kernels (lidar_visual_odometry_tpu_torch/kernels) against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions on the card by
``tests/test_torch_cuda.py`` (skipped without a card) and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import pallas_gn, pallas_nn, pallas_segsum
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.kernels import gn as kgn
from lidar_visual_odometry_tpu_torch.kernels import nn as knn_k
from lidar_visual_odometry_tpu_torch.kernels import segsum as kseg

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------- K1


@pytest.mark.parametrize("R,W,S", [(6, 256, 130), (4, 2048, 513)])
def test_segment_sum_plain_matches_pallas(rng, R, W, S):
    seg = rng.integers(0, S, (R, W)).astype(np.int32)
    vals = rng.normal(size=(R, 4, W)).astype(np.float32)
    want = pallas_segsum.segment_sum_batched(
        jnp.asarray(seg), jnp.asarray(vals), n_segments=S, interpret=True
    )
    got = kseg.segment_sum_batched(_t(seg), _t(vals), n_segments=S)
    # the Pallas kernel sums through a one-hot matrix product, the plain
    # version adds in point order: float32 reordering only (≤ 2048 terms of
    # |v| ≲ 4) → 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_segment_sum_drops_out_of_range_ids(rng):
    seg = np.array([[0, 1, 5, -1, 1]], np.int32)
    vals = np.arange(5, dtype=np.float32)[None, None, :]
    got = kseg.segment_sum_batched(_t(seg), _t(vals), n_segments=3)
    np.testing.assert_array_equal(got.numpy(), [[[0.0, 1.0 + 4.0, 0.0]]])


def test_cpu_tensors_never_launch():
    kernels.reset_launch_counts()
    kseg.segment_sum_batched(torch.zeros((2, 8), dtype=torch.int32),
                             torch.ones((2, 4, 8)), n_segments=3)
    assert kernels.launch_counts() == {
        "segment_sum_batched": 0, "associate_kernel": 0, "gn_inner_loop": 0,
    }


# --------------------------------------------------------------------- K2


@pytest.mark.parametrize("R,B,Q", [(16, 128, 128), (16, 120, 128), (32, 512, 64)])
def test_associate_plain_matches_pallas(rng, R, B, Q):
    """The TPU kernel runs on (R, B_pad, 3) blocks padded to 128 lanes with
    BAKE_FAR points (knn._baked_padded); the port takes B as it is."""
    c = rng.normal(size=(R, B, 3)).astype(np.float32) * 8
    cm = rng.uniform(size=(R, B)) > 0.2
    q = rng.normal(size=(Q, 3)).astype(np.float32) * 8
    want = np.asarray(pallas_nn.associate_kernel(
        jnp.asarray(q), jknn._baked_padded(jnp.asarray(c), jnp.asarray(cm)),
        q_tile=64, interpret=True,
    ))
    baked = knn_k.bake_mask(_t(c), _t(cm))
    got = knn_k.associate_kernel(_t(q), baked.contiguous(), nearby_scan=2.5).numpy()

    # gates: d0, d2same, dw decide validity exactly as the kernel branch of
    # knn.associate_*_coords reads them
    valid_edge = (want[:, 9] < 25.0) & (want[:, 11] < 25.0)
    valid_plane = valid_edge & (want[:, 10] < 25.0)
    np.testing.assert_array_equal((got[:, 9] < 25.0) & (got[:, 11] < 25.0), valid_edge)
    np.testing.assert_array_equal(
        (got[:, 9] < 25.0) & (got[:, 11] < 25.0) & (got[:, 10] < 25.0), valid_plane
    )
    # coordinates on the rows each factor uses: the same candidates, copied
    # (distances are the same elementwise float32 expression on both sides)
    np.testing.assert_allclose(got[valid_edge, 0:3], want[valid_edge, 0:3], atol=1e-5)
    np.testing.assert_allclose(got[valid_edge, 6:9], want[valid_edge, 6:9], atol=1e-5)
    np.testing.assert_allclose(got[valid_plane, 3:6], want[valid_plane, 3:6], atol=1e-5)
    # distances on every row; runner-ups may be a BAKE_FAR pad (1e12-ish)
    np.testing.assert_allclose(got[:, 9:12], want[:, 9:12], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 12:16], 0.0)


def test_associate_window_empty_zeroes_c1rw():
    """With one ring, no ring lies in the window: c1rw is zero, dw = 1e30."""
    c = np.array([[[1.0, 0, 0], [2.0, 0, 0]]], np.float32)
    q = np.zeros((1, 3), np.float32)
    out = knn_k.associate_kernel(_t(q), _t(c)).numpy()[0]
    np.testing.assert_array_equal(out[0:3], [1.0, 0, 0])
    np.testing.assert_array_equal(out[3:6], [2.0, 0, 0])
    np.testing.assert_array_equal(out[6:9], 0.0)
    assert out[9] == 1.0 and out[10] == 4.0 and out[11] == np.float32(1e30)


def test_associate_ties_take_first_index_and_ring():
    c = np.array([[[1.0, 0, 0], [-1.0, 0, 0]],
                  [[0, 1.0, 0], [0, -1.0, 0]]], np.float32)
    out = knn_k.associate_kernel(_t(np.zeros((1, 3), np.float32)), _t(c)).numpy()[0]
    np.testing.assert_array_equal(out[0:3], [1.0, 0, 0])     # ring 0, index 0
    np.testing.assert_array_equal(out[3:6], [-1.0, 0, 0])    # ring 0 runner-up
    np.testing.assert_array_equal(out[6:9], [0, 1.0, 0])     # ring 1, index 0


# --------------------------------------------------------------------- K3


def make_problem(rng, ne=128, npl=256):
    """Correspondences consistent with a known pose (tests/test_pallas_gn.py)."""
    true = jse3.se3_exp(jnp.asarray([0.3, -0.15, 0.1, 0.02, -0.03, 0.04], jnp.float32))
    inv = jse3.se3_inverse(true)
    a = rng.uniform(-10, 10, (ne, 3)).astype(np.float32)
    dirs = rng.normal(size=(ne, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    b = a + dirs
    lam = rng.uniform(-0.5, 1.5, (ne, 1)).astype(np.float32)
    p_edge = np.asarray(jse3.se3_apply(inv, jnp.asarray(a + lam * dirs)))
    j = rng.uniform(-10, 10, (npl, 3)).astype(np.float32)
    n = rng.normal(size=(npl, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1 = np.cross(n, [0.3, 0.7, 0.64])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    l = j + t1.astype(np.float32)
    m = j + t2.astype(np.float32)
    on_plane = (j + 0.3 * t1 + 0.2 * t2).astype(np.float32)
    p_plane = np.asarray(jse3.se3_apply(inv, jnp.asarray(on_plane)))
    return true, (p_edge, a, b), (p_plane, j, l, m)


def _rows(x, n_pad):
    out = np.zeros((3, n_pad), np.float32)
    out[:, : x.shape[0]] = x.T
    return out


@pytest.mark.parametrize("n_iters", [1, 8])
def test_gn_plain_matches_pallas(rng, n_iters):
    true, edge, plane = make_problem(rng)
    ne, npl = edge[0].shape[0], plane[0].shape[0]
    w_e = np.zeros((1, 128), np.float32)
    w_e[0, :ne] = (rng.uniform(size=ne) > 0.1)
    w_p = np.zeros((1, 256), np.float32)
    w_p[0, :npl] = (rng.uniform(size=npl) > 0.1)
    arrays = (
        np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32),
        _rows(edge[0], 128), _rows(edge[1], 128), _rows(edge[2], 128), w_e,
        _rows(plane[0], 256), _rows(plane[1], 256), _rows(plane[2], 256),
        _rows(plane[3], 256), w_p,
    )
    qj, tj = pallas_gn.gn_inner_loop(*map(jnp.asarray, arrays), n_iters=n_iters,
                                     interpret=True)
    qt, tt = kgn.gn_inner_loop(*map(_t, arrays), n_iters=n_iters)
    # same math; float32 sums in another order (the plain version's two
    # matrix products vs the kernel's lane reductions): 1e-5
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert abs(float(np.dot(qt.numpy(), np.asarray(qj)))) > 1 - 1e-6
    if n_iters == 8:
        np.testing.assert_allclose(tt.numpy(), np.asarray(true.t), atol=2e-3)


def test_gn_plain_skips_non_finite_step():
    """All weights zero → H = λ·1e-6·I, g = 0: the step is zero and the pose
    stays; a NaN correspondence makes the step non-finite and the pose stays."""
    z3 = torch.zeros((3, 4))
    q0, t0 = torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.5, 0, 0])
    q, t = kgn.gn_inner_loop(q0, t0, z3, z3, z3, torch.zeros((1, 4)),
                             z3, z3, z3, z3, torch.zeros((1, 4)))
    np.testing.assert_allclose(t.numpy(), t0.numpy())
    nan = torch.full((3, 4), float("nan"))
    q, t = kgn.gn_inner_loop(q0, t0, nan, z3, z3, torch.ones((1, 4)),
                             z3, z3, z3, z3, torch.zeros((1, 4)))
    np.testing.assert_array_equal(t.numpy(), t0.numpy())
    np.testing.assert_array_equal(q.numpy(), q0.numpy())


# -------------------------------------------------------------------- build


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit → a clear RuntimeError from the build, never a silent
    fallback to the plain version."""
    from lidar_visual_odometry_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("segsum")


def test_library_path_tracks_source_and_flags(monkeypatch):
    from lidar_visual_odometry_tpu_torch.kernels import _build

    names = {_build.library_path(n).name for n in _build.SOURCES}
    assert len(names) == 3 and all(n.endswith(".so") for n in names)
    plain = _build.library_path("gn")
    monkeypatch.setenv("LVO_NVCC_VERBOSE", "1")
    assert _build.library_path("gn") != plain
