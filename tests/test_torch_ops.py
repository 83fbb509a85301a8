"""The port's ops (lidar_visual_odometry_tpu_torch/ops) against the JAX
package on the same numpy inputs, on the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.ops import features as jF
from lidar_visual_odometry_tpu.ops import gn as jgn
from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import lidar_factors as jlf
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu_torch.kernels import features as kfeat
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import gn, knn, se3
from lidar_visual_odometry_tpu_torch.ops import lidar_factors as lf
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc

torch.set_num_threads(2)

W = 1024
GEOM = dict(n_scans=64, width=W, min_range=0.1, max_range=120.0)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scans():
    seq = jsyn.SyntheticSequence(n_frames=3, width=600, noise=0.005)
    return [seq.scan(k) for k in range(2)]


@pytest.fixture(scope="module")
def polar_cs(scans):
    """The JAX decode of frame 0's polar2 image, as numpy arrays."""
    img = jpc.pack_polar_scan(scans[0], channels=1, **GEOM)
    cs = jax.jit(partial(jpc.polar_to_compact, **GEOM))(jnp.asarray(img))
    return img, jax.tree.map(np.asarray, cs)


# --------------------------------------------------------------------- se3


def test_se3_matches_jax(rng):
    xi = (rng.normal(size=(32, 6)) * [1, 1, 1, 0.5, 0.5, 0.5]).astype(np.float32)
    xi[:4, 3:] *= 1e-5                                   # Taylor branches
    pts = rng.normal(size=(32, 3)).astype(np.float32) * 10
    ja, jb = jse3.se3_exp(jnp.asarray(xi)), jse3.se3_exp(jnp.asarray(xi[::-1].copy()))
    ta, tb = se3.se3_exp(_t(xi)), se3.se3_exp(_t(xi[::-1]))
    # float32 transcendental functions of two libraries: 1e-6 (2e-5 at 10 m)
    np.testing.assert_allclose(ta.q.numpy(), np.asarray(ja.q), atol=1e-6)
    np.testing.assert_allclose(ta.t.numpy(), np.asarray(ja.t), atol=1e-5)
    jc, tc = jse3.se3_compose(ja, jb), se3.se3_compose(ta, tb)
    np.testing.assert_allclose(tc.q.numpy(), np.asarray(jc.q), atol=1e-6)
    np.testing.assert_allclose(tc.t.numpy(), np.asarray(jc.t), atol=1e-5)
    np.testing.assert_allclose(
        se3.se3_apply(se3.se3_inverse(ta), _t(pts)).numpy(),
        np.asarray(jse3.se3_apply(jse3.se3_inverse(ja), jnp.asarray(pts))), atol=2e-5,
    )
    np.testing.assert_allclose(se3.se3_log(tc).numpy(), np.asarray(jse3.se3_log(jc)),
                               atol=2e-5)
    s = rng.uniform(size=32).astype(np.float32)
    jp, tp = jse3.pose_interpolate(ja, jnp.asarray(s)), se3.pose_interpolate(ta, _t(s))
    np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), atol=1e-6)
    np.testing.assert_allclose(se3.quat_to_matrix(ta.q).numpy(),
                               np.asarray(jse3.quat_to_matrix(ja.q)), atol=1e-6)


# -------------------------------------------------------------- pointcloud


@pytest.mark.parametrize("channels", [1, 2])
def test_pack_polar_scan_matches_jax(scans, channels):
    want = jpc.pack_polar_scan(scans[1], channels=channels, **GEOM)
    got = pc.pack_polar_scan(scans[1], channels=channels, **GEOM)
    np.testing.assert_array_equal(got, want)
    chunk = pc.pack_polar_chunk(scans, channels=channels, **GEOM)
    assert chunk.shape == (2, 64, W, channels)
    np.testing.assert_array_equal(chunk[1], want)


@pytest.mark.parametrize("channels", [1, 2])
def test_polar_to_compact_matches_jax(scans, channels):
    img = jpc.pack_polar_scan(scans[0], channels=channels, **GEOM)
    want = jax.tree.map(np.asarray, jpc.polar_to_compact(jnp.asarray(img), **GEOM))
    got = pc.polar_to_compact(pc.polar_image_to_tensor(img, "cpu"), **GEOM)
    np.testing.assert_array_equal(got.count.numpy(), want.count)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.rel_time.numpy(), want.rel_time)
    # sin/cos of two float32 libraries differ by an ulp: ≤ 1e-7 · 120 m
    np.testing.assert_allclose(got.xyz.numpy(), want.xyz, atol=2e-5)


def test_polar_empty_frame_decodes_empty():
    cs = pc.polar_to_compact(torch.zeros((64, W, 1), dtype=torch.int32), **GEOM)
    assert int(cs.count.sum()) == 0 and not cs.valid.any()


def test_build_compact_scan_matches_jax(scans):
    xyz, mask = jpc.pad_points(scans[0], 65536)
    want = jax.tree.map(np.asarray, jax.jit(partial(jpc.build_compact_scan, **GEOM))(
        jnp.asarray(xyz), jnp.asarray(mask)))
    got = pc.build_compact_scan(_t(xyz), _t(mask), **GEOM)
    # ring 0 of the synthetic HDL-64 sits exactly on the 2.0° field-of-view
    # gate, where an ulp of atan2 flips membership (as tests/test_pointcloud.py
    # notes): compare the rings whose counts agree, which must be nearly all
    same = got.count.numpy() == want.count
    assert same.sum() >= 62, (got.count.numpy(), want.count)
    # the winners are the input points themselves: exact
    np.testing.assert_array_equal(got.xyz.numpy()[same], want.xyz[same])
    np.testing.assert_array_equal(got.valid.numpy()[same], want.valid[same])
    np.testing.assert_array_equal(got.rel_time.numpy()[same], want.rel_time[same])


def test_pad_points():
    out, mask = pc.pad_points(np.ones((3, 4), np.float32), 5)
    np.testing.assert_array_equal(mask, [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(out[:3], 1.0)
    with pytest.raises(ValueError):
        pc.pad_points(np.ones((6, 3)), 5)


@pytest.mark.parametrize("max_out", [512, 64])
def test_voxel_downsample_batched_matches_jax(polar_cs, rng, max_out):
    """64 voxels per ring overflow on most rings: the dropped set must agree."""
    _, cs = polar_cs
    mask = cs.valid & (rng.uniform(size=cs.valid.shape) > 0.2)
    want = jax.jit(partial(jpc.voxel_downsample_batched, leaf=0.2, max_out=max_out))(
        jnp.asarray(cs.xyz), jnp.asarray(mask))
    got = pc.voxel_downsample_batched(_t(cs.xyz), _t(mask), leaf=0.2, max_out=max_out)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # centroids of the same points, summed in another order: 1e-5 m
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=1e-5)


# ---------------------------------------------------------------- features


def test_curvature_and_reach_match_jax(polar_cs):
    _, cs = polar_cs
    jcs = jpc.CompactScan(*map(jnp.asarray, cs))
    tcs = pc.CompactScan(*map(_t, cs))
    c_j, e_j = jF.curvature(jcs)
    c_t, e_t = F.curvature(tcs)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6)
    for a, b in zip(F._suppression_reach(tcs), jF._suppression_reach(jcs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for j in range(6):
        for a, b in zip(kfeat.sector_bounds(tcs.count, 6, j), jF._sector_bounds(jcs.count, 6, j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_extract_features_identical(polar_cs):
    """Same compacted scan in → the same picked points and masks out."""
    _, cs = polar_cs
    want = jax.jit(jF.extract_features)(jpc.CompactScan(*map(jnp.asarray, cs)))
    got = F.extract_features(pc.CompactScan(*map(_t, cs)))
    for name in ("sharp", "less_sharp", "flat"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask), err_msg=name)
        np.testing.assert_array_equal(g.xyz.numpy(), np.asarray(w.xyz), err_msg=name)
        np.testing.assert_array_equal(g.ring.numpy(), np.asarray(w.ring), err_msg=name)
        np.testing.assert_array_equal(g.rel_time.numpy(), np.asarray(w.rel_time),
                                      err_msg=name)
    assert int(got.sharp.mask.sum()) > 100 and int(got.flat.mask.sum()) > 100
    np.testing.assert_array_equal(got.less_flat.mask.numpy(), np.asarray(want.less_flat.mask))
    np.testing.assert_allclose(got.less_flat.xyz.numpy(), np.asarray(want.less_flat.xyz),
                               atol=1e-5)


# --------------------------------------------------------------------- knn


def test_associate_coords_match_jax(rng):
    """Against the JAX XLA branch (matrix-product distances): validity may
    differ only where a distance sits within rounding of the 25 m² gate, and
    rows valid on both sides pick the same points."""
    R, B, Q = 16, 64, 256
    c = rng.normal(size=(R, B, 3)).astype(np.float32) * 6
    cm = rng.uniform(size=(R, B)) > 0.2
    q = rng.normal(size=(Q, 3)).astype(np.float32) * 6
    qm = rng.uniform(size=Q) > 0.1
    args_j = tuple(map(jnp.asarray, (q, qm, c, cm)))
    args_t = tuple(map(_t, (q, qm, c, cm)))
    je, te = jknn.associate_edges_coords(*args_j), knn.associate_edges_coords(*args_t)
    v = te.valid.numpy()
    assert (v == np.asarray(je.valid)).mean() > 0.99 and v.sum() > Q // 2
    v &= np.asarray(je.valid)
    np.testing.assert_allclose(te.a.numpy()[v], np.asarray(je.a)[v], atol=1e-5)
    np.testing.assert_allclose(te.b.numpy()[v], np.asarray(je.b)[v], atol=1e-5)
    jp, tp = jknn.associate_planes_coords(*args_j), knn.associate_planes_coords(*args_t)
    v = tp.valid.numpy()
    assert (v == np.asarray(jp.valid)).mean() > 0.99 and v.sum() > Q // 2
    v &= np.asarray(jp.valid)
    for a, b in ((tp.j, jp.j), (tp.l, jp.l), (tp.m, jp.m)):
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v], atol=1e-5)


# ------------------------------------------------------ factors and solver


def _corr(rng, n):
    p, a, b, j, l, m = (rng.normal(size=(n, 3)).astype(np.float32) * 5 for _ in range(6))
    s = rng.uniform(size=n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    return p, a, b, j, l, m, s, mask


def test_residuals_and_normal_equations_match_jax(rng):
    p, a, b, j, l, m, s, mask = _corr(rng, 64)
    xi = np.array([0.2, -0.1, 0.05, 0.03, -0.02, 0.04], np.float32)
    jpose, tpose = jse3.se3_exp(jnp.asarray(xi)), se3.se3_exp(_t(xi))
    je = jlf.EdgeCorr(*map(jnp.asarray, (p, a, b, s, mask)))
    te = lf.EdgeCorr(*map(_t, (p, a, b, s, mask)))
    jpl = jlf.PlaneCorr(*map(jnp.asarray, (p, j, l, m, s, mask)))
    tpl = lf.PlaneCorr(*map(_t, (p, j, l, m, s, mask)))
    H, g = 0, 0
    for jr, tr in ((jlf.edge_residuals(jpose, je), lf.edge_residuals(tpose, te)),
                   (jlf.plane_residuals(jpose, jpl), lf.plane_residuals(tpose, tpl))):
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]), rtol=1e-5, atol=1e-5)
        w = np.asarray(jgn.huber_weight(jnp.linalg.norm(jr[0], axis=-1), 0.1))
        np.testing.assert_allclose(
            gn.huber_weight(torch.linalg.vector_norm(tr[0], dim=-1), 0.1).numpy(), w,
            rtol=1e-5)
        Hj, gj = jgn.accumulate(jr[0], jr[1], jnp.asarray(w), jnp.asarray(mask))
        Ht, gt = gn.accumulate(tr[0], tr[1], _t(w), _t(mask))
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-3)
        H, g = H + Hj, g + gj
    dj = jgn.solve_damped(H, g)
    dt = gn.solve_damped(_t(H), _t(g))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-5)
    uj, ut = jgn.gn_update_pose(jpose, dj), gn.gn_update_pose(tpose, _t(dj))
    np.testing.assert_allclose(ut.q.numpy(), np.asarray(uj.q), atol=1e-6)
    np.testing.assert_allclose(ut.t.numpy(), np.asarray(uj.t), atol=1e-6)


def test_solve_damped_guards_non_finite():
    H = torch.full((6, 6), float("nan"))
    assert torch.equal(gn.solve_damped(H, torch.ones(6)), torch.zeros(6))
