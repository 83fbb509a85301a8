"""The port's library functions that no pipeline calls, against the JAX
package's on the CPU, each on the inputs of the JAX test that covers it:
the rest of ``ops/se3.py`` (``tests/test_se3.py``), ``gn.tdist_scale`` and
``gn.lm_optimize``, the camera undistortion (``tests/test_robust_ops.py``),
the range image and its ring compaction (``tests/test_pointcloud.py``),
``image.normalize_contrast`` and ``lidar_factors.point_residuals`` (random
inputs; the JAX package has no test of them) and the public
``lidar_odometry.scan_to_scan``.

Tolerances: elementwise functions of the same float32 operations agree to a
few ulps (XLA's CPU code and PyTorch's take sin, cos, atan2 and sqrt from
different libraries); iterated solvers to 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import lidar_odometry as jlo
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu.ops import gn as jgn
from lidar_visual_odometry_tpu.ops import image as jimg
from lidar_visual_odometry_tpu.ops import lidar_factors as jlf
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.ops import camera as tcam
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import gn as tgn
from lidar_visual_odometry_tpu_torch.ops import image as timg
from lidar_visual_odometry_tpu_torch.ops import lidar_factors as tlf
from lidar_visual_odometry_tpu_torch.ops import pointcloud as tpc
from lidar_visual_odometry_tpu_torch.ops import se3 as tse3
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_quat(rng, n=()):
    q = rng.normal(size=(*n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _near_pi_quats():
    """Rotations near π about each axis: all four of Shepperd's pivots."""
    w = np.eye(3, dtype=np.float32) * np.float32(np.pi - 1e-3)
    return np.asarray(jse3.so3_exp(jnp.asarray(w)))


# ---- ops/se3.py ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["random", "near_pi"])
def test_matrix_to_quat_matches_jax(rng, which):
    """``matrix_to_quat`` of the same matrices: the same pivot everywhere and
    the quaternion within 2 ulps of unit scale."""
    q = _random_quat(rng, (64,)) if which == "random" else _near_pi_quats()
    m = np.asarray(jse3.quat_to_matrix(jnp.asarray(q)))
    want = np.asarray(jse3.matrix_to_quat(jnp.asarray(m)))
    got = tse3.matrix_to_quat(_t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    # the round trip of tests/test_se3.py, on the port
    sign = np.sign(np.sum(q * got, axis=-1, keepdims=True))
    np.testing.assert_allclose(sign * got, q, atol=1e-5)


def test_pose_matrix_functions_match_jax(rng):
    """``se3_matrix``, ``se3_from_matrix``, ``se3_apply_matmul``,
    ``se3_adjoint`` and ``so3t_exp`` on the inputs of tests/test_se3.py."""
    q, t = _random_quat(rng, (8,)), rng.normal(size=(8, 3)).astype(np.float32)
    jp, tp = jse3.Pose(jnp.asarray(q), jnp.asarray(t)), tse3.Pose(_t(q), _t(t))
    T = tse3.se3_matrix(tp).numpy()
    np.testing.assert_array_equal(T, np.asarray(jse3.se3_matrix(jp)))
    back, jback = tse3.se3_from_matrix(_t(T)), jse3.se3_from_matrix(jnp.asarray(T))
    np.testing.assert_allclose(back.q.numpy(), np.asarray(jback.q), atol=2.4e-7)
    np.testing.assert_array_equal(back.t.numpy(), np.asarray(jback.t))
    # t^ R: three products summed in another order, an ulp at unit scale
    np.testing.assert_allclose(tse3.se3_adjoint(tp).numpy(), np.asarray(jse3.se3_adjoint(jp)),
                               rtol=0, atol=1e-6)

    one_j, one_t = jse3.Pose(jp.q[0], jp.t[0]), tse3.Pose(tp.q[0], tp.t[0])
    x = rng.normal(size=(128, 3)).astype(np.float32)
    got = tse3.se3_apply_matmul(one_t, _t(x)).numpy()
    # matrix products in another summation order: 1e-6 at unit coordinates
    np.testing.assert_allclose(got, np.asarray(jse3.se3_apply_matmul(one_j, jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(got, tse3.se3_apply(one_t, _t(x)).numpy(), atol=1e-5)

    xi = rng.normal(size=(6,)).astype(np.float32)
    a, b = tse3.so3t_exp(_t(xi)), jse3.so3t_exp(jnp.asarray(xi))
    np.testing.assert_array_equal(a.t.numpy(), np.asarray(b.t))
    np.testing.assert_allclose(a.q.numpy(), np.asarray(b.q), atol=2.4e-7)


def test_ypr_matches_jax(rng):
    """``ypr_to_quat`` and ``quat_to_ypr`` on tests/test_se3.py's angles, and
    a pure yaw against its closed form."""
    ypr = np.stack([rng.uniform(-3, 3, 16), rng.uniform(-1.4, 1.4, 16),
                    rng.uniform(-3, 3, 16)], -1).astype(np.float32)
    q = tse3.ypr_to_quat(_t(ypr))
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.ypr_to_quat(jnp.asarray(ypr))),
                               atol=5e-7)
    back = tse3.quat_to_ypr(q).numpy()
    np.testing.assert_allclose(back, np.asarray(jse3.quat_to_ypr(jnp.asarray(q.numpy()))),
                               atol=1e-6)
    np.testing.assert_allclose(back, ypr, atol=1e-4)
    R = tse3.quat_to_matrix(tse3.ypr_to_quat(torch.tensor([0.5, 0.0, 0.0]))).numpy()
    want = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1]])
    np.testing.assert_allclose(R, want, atol=1e-6)


# ---- ops/gn.py ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["student_t", "masked"])
def test_tdist_scale_matches_jax(case):
    """tests/test_robust_ops.py's two residual sets; the sums of 4096 values
    in another order: 1e-5 relative."""
    if case == "student_t":
        r = (np.random.default_rng(0).standard_t(df=5, size=4096) * 2.5).astype(np.float32)
        mask = np.ones(r.shape, bool)
    else:
        base = np.random.default_rng(1).normal(size=512).astype(np.float32)
        r = np.concatenate([base, 1e6 * np.ones(64, np.float32)])
        mask = np.concatenate([np.ones(512, bool), np.zeros(64, bool)])
    want = float(jgn.tdist_scale(jnp.asarray(r), jnp.asarray(mask)))
    got = float(tgn.tdist_scale(_t(r), _t(mask)))
    assert abs(got - want) <= 1e-5 * want, (got, want)


def _exp_fit(xp):
    x = xp.linspace(0.0, 2.0, 64)
    y = 3.0 * xp.exp(-1.3 * x)

    def build_system(p):
        a, b = p[0], p[1]
        e = xp.exp(b * x)
        r = a * e - y
        J = xp.stack([e, a * x * e], -1)
        return J.T @ J, J.T @ r, xp.sum(r * r)

    return build_system, 30


def _rosenbrock(xp):
    def build_system(p):
        r = xp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])
        J = xp.stack([xp.stack([-20.0 * p[0], xp.ones_like(p[0]) * 10.0]),
                      xp.stack([-xp.ones_like(p[0]), xp.zeros_like(p[0])])])
        return J.T @ J, J.T @ r, xp.sum(r * r)

    return build_system, 60


@pytest.mark.parametrize("problem, x0", [(_exp_fit, [1.0, 0.0]), (_rosenbrock, [-1.2, 1.0])])
def test_lm_optimize_matches_jax(problem, x0):
    """tests/test_robust_ops.py's two problems: the exponential fit and the
    stiff Rosenbrock valley, where rejected steps must keep χ²; the solution,
    χ² and the solution's distance to the optimum agree with JAX's."""
    build_j, iters = problem(jnp)
    build_t, _ = problem(torch)
    p_j, chi_j = jgn.lm_optimize(build_j, lambda p, d: p + d, None,
                                 jnp.asarray(x0, jnp.float32), iters=iters)
    p_t, chi_t = tgn.lm_optimize(build_t, lambda p, d: p + d, None,
                                 torch.tensor(x0, dtype=torch.float32), iters=iters)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-4)
    assert float(chi_t) <= float(chi_j) + 1e-6
    truth = [3.0, -1.3] if problem is _exp_fit else [1.0, 1.0]
    np.testing.assert_allclose(p_t.numpy(), truth, atol=1e-2)
    _, chi1 = tgn.lm_optimize(build_t, lambda p, d: p + d, None,
                              torch.tensor(x0, dtype=torch.float32), iters=1)
    assert float(chi_t) <= float(chi1)


# ---- ops/camera.py -----------------------------------------------------------------

DIST = [0.02, -0.005, 0.001, -0.002, 0.0]


def _cams(dist):
    jc = jcam.Pinhole(jnp.float32(120.0), jnp.float32(120.0), jnp.float32(64.0),
                      jnp.float32(48.0), 128, 96, jnp.asarray(dist, jnp.float32))
    tc = tcam.Pinhole(120.0, 120.0, 64.0, 48.0, 128, 96, torch.tensor(dist, dtype=torch.float32))
    return jc, tc


@pytest.mark.parametrize("dist", [[0.0] * 5, DIST])
def test_undistort_map_and_image_match_jax(dist):
    """tests/test_robust_ops.py's 128 × 96 camera and smooth source image:
    the source map and the remapped image equal JAX's within float32
    rounding; without distortion the map is the pixel grid."""
    jc, tc = _cams(dist)
    m = tcam.undistort_rectify_map(tc)
    want = np.asarray(jcam.undistort_rectify_map(jc))
    np.testing.assert_allclose(m.numpy(), want, atol=3e-5)
    if not any(dist):
        u, v = np.meshgrid(np.arange(128), np.arange(96))
        np.testing.assert_allclose(m.numpy()[..., 0], u, atol=1e-4)
        np.testing.assert_allclose(m.numpy()[..., 1], v, atol=1e-4)
    u, v = np.meshgrid(np.arange(128, dtype=np.float64), np.arange(96, dtype=np.float64))
    src = (0.5 + 0.3 * np.sin(u / 17.0) * np.cos(v / 13.0)).astype(np.float32)
    got = tcam.undistort_image(_t(src), m).numpy()
    np.testing.assert_allclose(got, np.asarray(jcam.undistort_image(jnp.asarray(src),
                                                                    jnp.asarray(want))),
                               atol=1e-5)


def test_undistort_points_matches_jax(rng):
    """Five fixed-point steps from random pixels: JAX's within 1e-4 px, and a
    re-distortion lands back on the input."""
    jc, tc = _cams(DIST)
    uv = rng.uniform([0, 0], [128, 96], size=(256, 2)).astype(np.float32)
    got = tcam.undistort_points(tc, _t(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcam.undistort_points(jc, jnp.asarray(uv))),
                               atol=1e-4)
    xn = tcam.normalized(tc, got)
    xd = tcam.distort(tc, xn)
    back = torch.stack([120.0 * xd[:, 0] + 64.0, 120.0 * xd[:, 1] + 48.0], -1)
    np.testing.assert_allclose(back.numpy(), uv, atol=1e-2)


# ---- ops/pointcloud.py -------------------------------------------------------------

@pytest.fixture(scope="module")
def one_scan():
    return jsyn.SyntheticSequence(n_frames=1, width=900).scan(0)


@pytest.mark.parametrize("width", [512, 1024])
def test_range_image_and_compact_rings_match_jax(one_scan, width):
    """tests/test_pointcloud.py's scan gridded at 512 and at its 1024 azimuth
    bins: the same cells (nearest return), coordinates and times as JAX's
    and the same compacted rings. At 1024 bins a cell holds at most one
    return, and the two-step form equals the port's one-pass
    ``build_compact_scan``, as tests/test_pointcloud.py holds the
    reference's; at 512 bins float32 range² ties within a cell are common,
    and the two forms keep different returns of a tie (the one-pass form
    the first, the scatter the last) in both packages."""
    xyz, mask = tpc.pad_points(one_scan, 65536)
    kw = dict(n_scans=64, width=width, min_range=0.1)
    # op by op, as tests/test_pointcloud.py calls it (under jit the CPU code
    # fuses range² into the winner test and a farther return wins some cells)
    want = jpc.build_range_image(jnp.asarray(xyz), jnp.asarray(mask), **kw)
    got = tpc.build_range_image(_t(xyz), _t(mask), **kw)
    # ring 0 sits on the 2.0° field-of-view gate, where an ulp of atan2 lets
    # a point in on one side only (ROADMAP "decided differences"): there a
    # cell may fill on one side only, or another return win it
    np.testing.assert_array_equal(got.valid.numpy()[1:], np.asarray(want.valid)[1:])
    np.testing.assert_array_equal(got.xyz.numpy()[1:], np.asarray(want.xyz)[1:])
    assert (got.xyz.numpy()[0] != np.asarray(want.xyz)[0]).any(-1).sum() <= 4
    np.testing.assert_array_equal(got.rel_time.numpy(), np.asarray(want.rel_time))
    n_eligible = int((np.asarray(jpc.ring_index_hdl(jnp.asarray(xyz), 64)[1]) & mask).sum())
    assert int(got.valid.sum()) > (0.5 if width == 512 else 0.95) * n_eligible

    cs = tpc.compact_rings(got)
    for a, b in zip(cs, jpc.compact_rings(want)):
        np.testing.assert_array_equal(a.numpy()[1:], np.asarray(b)[1:])
    if width == 1024:
        one = tpc.build_compact_scan(_t(xyz), _t(mask), **kw)
        np.testing.assert_array_equal(one.count.numpy(), cs.count.numpy())
        v = cs.valid.numpy()
        np.testing.assert_array_equal(one.xyz.numpy()[v], cs.xyz.numpy()[v])
        np.testing.assert_array_equal(one.rel_time.numpy()[v], cs.rel_time.numpy()[v])


def test_range_image_min_range_filter():
    """tests/test_pointcloud.py's two points: the one inside min_range drops."""
    xyz, mask = tpc.pad_points(np.array([[0.05, 0, 0], [5.0, 0, 0.1]], np.float32), 8)
    ri = tpc.build_range_image(_t(xyz), _t(mask), n_scans=64, width=64, min_range=0.5)
    jri = jpc.build_range_image(jnp.asarray(xyz), jnp.asarray(mask), n_scans=64, width=64,
                                min_range=0.5)
    assert int(ri.valid.sum()) == 1
    np.testing.assert_array_equal(ri.valid.numpy(), np.asarray(jri.valid))


# ---- ops/image.py, ops/lidar_factors.py ----------------------------------------------

def test_normalize_contrast_matches_jax(rng):
    """Zero mean and unit (population) std, as ``jnp.std``; a constant image
    stays finite."""
    img = (rng.random((37, 53)) ** 2).astype(np.float32)
    got = timg.normalize_contrast(_t(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jimg.normalize_contrast(jnp.asarray(img))),
                               atol=1e-5)
    assert abs(got.mean()) < 1e-5 and abs(got.std() - 1.0) < 1e-4
    flat = timg.normalize_contrast(torch.full((8, 8), 0.5)).numpy()
    np.testing.assert_array_equal(flat, np.zeros((8, 8), np.float32))


def test_point_residuals_match_jax(rng):
    """Point-to-point residuals and Jacobians of random points; the Jacobian
    also against ``torch.func.jacfwd`` of the residual under a left
    perturbation."""
    q, t = _random_quat(rng), rng.normal(size=3).astype(np.float32)
    p = rng.normal(size=(32, 3)).astype(np.float32) * 10.0
    target = rng.normal(size=(32, 3)).astype(np.float32) * 10.0
    r, J = tlf.point_residuals(tse3.Pose(_t(q), _t(t)), _t(p), _t(target))
    rj, Jj = jlf.point_residuals(jse3.Pose(jnp.asarray(q), jnp.asarray(t)), jnp.asarray(p),
                                 jnp.asarray(target))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-5)
    assert J.shape == (32, 3, 6)

    def perturbed(xi):
        dq = tse3.so3_exp(xi[3:])
        pose = tse3.Pose(tse3.quat_mul(dq, _t(q)), _t(t) + xi[:3])
        return tlf.point_residuals(pose, _t(p), _t(target))[0]

    J_ad = torch.func.jacfwd(perturbed)(torch.zeros(6))
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-4)


# ---- models/lidar_odometry.py --------------------------------------------------------

def test_scan_to_scan_matches_jax():
    """The public ``scan_to_scan`` on two frames at 512 azimuth bins, from
    the identity: JAX's relative pose within 1e-4 m (the association and
    the solve in float32 rounding apart, as tests/test_torch_odometry.py)."""
    seq = jsyn.SyntheticSequence(n_frames=2, width=600, noise=0.005)
    geom = dict(n_scans=64, width=512, min_range=0.1, max_range=120.0)
    lcfg = jcfg.LidarConfig(azimuth_bins=512)
    feats = [jsr.register_polar(jnp.asarray(jpc.pack_polar_scan(seq.scan(k), channels=1, **geom)),
                                lcfg).features for k in range(2)]
    ident = jse3.identity_pose()
    want = jlo.scan_to_scan(feats[1], feats[0].less_sharp, feats[0].less_flat, ident,
                            jcfg.OdometryConfig(outer_iters=4))

    def fc(x):
        return F.FeatureCloud(*(_t(v) for v in x))

    got = lo.scan_to_scan(F.ScanFeatures(*(fc(c) for c in feats[1])), fc(feats[0].less_sharp),
                          fc(feats[0].less_flat), tse3.identity_pose("cpu"),
                          tcfg.OdometryConfig(outer_iters=4))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), seq.gt_relative(0)[1], atol=0.05)
