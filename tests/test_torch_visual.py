"""The port's camera ops against the JAX package on the CPU: camera model,
image ops, the dense k-NN, kernel K6's plain version against the Pallas
``lk_level`` in interpret mode, and the pyramidal tracker with its levels
routed to that kernel, as the TPU runs them."""

from contextlib import contextmanager
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu.ops import image as jimg
from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import lk as jlk
from lidar_visual_odometry_tpu.ops import pallas_lk
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.kernels import lk as klk
from lidar_visual_odometry_tpu_torch.ops import camera as tcam
from lidar_visual_odometry_tpu_torch.ops import image as timg
from lidar_visual_odometry_tpu_torch.ops import knn as tknn
from lidar_visual_odometry_tpu_torch.ops import lk as tlk

torch.set_num_threads(2)

CAM = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)


class _TpuBackendJax:
    """``jax`` as ``ops/lk.py`` sees it under ``lk_through_pallas_interpret``."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextmanager
def lk_through_pallas_interpret():
    """Route the JAX tracker's levels to ``pallas_lk.lk_level`` in interpret
    mode (the TPU's semantics) instead of the CPU's XLA gather path; only
    ``ops/lk.py`` sees the TPU backend. JAX's caches are cleared on both
    sides so that no program traced under the other routing is reused."""
    orig_jax, orig_level = jlk.jax, pallas_lk.lk_level
    jax.clear_caches()
    jlk.jax = _TpuBackendJax()
    pallas_lk.lk_level = partial(orig_level, interpret=True)
    try:
        yield
    finally:
        jlk.jax = orig_jax
        pallas_lk.lk_level = orig_level
        jax.clear_caches()


@pytest.fixture
def lk_interpret():
    with lk_through_pallas_interpret():
        yield


@pytest.fixture(scope="module")
def pair():
    """Two photo-consistent 320 × 96 renders of the corridor, the camera moving
    0.4 m forward and turning 0.01 rad."""
    scene = jsyn.BoxScene.corridor(0)
    out = []
    for dx, yaw in ((0.0, 0.0), (0.4, 0.01)):
        R, t = jsyn.camera_from_velodyne_pose(jsyn.yaw_matrix(yaw), np.array([dx, 0.0, 1.5]))
        out.append(jsyn.render_image(scene, R, t, **CAM)[0])
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- camera --

@pytest.mark.parametrize("make", ["camera", "feature_table"])
def test_constructors_default_to_the_card(monkeypatch, make):
    """``Pinhole.from_config`` and ``visual_frontend.empty_table`` place their
    tensors on the card unless the caller asks for the CPU, and raise where
    there is no card (here made so by the test), as the other entry points do."""
    from lidar_visual_odometry_tpu_torch.models import visual_frontend as tvf
    from lidar_visual_odometry_tpu_torch.utils import config as tcfg

    fn = {"camera": lambda **kw: tcam.Pinhole.from_config(tcfg.CameraConfig(), **kw),
          "feature_table": lambda **kw: tvf.empty_table(8, **kw)}[make]
    cpu = fn(device="cpu")
    tensor = cpu.dist if make == "camera" else cpu.uv
    assert tensor.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_camera_matches_jax(rng):
    cfg = jcfg.CameraConfig(fx=240.0, fy=238.0, cx=320.0, cy=96.0, width=640, height=192,
                            d0=-0.05, d1=0.01, d2=0.001, d3=-0.002, d4=0.0005)
    jc, tc = jcam.Pinhole.from_config(cfg), tcam.Pinhole.from_config(cfg, device="cpu")
    xyz = rng.normal(size=(500, 3)).astype(np.float32) * [3.0, 1.0, 5.0]
    uv_j, front_j = jax.jit(jcam.project)(jc, jnp.asarray(xyz))
    uv_t, front_t = tcam.project(tc, _t(xyz))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(front_t.numpy(), np.asarray(front_j))
    uv = rng.uniform(-20, 660, (500, 2)).astype(np.float32)
    # a division by the intrinsics on both sides: identical
    np.testing.assert_array_equal(tcam.normalized(tc, _t(uv)).numpy(),
                                  np.asarray(jax.jit(jcam.normalized)(jc, jnp.asarray(uv))))
    for boundary, scale in ((0.0, 1.0), (5.0, 0.5)):
        np.testing.assert_array_equal(
            tcam.is_in_image(tc, _t(uv), boundary, scale).numpy(),
            np.asarray(jcam.is_in_image(jc, jnp.asarray(uv), boundary, scale)))


# ----------------------------------------------------------------- image --

def test_pyramid_and_gradients_match_jax(pair):
    img = pair[0]
    pyr_j = jax.jit(jimg.build_pyramid, static_argnums=1)(jnp.asarray(img), 3)
    pyr_t = timg.build_pyramid(_t(img), 3)
    # the 2×2 mean: four additions and ×0.25; the reference's compiler picks
    # the order of the additions by context (left to right, pairwise, fused
    # with a producer's product): 2 ulp of the four-value sum (< 4)
    for a, b in zip(pyr_j, pyr_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2.4e-7)
    for a, b in zip(jax.jit(jimg.gradients)(jnp.asarray(img)), timg.gradients(_t(img))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bilinear_matches_jax(rng, pair):
    img = pair[1]
    uv = np.stack([rng.uniform(-3, 323, 400), rng.uniform(-3, 99, 400)], -1).astype(np.float32)
    want = np.asarray(jax.jit(jimg.bilinear)(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_allclose(timg.bilinear(_t(img), _t(uv)).numpy(), want, atol=1e-6)


def _window_sum64(x, k):
    """k×k zero-padded window sums over the last two axes, in float64."""
    r = k // 2
    p = np.pad(np.asarray(x, np.float64), [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)])
    H, W = x.shape[-2:]
    return sum(p[..., i:i + H, j:j + W] for i in range(k) for j in range(k))


@pytest.mark.parametrize("k, shape", [(3, (96, 320)), (3, (3, 48, 160)), (5, (40, 64)),
                                      (21, (96, 320)), (21, (7, 9))])
def test_box_sum_is_the_window_sum(rng, k, shape):
    """A float32 sum of k² terms: within k² unit roundoffs of the sum of
    their magnitudes, in float64, of the exact window sum."""
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    got = timg.box_sum(_t(x), k).numpy()
    assert got.shape == shape and got.dtype == np.float32
    bound = k * k * 2.0 ** -24 * _window_sum64(np.abs(x), k)
    assert np.all(np.abs(got - _window_sum64(x, k)) <= bound)


def test_corner_score_and_selection_match_jax(rng, pair):
    """On uint8-quantised images, as the path feeds them: the score within
    1e-7 of the reference's and nearer its float64 value (the reference's
    box sums are prefix-sum differences, the port's direct window sums); on
    one score map the selected corners identical, occupancy suppression
    included; from each side's own score the same corners up to exact ties
    (pixels whose reference scores agree within that 1e-7)."""
    occ = np.stack([rng.uniform(0, 320, 64), rng.uniform(0, 96, 64)], -1).astype(np.float32)
    occ_m = rng.uniform(size=64) > 0.3
    kw = dict(grid_rows=4, grid_cols=10, per_cell=5)
    select_j = jax.jit(partial(jimg.grid_select_features, **kw))
    n_moved = 0
    for frame in pair:
        img = np.clip(frame * 255.0 + 0.5, 0, 255).astype(np.uint8) * np.float32(1 / 255)
        score_j = np.asarray(jax.jit(jimg.shi_tomasi_score)(jnp.asarray(img)))
        score_t = timg.shi_tomasi_score(_t(img)).numpy()
        np.testing.assert_allclose(score_t, score_j, rtol=0, atol=1e-7)
        gx, gy = (np.asarray(g) for g in timg.gradients(_t(img)))
        sxx, syy, sxy = (_window_sum64(p, 3) / 9 for p in (gx * gx, gy * gy, gx * gy))
        tr = sxx + syy
        score64 = tr / 2 - np.sqrt(np.maximum(tr * tr / 4 - (sxx * syy - sxy * sxy), 0))
        assert np.abs(score_t - score64).max() < np.abs(score_j - score64).max()

        uv_j, ok_j = select_j(jnp.asarray(score_t), jnp.asarray(occ), jnp.asarray(occ_m))
        uv_t, ok_t = timg.grid_select_features(_t(score_t), _t(occ), _t(occ_m), **kw)
        np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        uv_j, ok_j = (np.asarray(a) for a in select_j(jnp.asarray(score_j), jnp.asarray(occ),
                                                        jnp.asarray(occ_m)))
        np.testing.assert_array_equal(ok_t.numpy(), ok_j)
        moved = np.any(uv_t.numpy() != uv_j, axis=1)
        (xt, yt), (xj, yj) = uv_t.numpy()[moved].astype(int).T, uv_j[moved].astype(int).T
        np.testing.assert_allclose(score_j[yt, xt], score_j[yj, xj], rtol=0, atol=1e-7)
        n_moved += moved.sum()
    assert n_moved < 0.05 * len(moved)
    # a cell that is all suppressed: arg-max of -inf is index 0, not valid
    uv_t, ok_t = timg.grid_select_features(torch.full((96, 320), -np.inf), _t(occ[:1]),
                                           torch.tensor([True]), **kw)
    assert not ok_t.any() and uv_t[0].tolist() == [0.0, 0.0]


def test_clahe_matches_jax(pair):
    img = pair[0]
    want = np.asarray(jax.jit(jimg.clahe)(jnp.asarray(img)))
    # the clipped excess is a float32 sum over 256 bins in another order
    np.testing.assert_allclose(timg.clahe(_t(img)).numpy(), want, atol=1e-5)


# ------------------------------------------------------------------- knn --

def test_dense_knn_matches_jax(rng):
    """Depth association's 3-NN in the 10-plane: same neighbours, distances
    to float32 cancellation (|q|² + |c|² up to ~700, a few ulp of 3e-5)."""
    c = np.concatenate([rng.normal(0, 5, (2000, 2)), np.full((2000, 1), 10.0)], 1)
    q = np.concatenate([rng.normal(0, 5, (300, 2)), np.full((300, 1), 10.0)], 1)
    c, q = c.astype(np.float32), q.astype(np.float32)
    mask = rng.uniform(size=2000) > 0.2
    i_j, d_j = jax.jit(jknn.knn, static_argnums=3)(jnp.asarray(q), jnp.asarray(c),
                                                  jnp.asarray(mask), 3)
    i_t, d_t = tknn.knn(_t(q), _t(c), _t(mask), 3)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=2e-4)
    np.testing.assert_allclose(
        tknn.pairwise_sqdist(_t(q), _t(c), _t(mask)).numpy(),
        np.asarray(jax.jit(jknn.pairwise_sqdist)(jnp.asarray(q), jnp.asarray(c),
                                                 jnp.asarray(mask))), atol=2e-4)


def test_dense_knn_ties_take_the_lower_index():
    c = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0], [0, 0, 5.0], [0, 1.0, 0]])
    idx, dist = tknn.knn(torch.zeros((1, 3)), c, torch.tensor([True, True, True, True, False]), 3)
    assert idx.tolist() == [[0, 1, 2]] and dist.tolist() == [[1.0, 1.0, 1.0]]


# -------------------------------------------------------------------- K6 --

def _lk_inputs(rng, H, W, N=48):
    """Interior features, features within win/2 + 2 px of each border (where
    the kernel's origin clamp differs from per-sample clamping), a fifth of
    the rows inactive."""
    uv = np.stack([rng.uniform(0, W - 1, N), rng.uniform(0, H - 1, N)], -1)
    uv[:8, 0] = rng.uniform(0, 8, 8)
    uv[8:16, 0] = W - 1 - rng.uniform(0, 8, 8)
    uv[16:24, 1] = rng.uniform(0, 8, 8)
    uv[24:32, 1] = H - 1 - rng.uniform(0, 8, 8)
    guess = rng.normal(0, 0.7, (N, 2))
    act = rng.uniform(size=N) > 0.2
    fa = rng.normal(0, 0.01, (N, 4))
    return uv.astype(np.float32), guess.astype(np.float32), act, fa.astype(np.float32)


@pytest.mark.parametrize("affine,fixed,iters,eps", [
    (True, False, 10, 0.01), (False, False, 4, 0.01), (False, True, 10, 0.0),
    (True, False, 10, 0.0), (False, False, 10, 0.0),
])
def test_lk_level_plain_matches_pallas(rng, pair, affine, fixed, iters, eps):
    """K6's plain version against the Pallas kernel (batch8 body) in
    interpret mode: no ok flip; displacements to 2e-4 px and affine
    parameters to 1e-4 for the features that stay within a window of their
    start (float32 sums in another order: the plain version sums in the CUDA
    kernel's lane order). A feature whose template is poorly conditioned
    wanders 40-170 px over ten iterations and carries its rounding along:
    2e-2 px and 2e-3 for those. The per-feature body agrees where it applies
    (no fixed_affine, no return_affine)."""
    img0, img1 = pair
    uv, guess, act, fa = _lk_inputs(rng, *img0.shape)
    win = 13
    kw = dict(win=win, iters=iters, eps=eps, affine=affine)
    fa_j = jnp.asarray(fa) if fixed else None
    args_j = (jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(uv), jnp.asarray(guess),
              jnp.asarray(act), fa_j)
    want = pallas_lk.lk_level(*args_j, batch8=True, interpret=True, return_affine=affine, **kw)
    got = klk.lk_level(_t(img0), _t(img1), _t(uv), _t(guess), _t(act),
                       _t(fa) if fixed else None, return_affine=affine, **kw)
    near = np.abs(np.asarray(want[0])).max(1) < win

    def close(a, b, tight, loose):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a[near], b[near], rtol=0, atol=tight)
        np.testing.assert_allclose(a, b, rtol=0, atol=loose)

    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0], want[0], 2e-4, 2e-2)
    inactive = ~act
    np.testing.assert_array_equal(got[0].numpy()[inactive], guess[inactive])
    assert not got[1].numpy()[inactive].any()
    if affine:
        close(got[2], want[2], 1e-4, 2e-3)
        assert not got[2].numpy()[~got[1].numpy()].any()
    if not fixed and eps > 0:
        per_feature = pallas_lk.lk_level(*args_j[:5], batch8=False, interpret=True, **kw)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(per_feature[1]))
        close(got[0], per_feature[0], 2e-4, 2e-2)


def test_lk_level_rejects_bad_modes():
    img = torch.zeros((48, 160))
    uv = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="fixed_affine"):
        klk.lk_level(img, img, uv, uv, None, torch.zeros((8, 4)), win=13, affine=True)
    with pytest.raises(ValueError, match="return_affine"):
        klk.lk_level(img, img, uv, uv, win=13, return_affine=True)
    with pytest.raises(ValueError, match="too small"):
        klk.lk_level(img[:16], img[:16], uv, uv, win=13)


# -------------------------------------------------------------------- lk --

@pytest.mark.parametrize("affine", [False, True])
def test_track_level_matches_jax_xla_path(rng, pair, affine):
    """The gather path the port keeps for levels too small for the kernel,
    against the JAX package's vmapped XLA ``_track_level``."""
    img0, img1 = pair
    uv = np.stack([rng.uniform(10, 310, 40), rng.uniform(10, 86, 40)], -1).astype(np.float32)
    guess = rng.normal(0, 0.5, (40, 2)).astype(np.float32)
    fa = None if affine else rng.normal(0, 0.01, (40, 4)).astype(np.float32)
    gx, gy = jimg.gradients(jnp.asarray(img0))
    want = jlk._track_level(jnp.asarray(img0), jnp.asarray(img1), gx, gy, jnp.asarray(uv),
                            jnp.asarray(guess), win=9, iters=6, affine=affine,
                            fixed_affine=None if fa is None else jnp.asarray(fa),
                            return_affine=True)
    tgx, tgy = timg.gradients(_t(img0))
    got = tlk._track_level(_t(img0), _t(img1), tgx, tgy, _t(uv), _t(guess), win=9, iters=6,
                           affine=affine, fixed_affine=None if fa is None else _t(fa),
                           return_affine=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-4)


def test_track_pyramid_reverse_checked_matches_jax(rng, pair, lk_interpret):
    """The bench's tracker settings (win 13, 3 levels, affine, eps 0.01,
    iters_coarse 4, shallow reverse over 1 level, the "solve" reverse gate)
    against the JAX tracker with its levels on the Pallas kernel. The last
    level (24 × 80) is too small for win 21 and takes the gather path in
    both."""
    img0, img1 = pair
    pyr_j = [tuple(jimg.build_pyramid(jnp.asarray(im), 3)) for im in (img0, img1)]
    pyr_t = [tuple(_t(np.asarray(p)) for p in pyr) for pyr in pyr_j]
    N = 64
    uv = np.stack([rng.uniform(0, 319, N), rng.uniform(0, 95, N)], -1).astype(np.float32)
    act = rng.uniform(size=N) > 0.2
    flow = rng.normal(0, 1.0, (N, 2)).astype(np.float32)
    for win in (13, 21):
        kw = dict(win=win, iters=10, levels=3, max_reverse_err=1.0, reverse_levels=1,
                  iters_coarse=4, eps=0.01, affine=True, reverse_affine=True)
        uv_j, ok_j = jlk.track_pyramid_reverse_checked(
            *pyr_j, jnp.asarray(uv), jnp.asarray(act), jnp.asarray(flow), **kw)
        uv_t, ok_t = tlk.track_pyramid_reverse_checked(*pyr_t, _t(uv), _t(act), _t(flow), **kw)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert ok_t.sum() > N // 4
        np.testing.assert_allclose(uv_t.numpy()[ok_t.numpy()], np.asarray(uv_j)[ok_t.numpy()],
                                   atol=2e-4)


def test_tracker_rejects_bad_modes(pair):
    pyr = tuple(timg.build_pyramid(_t(pair[0]), 2))
    uv = torch.full((8, 2), 40.0)
    with pytest.raises(ValueError, match="reverse_affine"):
        tlk.track_pyramid_reverse_checked(pyr, pyr, uv, win=9, levels=2, reverse_affine="fixed")
    with pytest.raises(ValueError, match="reverse_affine"):
        tlk.track_pyramid_reverse_checked(pyr, pyr, uv, win=9, levels=2, affine=True,
                                          reverse_affine="solved")
    with pytest.raises(ValueError, match="fixed_affine"):
        tlk.track_pyramid(pyr, pyr, uv, None, None, torch.zeros((8, 4)), win=9, levels=2,
                          affine=True)
    with pytest.raises(ValueError, match="return_affine"):
        tlk.track_pyramid(pyr, pyr, uv, win=9, levels=2, return_affine=True)
    # "fixed" reuses the forward fit as a constant correction: runs with affine
    uv1, ok = tlk.track_pyramid_reverse_checked(pyr, pyr, uv, win=9, levels=2, affine=True,
                                                reverse_affine="fixed")
    assert ok.all() and torch.allclose(uv1, uv, atol=1e-3)
