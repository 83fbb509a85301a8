"""The port's IMU back-end (``models/backend.py``) and IMU-fused odometry
(``models/imu_fusion.py``) against the JAX package on the CPU: midpoint
preintegration, gravity alignment, the factor residuals, the window solve
(its Jacobian at δx = 0, its steps, its guard against a matrix that is not
positive definite) and the fusion core on the degraded-odometry sequence of
``tests/test_imu_fusion.py``. The whole driver on small scans is in
``tests/test_torch_imu_driver.py`` (a file of its own, so that its JAX
compilations run on another worker).

Tolerances: the residual stack is the same float32 operations, a few ulps
apart (XLA's CPU code contracts multiply-adds under jit and takes sin, cos
and atan2 from other libraries); the solves are float32 Cholesky
factorisations of matrices with 1e8 on the prior's diagonal, 1e-5 m apart
after a solve; the fused trajectories stay within 1e-3 m of JAX's over 40
frames (the rounding of each window solve carries into the next window's
anchor, 6.4e-4 m at most on this sequence).

Every JAX window solve of the file has eight states, six
iterations and the fuser's keyword arguments (``SOLVE``), so that one
compilation serves them all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import sync as jsync
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import backend as jb
from lidar_visual_odometry_tpu.models import imu_fusion as jif
from lidar_visual_odometry_tpu.models.imu_fusion import ImuFusedOdometry as JaxFuser
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu_torch.models import backend as tb
from lidar_visual_odometry_tpu_torch.models.imu_fusion import ImuFusedOdometry
from lidar_visual_odometry_tpu_torch.ops import se3 as tse3
from test_backend import simulate_imu

torch.set_num_threads(2)

PERIOD = 0.1
K = 8
ITERS = 6
SOLVE = dict(imu_weight=1.0, odom_weight=20.0, n_iters=ITERS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return type(tree)(*(_t(x) for x in tree))


def _unit(rng, n, tilt=8.0):
    q = rng.normal(size=(n, 4))
    q[:, 0] += tilt
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _window_problem(rng, k=K):
    """A random window: states near each other, deltas and odometry
    relatives of a vehicle at ~1 m a frame."""
    state = jb.WindowState(jnp.asarray(_unit(rng, k)),
                           jnp.asarray(rng.normal(size=(k, 3)).astype(np.float32)),
                           jnp.asarray(rng.normal(size=(k, 3)).astype(np.float32)))
    deltas = jb.ImuDelta(jnp.asarray(_unit(rng, k - 1)),
                         jnp.asarray(rng.normal(size=(k - 1, 3)).astype(np.float32)),
                         jnp.asarray(rng.normal(size=(k - 1, 3)).astype(np.float32)),
                         jnp.full((k - 1,), PERIOD, jnp.float32))
    rel = jse3.Pose(jnp.asarray(_unit(rng, k - 1)),
                    jnp.asarray((0.5 * rng.normal(size=(k - 1, 3))).astype(np.float32)))
    return state, deltas, rel


# ---- preintegration, alignment, residuals ------------------------------------------

@pytest.mark.parametrize("case", ["straight", "turning", "biased"])
def test_preintegrate_matches_jax(case):
    """tests/test_backend.py's simulated IMU (straight, and turning at
    0.2 rad/s), and the turning stream with both biases: JAX's delta within
    float32 rounding of 50 midpoint steps."""
    accels, gyros, dts, _ = simulate_imu(omega=(0, 0, 0) if case == "straight" else (0, 0, 0.2))
    bias = {}
    if case == "biased":
        bias = dict(acc_bias=np.array([0.1, -0.05, 0.02], np.float32),
                    gyro_bias=np.array([0.01, 0.0, -0.02], np.float32))
    want = jb.preintegrate(jnp.asarray(accels), jnp.asarray(gyros), jnp.asarray(dts),
                           **{k: jnp.asarray(v) for k, v in bias.items()})
    got = tb.preintegrate(_t(accels), _t(gyros), _t(dts), **{k: _t(v) for k, v in bias.items()})
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6, err_msg=name)


def test_gravity_align_init_matches_jax():
    """tests/test_backend.py's tilted accelerometer reading: the same
    rotation, and it turns the reading onto +z."""
    tilt = jse3.so3_exp(jnp.asarray([0.3, -0.2, 0.0], jnp.float32))
    a_body = np.asarray(jse3.quat_rotate(jse3.quat_conj(tilt),
                                         jnp.asarray([0.0, 0.0, 9.81], jnp.float32)))
    q = tb.gravity_align_init(_t(a_body))
    np.testing.assert_allclose(q.numpy(), np.asarray(jb.gravity_align_init(jnp.asarray(a_body))),
                               atol=1e-6)
    np.testing.assert_allclose(tse3.quat_rotate(q, _t(a_body)).numpy() / 9.81, [0, 0, 1],
                               atol=1e-5)


def test_residuals_and_retract_match_jax(rng):
    """Each IMU and between-factor of a random window, one at a time (an int
    index) and all at once (an index tensor), and the retraction."""
    state, deltas, rel = _window_problem(rng)
    g = jnp.asarray([0.0, 0.0, -jb.GRAVITY], jnp.float32)
    st, dl, rl = _tree_t(state), _tree_t(deltas), _tree_t(rel)
    gt = torch.tensor([0.0, 0.0, -tb.GRAVITY])
    idx = torch.arange(K - 1)
    batched_imu = tb._imu_residual(st, idx, dl, gt)
    batched_btw = tb._between_residual(st, idx, idx + 1, rl)
    for i in range(K - 1):
        di = jb.ImuDelta(*(x[i] for x in deltas))
        want = np.asarray(jb._imu_residual(state, i, di, g))
        got = tb._imu_residual(st, i, tb.ImuDelta(*(x[i] for x in dl)), gt).numpy()
        np.testing.assert_allclose(got, want, atol=5e-6)
        np.testing.assert_array_equal(batched_imu[i].numpy(), got)
        want = np.asarray(jb._between_residual(state, i, i + 1, jse3.Pose(rel.q[i], rel.t[i])))
        got = tb._between_residual(st, i, i + 1, tse3.Pose(rl.q[i], rl.t[i])).numpy()
        np.testing.assert_allclose(got, want, atol=5e-6)
        np.testing.assert_allclose(batched_btw[i].numpy(), got, atol=1e-6)
    dx = (0.1 * rng.normal(size=(K, 9))).astype(np.float32)
    for a, b in zip(jb._retract(state, jnp.asarray(dx)), tb._retract(st, _t(dx))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-7)


# ---- the window solve ----------------------------------------------------------------

def _jax_residuals(state0, deltas, rel, imu_weight, odom_weight, prior_weight):
    """``solve_window``'s residual stack, composed of the JAX package's own
    factors as its closure composes them (``models/backend.py:159-180``)."""
    k = state0.q.shape[0]
    g = jnp.asarray([0.0, 0.0, -jb.GRAVITY], jnp.float32)

    def residuals(dx_flat, state):
        st = jb._retract(state, dx_flat.reshape(k, 9))
        rs = []
        for i in range(k - 1):
            di = jax.tree.map(lambda a: a[i], deltas)
            rs.append(jb._imu_residual(st, i, di, g) * imu_weight)
            rs.append(jb._between_residual(st, i, i + 1, jse3.Pose(rel.q[i], rel.t[i]))
                      * odom_weight)
        rs.append(jnp.concatenate(
            [st.p[0] - state0.p[0],
             jse3.so3_log(jse3.quat_mul(st.q[0], jse3.quat_conj(state0.q[0])))]) * prior_weight)
        return jnp.concatenate(rs)

    return residuals


def test_window_jacobian_at_zero_matches_jax(rng):
    """``torch.func.jacfwd`` of the port's residual stack at δx = 0 is finite
    (every exponential, log and normalisation evaluates its exact branch at
    a clamped angle) and equals ``jax.jacfwd`` of JAX's within 1e-4 of
    entries up to 1e4 (the prior's weight); the residuals likewise."""
    state, deltas, rel = _window_problem(rng)
    w = dict(imu_weight=1.0, odom_weight=20.0, prior_weight=1e4)
    res_j = _jax_residuals(state, deltas, rel, **w)
    dx0 = jnp.zeros(K * 9)
    J_j = np.asarray(jax.jit(jax.jacfwd(res_j))(dx0, state))
    r_j = np.asarray(res_j(dx0, state))
    st = _tree_t(state)

    def res_t(dx):
        return tb.window_residuals(dx, st, st, _tree_t(deltas), _tree_t(rel), **w)

    J_t = torch.func.jacfwd(res_t)(torch.zeros(K * 9))
    assert J_t.shape == ((K - 1) * 15 + 6, K * 9) and torch.isfinite(J_t).all()
    np.testing.assert_allclose(res_t(torch.zeros(K * 9)).numpy(), r_j, atol=1e-4)
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-5, atol=1e-4)


def test_solve_window_matches_jax(rng):
    """A random eight-state window: the returned state within 1e-5 of JAX's."""
    state, deltas, rel = _window_problem(rng)
    want = jb.solve_window(state, deltas, rel, **SOLVE)
    got = tb.solve_window(_tree_t(state), _tree_t(deltas), _tree_t(rel), **SOLVE)
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, err_msg=name)


def test_solve_window_fuses_imu_and_odometry():
    """tests/test_backend.py's closed form: three states on a straight line
    at 1 m/s, their positions perturbed by a few cm; the solve lands on the
    truth within 5 mm and the velocities within 0.05 m/s."""
    n = 10
    v_true = np.array([1.0, 0, 0], np.float32)
    accels = torch.tensor([[0.0, 0.0, tb.GRAVITY]] * n)
    d = tb.preintegrate(accels, torch.zeros((n, 3)), torch.full((n,), PERIOD / n))
    deltas = tb.ImuDelta(*(torch.stack([x] * 2) for x in d))
    rel = tse3.Pose(torch.tensor([[1.0, 0, 0, 0]] * 2), _t(np.tile(v_true * PERIOD, (2, 1))))
    truth = np.stack([v_true * PERIOD * k for k in range(3)])
    noise = np.array([[0, 0, 0], [0.05, -0.04, 0.03], [-0.06, 0.05, -0.04]], np.float32)
    state = tb.WindowState(torch.tensor([[1.0, 0, 0, 0]] * 3), _t(truth + noise),
                           _t(np.tile(v_true, (3, 1))))
    got = tb.solve_window(state, deltas, rel)
    np.testing.assert_allclose(got.p.numpy(), truth, atol=5e-3)
    np.testing.assert_allclose(got.v.numpy(), np.tile(v_true, (3, 1)), atol=0.05)


def test_indefinite_system_gives_a_zero_step(rng):
    """A matrix that is not positive definite: JAX's Cholesky returns NaN and
    the step is zeroed; ``cholesky_ex`` reports it and the port's step is
    zero too, with nothing raised. End to end, a window whose odometry is
    NaN takes zero steps in both packages and returns its start."""
    H = np.diag([4.0, -1.0, 2.0]).astype(np.float32)
    H[0, 2] = H[2, 0] = 0.5
    gvec = np.array([1.0, 2.0, 3.0], np.float32)
    step = tb.damped_step(_t(H), _t(gvec))
    np.testing.assert_array_equal(step.numpy(), np.zeros(3, np.float32))
    L = jnp.linalg.cholesky(jnp.asarray(H) + jnp.diag(1e-6 * jnp.maximum(jnp.diag(H), 1e-8)))
    assert not np.isfinite(np.asarray(L)).all()

    state, deltas, rel = _window_problem(rng)
    rel = jse3.Pose(rel.q, rel.t.at[2, 1].set(jnp.nan))
    want = jb.solve_window(state, deltas, rel, **SOLVE)
    got = tb.solve_window(_tree_t(state), _tree_t(deltas), _tree_t(rel), **SOLVE)
    for a, b, c in zip(want, got, state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))


# ---- the fusion drivers --------------------------------------------------------------

def _bundles(seq, n):
    """tests/test_imu_fusion.py's noise-free IMU stream, bundled a frame."""
    stamps, accel, gyro = jsyn.synthesize_imu(seq, frame_period=PERIOD, rate_hz=100.0,
                                              accel_noise=0.0, gyro_noise=0.0)
    idxs = jsync.bundle_imu(np.arange(n) * PERIOD, stamps)
    dts = np.full(stamps.shape, 1.0 / 100.0, np.float32)
    return [(accel[i], gyro[i], dts[i]) for i in idxs]


def _jpose(R, t):
    return jse3.Pose(jse3.matrix_to_quat(jnp.asarray(R, jnp.float32)), jnp.asarray(t, jnp.float32))


@pytest.fixture
def jax_preintegrate_jitted(monkeypatch):
    """The JAX fuser calls ``preintegrate`` eagerly, which traces and
    compiles its scan anew on every frame (9 s over the 40 frames below).
    Under ``jax.jit`` it compiles once a bundle length: the same scan, equal
    bit for bit on the 40-frame sequence's bundles."""
    monkeypatch.setattr(jif, "preintegrate", jax.jit(jb.preintegrate))


def test_process_pose_matches_jax_on_degraded_odometry(rng, jax_preintegrate_jitted):
    """tests/test_imu_fusion.py's bumpy 40-frame sequence with per-frame
    odometry noise (the seeded ``rng``): the same noisy poses into both
    fusers. The port's fused positions are JAX's within 1e-3 m, and the
    fusion cuts the ATE below 0.8 of the raw odometry's."""
    n = 40
    seq = jsyn.SyntheticSequence(n_frames=n, yaw_rate=0.02, bounce=0.08, roll_amp=0.03)
    bundles = _bundles(seq, n)
    kw = dict(window=K, imu_weight=50.0, odom_weight=5.0, n_iters=ITERS)
    jfuser, tfuser = JaxFuser(**kw), ImuFusedOdometry(**kw, device="cpu")
    noisy = _jpose(*seq.pose(0))
    raw, fused_j, fused_t, gt = [], [], [], []
    for k in range(n):
        if k > 0:
            noise = jse3.se3_exp(jnp.asarray(np.concatenate([
                rng.normal(scale=0.03, size=3), rng.normal(scale=0.004, size=3),
            ]).astype(np.float32)))
            rel = _jpose(*seq.gt_relative(k - 1))
            noisy = jse3.se3_compose(noisy, jse3.se3_compose(noise, rel))
        fused_j.append(np.asarray(jfuser.process_pose(noisy, *bundles[k]).t))
        fused_t.append(tfuser.process_pose(_tree_t(noisy), *bundles[k]).t.numpy())
        raw.append(np.asarray(noisy.t))
        gt.append(seq.pose(k)[1])
    raw, fused_j, fused_t, gt = map(np.stack, (raw, fused_j, fused_t, gt))
    np.testing.assert_allclose(fused_t, fused_j, atol=1e-3)

    def ate(p):
        return np.sqrt(np.mean(np.sum((p - gt) ** 2, -1)))

    assert ate(fused_t) < 0.8 * ate(raw), (ate(raw), ate(fused_t))
