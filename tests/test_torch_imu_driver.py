"""The port's IMU-fused odometry driver (``models/imu_fusion.py``,
``ImuFusedOdometry.process``) against the JAX package's on the CPU: the
whole driver on small scans with and without derotation. The back-end's
parts and the fusion core are in ``tests/test_torch_backend.py``, whose
helpers this file shares; tolerances as there."""

import numpy as np
import pytest

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models.imu_fusion import ImuFusedOdometry as JaxFuser
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models.imu_fusion import ImuFusedOdometry
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_backend import ITERS, _bundles, jax_preintegrate_jitted  # noqa: F401


@pytest.fixture(scope="module")
def small_scans():
    n = 5
    seq = jsyn.SyntheticSequence(n_frames=n, width=400, noise=0.01, yaw_rate=0.01,
                                 roll_amp=0.02)
    return seq, [seq.scan(k) for k in range(n)], _bundles(seq, n)


@pytest.mark.parametrize("derotate", [False, True])
def test_process_matches_jax(small_scans, derotate, jax_preintegrate_jitted):
    """The whole driver on five frames at 512 azimuth bins (registration,
    the gyro warm start, odometry, two solves of a four-state window), with and without
    derotating each scan by the dead-reckoned IMU orientation: the port's
    fused positions within 1e-3 m of JAX's (the odometry's float32 rounding,
    as tests/test_torch_odometry.py), finite, and near the truth."""
    seq, scans, bundles = small_scans

    def cfg(m):
        return m.SystemConfig(lidar=m.LidarConfig(azimuth_bins=512),
                              odometry=m.OdometryConfig(outer_iters=3, gn_iters=4))

    kw = dict(window=4, imu_weight=1.0, odom_weight=50.0, n_iters=ITERS, derotate=derotate,
              capacity=32768)
    jfuser = JaxFuser(cfg(jcfg), **kw)
    tfuser = ImuFusedOdometry(cfg(tcfg), **kw, device="cpu")
    want = np.stack([np.asarray(jfuser.process(s, *b).t) for s, b in zip(scans, bundles)])
    got = np.stack([tfuser.process(s, *b).t.numpy() for s, b in zip(scans, bundles)])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(tfuser._q_imu, jfuser._q_imu, atol=1e-6)
    R0, t0 = seq.pose(0)
    truth = np.stack([R0.T @ (seq.pose(k)[1] - t0) for k in range(len(scans))])
    assert np.sqrt(np.mean(np.sum((got - truth) ** 2, -1))) < 0.12
