"""The port's ``DistributedSlamPipeline`` on a two-rank gloo fleet against the
JAX package's on its 8-device virtual mesh (``tests/test_parallel.py``'s
4-frame sequence and configuration), on the CPU.

Each rank runs the driver on the same scans (rank function ``slam`` in
``tests/_torch_mp_worker.py``): the ranks must agree within 1e-6, the
odometry positions lie within 5e-4 m of the JAX driver's and the mapped ones
within 5e-3 m (the plane fit's decided difference, ROADMAP C), and the mapped
trajectory must track the ground truth.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_mp_worker as W
from lidar_visual_odometry_tpu.data import synthetic
from lidar_visual_odometry_tpu.parallel.distributed_pipeline import DistributedSlamPipeline
from lidar_visual_odometry_tpu.utils.config import LidarConfig, OdometryConfig, SystemConfig
from lidar_visual_odometry_tpu_torch.parallel import launch

N = 4
_TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs():
    seq = synthetic.SyntheticSequence(n_frames=N, width=900, noise=0.005)
    scans = [seq.scan(k) for k in range(N)]
    cfg = jax_config(W.SLAM_CFG)
    assert cfg == SystemConfig(lidar=LidarConfig(azimuth_bins=1024),
                               odometry=OdometryConfig(outer_iters=3, gn_iters=4))
    inputs = {"n": np.int64(N), **{f"scan{k}": s for k, s in enumerate(scans)}}
    with ThreadPoolExecutor(1) as ex:
        fleet = ex.submit(launch.launch, "_torch_mp_worker:slam", 2, inputs, device="cpu",
                          cwd=_TESTS, env={"OMP_NUM_THREADS": "1"})
        odom_j, mapped_j, _ = DistributedSlamPipeline(cfg, n_devices=8,
                                                      capacity=W.SLAM_CAPACITY).run(scans)
        ports = fleet.result()
    gt = np.stack([seq.pose(0)[0].T @ (seq.pose(k)[1] - seq.pose(0)[1]) for k in range(N)])
    return ports, (odom_j, mapped_j), gt


def jax_config(port_cfg: object) -> SystemConfig:
    """The JAX package's ``SystemConfig`` with the port's values, field by
    field (the two ``utils/config.py`` are copies)."""
    from lidar_visual_odometry_tpu.utils import config as jcfg

    def conv(c):
        cls = getattr(jcfg, type(c).__name__)
        return cls(**{f: getattr(c, f) for f in cls.__dataclass_fields__})

    return SystemConfig(**{f: conv(getattr(port_cfg, f))
                           for f in SystemConfig.__dataclass_fields__})


def test_ranks_agree(runs):
    (a, b), _, _ = runs
    for key in ("odom", "mapped"):
        np.testing.assert_allclose(a[key], b[key], atol=1e-6, err_msg=key)


def test_odometry_matches_jax(runs):
    ports, (odom_j, _), _ = runs
    np.testing.assert_allclose(ports[0]["odom"], odom_j, atol=5e-4)


def test_mapped_matches_jax_and_tracks_the_ground_truth(runs):
    ports, (_, mapped_j), gt = runs
    np.testing.assert_allclose(ports[0]["mapped"], mapped_j, atol=5e-3)
    assert np.linalg.norm(ports[0]["mapped"] - gt, axis=1).max() < 0.08


def test_driver_needs_a_process_group():
    """No process group, no mesh: the driver never makes a world of one."""
    from lidar_visual_odometry_tpu_torch.parallel import distributed_pipeline as dp

    with pytest.raises(RuntimeError, match="process group"):
        dp.DistributedSlamPipeline(W.SLAM_CFG, device="cpu")
