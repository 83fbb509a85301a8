"""The port's ``DistributedCamLidarPipeline`` (coupled, the default) on a
two-rank gloo fleet against the JAX package's on its 8-device virtual mesh
(``tests/test_parallel.py``'s sequence, rendered images and configuration,
over its first 3 frames: two tracked frames, as each costs the JAX driver's
interpret-mode tracker ~6-10 s), on the CPU.

The JAX tracker runs its levels on the Pallas kernel in interpret mode, the
TPU's semantics that the port's kernel K6 follows (on the CPU the JAX package
would otherwise take its XLA gather path). Both drivers pack their polar
scans with the native packer, so they see the same polar images. The ranks
must agree within 1e-6, the lidar odometry positions lie within 5e-5 m of the
JAX driver's (5.3e-7 m measured) and the visual ones within 5e-3 m (2.1e-4
m), the visual stage must have tracked, and the mapped trajectory must track
the ground truth.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_mp_worker as W
from lidar_visual_odometry_tpu.data import synthetic
from lidar_visual_odometry_tpu.parallel.distributed_camlidar import (
    DistributedCamLidarPipeline,
)
from lidar_visual_odometry_tpu_torch.parallel import launch
from test_torch_distributed_slam import jax_config
from test_torch_visual import lk_through_pallas_interpret

N = 3
_TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs():
    seq = synthetic.SyntheticSequence(n_frames=4, width=900, noise=0.003)
    scans = [seq.scan(k) for k in range(N)]
    images = []
    for k in range(N):
        Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        images.append(synthetic.render_image(seq.scene, Rc, tc, **W.CAM)[0])
    inputs = {"n": np.int64(N), **{f"scan{k}": s for k, s in enumerate(scans)},
              **{f"image{k}": im for k, im in enumerate(images)}}
    with ThreadPoolExecutor(1) as ex:
        fleet = ex.submit(launch.launch, "_torch_mp_worker:camlidar", 2, inputs, device="cpu",
                          cwd=_TESTS, env={"OMP_NUM_THREADS": "1"})
        with lk_through_pallas_interpret():
            want = DistributedCamLidarPipeline(jax_config(W.CAMLIDAR_CFG), n_devices=8,
                                               capacity=W.SLAM_CAPACITY).run(scans, images)
        ports = fleet.result()
    gt = np.stack([seq.pose(0)[0].T @ (seq.pose(k)[1] - seq.pose(0)[1]) for k in range(N)])
    return ports, want, gt


def test_ranks_agree(runs):
    (a, b), _, _ = runs
    for key in ("odom", "mapped", "vis"):
        np.testing.assert_allclose(a[key], b[key], atol=1e-6, err_msg=key)


def test_lidar_odometry_matches_jax(runs):
    ports, (odom_j, _, _, _), _ = runs
    np.testing.assert_allclose(ports[0]["odom"], odom_j, atol=5e-5)


def test_visual_matches_jax_and_tracked(runs):
    ports, (_, _, vis_j, _), _ = runs
    np.testing.assert_allclose(ports[0]["vis"], vis_j, atol=5e-3)
    assert np.linalg.norm(ports[0]["vis"][-1]) > 1.0


def test_mapped_matches_jax_and_tracks_the_ground_truth(runs):
    ports, (_, mapped_j, _, _), gt = runs
    np.testing.assert_allclose(ports[0]["mapped"], mapped_j, atol=5e-3)
    assert np.linalg.norm(ports[0]["mapped"] - gt, axis=1).max() < 0.12
