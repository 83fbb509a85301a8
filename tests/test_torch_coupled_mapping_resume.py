"""The port's coupled cam-lidar mapping mode against the JAX package on the
CPU: ``camlidar_slam_chunk`` coupled with ``map_skip`` 2 on the JAX run's own
inputs, ``run_chunked(coupled=True, mapping=True, map_skip=2)``, and its
checkpoints (``mapst_*``, ``traj_m_q`` / ``traj_m_t``) stopped after frame 2
and resumed, in the port and across the two packages both ways, as
``tests/test_torch_checkpoint.py`` does for the other modes. Sizes, routing
and tolerances as ``tests/test_torch_coupled_mapping.py``."""

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.utils import checkpoint as jckpt
from test_torch_coupled import N_FRAMES, seq_data  # noqa: F401
from test_torch_coupled_mapping import check_slam_chunk, close, mode_runs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(seq_data, tmp_path_factory):  # noqa: F811
    _, scans, images = seq_data
    return mode_runs("both", scans, images, tmp_path_factory.mktemp("camlidar_mapping"))


def test_coupled_slam_chunk_matches_jax(runs):
    check_slam_chunk(runs, "both")


def test_run_chunked_coupled_mapping_matches_jax(runs):
    """``run_chunked(coupled=True, mapping=True, map_skip=2)`` from the raw
    scans: the JAX run's lidar, camera and mapped trajectories."""
    assert runs["port"]["mapped_positions"].shape == (N_FRAMES, 3)
    close(runs["port"], runs["jax"])


def test_mapping_checkpoint_resumes_across_packages(runs):
    """Stopped after frame 2: the port's stopped and resumed runs equal its
    uninterrupted one bit for bit; a snapshot written by the JAX package
    resumes in the port, and one written by the port resumes in the JAX
    package, each within the tolerances of the JAX package's uninterrupted
    run; the two snapshots have the same keys, shapes and dtypes, the map
    state and the mapped trajectory among them."""
    full = runs["port"]
    for name in full:
        np.testing.assert_array_equal(runs["port_stopped"][name], full[name][:3])
        np.testing.assert_array_equal(runs["port_resumed"][name], full[name])
    close(runs["port_from_jax"], runs["jax"])
    close(runs["jax_from_port"], runs["jax"])
    ours, theirs = np.load(runs["port_ckpt"]), np.load(runs["jax_ckpt"])
    assert sorted(ours.files) == sorted(theirs.files)
    assert {"mapst_0", "mapst_5", "traj_m_q", "traj_m_t", "vchunk_levels"} <= set(ours.files)
    for key in theirs.files:
        assert ours[key].shape == theirs[key].shape, key
        assert ours[key].dtype == theirs[key].dtype, key
    assert int(ours["frame_idx"]) == 3 and ours["traj_m_t"].shape == (2, 3)
    assert jckpt.load_map_state(runs["port_ckpt"], (0.0,) * 6) is not None
