"""The port's lidar odometry slice against the JAX package on the CPU: one
odometry step from a carried state, the whole chunked polar2 pipeline, the
import boundary and the device rule."""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import lidar_odometry as jlo
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.models.pipeline import OdometryPipeline as JaxPipeline
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq_scans():
    seq = jsyn.SyntheticSequence(n_frames=5, width=600, noise=0.005)
    return seq, [seq.scan(k) for k in range(5)]


def _fc_to_torch(fc):
    return F.FeatureCloud(*(torch.from_numpy(np.array(x)) for x in fc))


def _feats_to_torch(feats):
    return F.ScanFeatures(*(_fc_to_torch(fc) for fc in feats))


def _state_arrays(state):
    """The odometry-state keys of the JAX package's checkpoint
    (utils/checkpoint.py save_checkpoint)."""
    out = {
        "pose_w_q": np.asarray(state.pose_w.q), "pose_w_t": np.asarray(state.pose_w.t),
        "pose_rel_q": np.asarray(state.pose_rel.q), "pose_rel_t": np.asarray(state.pose_rel.t),
    }
    for prefix, fc in (("prev_ls", state.prev_less_sharp), ("prev_lf", state.prev_less_flat)):
        for key in ("xyz", "ring", "rel_time", "mask"):
            out[f"{prefix}_{key}"] = np.asarray(getattr(fc, key))
    return out


@pytest.mark.parametrize("deskew", [False, True])
def test_odometry_step_from_carried_state(seq_scans, deskew):
    """One odometry_step from the same state and features on both sides. The
    state carries a non-identity world pose and motion prior."""
    seq, scans = seq_scans
    lcfg = jcfg.LidarConfig(azimuth_bins=1024)
    ocfg_j = jcfg.OdometryConfig(outer_iters=4, deskew=deskew)
    ocfg_t = tcfg.OdometryConfig(outer_iters=4, deskew=deskew)
    geom = dict(n_scans=64, width=1024, min_range=0.1, max_range=120.0)
    feats = [
        jsr.register_polar(jnp.asarray(jpc.pack_polar_scan(s, channels=1, **geom)), lcfg).features
        for s in scans[:2]
    ]
    from lidar_visual_odometry_tpu.ops import se3 as jse3

    prior = jse3.Pose(jnp.asarray([0.99999, 0.0, 0.0, 0.0045], jnp.float32),
                      jnp.asarray([0.95, 0.01, 0.0], jnp.float32))
    world = jse3.se3_exp(jnp.asarray([3.0, -1.0, 0.2, 0.0, 0.0, 0.3], jnp.float32))
    state_j = jlo.OdometryState(world, prior, feats[0].less_sharp, feats[0].less_flat)

    step = jax.jit(partial(jlo.odometry_step, cfg=ocfg_j))
    new_j, pose_j = step(state_j, feats[1])
    state_t = lo.odometry_state_from_numpy(_state_arrays(state_j), device="cpu")
    new_t, pose_t = lo.odometry_step(state_t, _feats_to_torch(feats[1]), ocfg_t)

    if not deskew:   # de-skew interpolation shrinks the motion it recovers
        np.testing.assert_allclose(np.asarray(new_j.pose_rel.t), seq.gt_relative(0)[1],
                                   atol=0.02)
    # the JAX CPU branch associates with matrix-product distances and solves
    # with ops/gn.py; the port with K2's and K3's plain versions: the same
    # correspondences, float32 rounding apart → 1e-4
    np.testing.assert_allclose(new_t.pose_rel.t.numpy(), np.asarray(new_j.pose_rel.t), atol=1e-4)
    assert abs(float(np.dot(new_t.pose_rel.q.numpy(), np.asarray(new_j.pose_rel.q)))) > 1 - 1e-8
    np.testing.assert_allclose(pose_t.t.numpy(), np.asarray(pose_j.t), atol=1e-4)
    assert new_t.prev_less_flat.xyz.shape == (32768, 3)


def test_run_chunked_polar2_matches_jax(seq_scans):
    """The slice end to end: the same scans through both pipelines."""
    _, scans = seq_scans
    cfg_j = jcfg.SystemConfig(lidar=jcfg.LidarConfig(azimuth_bins=1024),
                              odometry=jcfg.OdometryConfig(outer_iters=4))
    cfg_t = tcfg.SystemConfig(lidar=tcfg.LidarConfig(azimuth_bins=1024),
                              odometry=tcfg.OdometryConfig(outer_iters=4))
    want = JaxPipeline(cfg_j).run_chunked(scans, chunk=2, ingest="polar2")
    got = OdometryPipeline(cfg_t, device="cpu").run_chunked(scans, chunk=2, ingest="polar2")
    assert got.positions.shape == (5, 3) and got.quaternions.shape == (5, 4)
    # frame 0 enters through build_compact_scan, whose ring 0 sits on the
    # field-of-view gate (atan2 ulps), and the association and solve differ
    # in float32 rounding (see test_odometry_step_from_carried_state): 2e-4 m
    # over 4 frames
    np.testing.assert_allclose(got.positions, want.positions, atol=2e-4)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=1e-5)


def test_run_chunked_ragged_chunk_and_polar(seq_scans):
    """chunk=3 leaves a ragged last chunk (the JAX pipeline pads it with empty
    frames, the port runs it short); ingest="polar" decodes the angular
    offsets, and the "float" ingest pads the raw points."""
    _, scans = seq_scans
    cfg_j = jcfg.SystemConfig(lidar=jcfg.LidarConfig(azimuth_bins=1024),
                              odometry=jcfg.OdometryConfig(outer_iters=4))
    cfg_t = tcfg.SystemConfig(lidar=tcfg.LidarConfig(azimuth_bins=1024),
                              odometry=tcfg.OdometryConfig(outer_iters=4))
    want = JaxPipeline(cfg_j).run_chunked(scans, chunk=3, ingest="polar")
    got = OdometryPipeline(cfg_t, device="cpu").run_chunked(scans, chunk=3, ingest="polar")
    # as in test_run_chunked_polar2_matches_jax
    np.testing.assert_allclose(got.positions, want.positions, atol=2e-4)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=1e-5)
    want = JaxPipeline(cfg_j).run_chunked(scans, chunk=3, ingest="float")
    got = OdometryPipeline(cfg_t, device="cpu").run_chunked(scans, chunk=3, ingest="float")
    np.testing.assert_allclose(got.positions, want.positions, atol=2e-4)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=1e-5)


def test_port_imports_no_jax():
    """The port imports torch and numpy only: no jax, nothing of the JAX
    package, with every module imported, the k-NN entry points of kernels
    K7, K8 and K5p and the direct VO modules among them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import lidar_visual_odometry_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'lidar_visual_odometry_tpu'\n"
        "       or m.startswith('lidar_visual_odometry_tpu.')]\n"
        "assert not bad, bad\n"
        "from lidar_visual_odometry_tpu_torch.kernels import nn, topk\n"
        "from lidar_visual_odometry_tpu_torch.ops import knn\n"
        "for mod, names in ((nn, ('ring_top2_pallas', 'ring_top2_coords')),\n"
        "                   (topk, ('block_topk', 'block_topk_coords')),\n"
        "                   (knn, ('ring_top2_best', 'associate_edges_ringblocked',\n"
        "                          'associate_planes_ringblocked', 'associate_edges',\n"
        "                          'associate_planes', '_ring_top2_with_coords'))):\n"
        "    assert all(callable(getattr(mod, n)) for n in names), mod\n"
        "from lidar_visual_odometry_tpu_torch.models import direct_vo, keyframe\n"
        "from lidar_visual_odometry_tpu_torch.models import sqrt_photometric, window_ba\n"
        "assert callable(direct_vo.DirectVOChunked.run_chunked)\n"
        "assert all(callable(f) for f in (direct_vo.direct_chunk, keyframe.select_points,\n"
        "                                 window_ba.refine, sqrt_photometric.condense))\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, at any depth."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "lidar_visual_odometry_tpu_torch.models.pipeline" in names
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "lidar_visual_odometry_tpu"}, names


def test_cuda_device_raises_without_card(monkeypatch, seq_scans):
    """device="cuda" (the default) raises on a machine without a card; it
    never falls back to the CPU."""
    _, scans = seq_scans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.SystemConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OdometryPipeline(cfg)
    xyz, mask = pc.pad_points(scans[0], 131072)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sr.register_scan(xyz, mask, cfg.lidar)
    img = np.zeros((64, 2048, 1), np.uint16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sr.register_polar(img, cfg.lidar)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo.odometry_chunk_polar(None, img[None], cfg.lidar, cfg.odometry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo.odometry_state_from_numpy({}, device="cuda")
