"""The port's per-frame visual frontend and cam-lidar drivers against the JAX
package on the CPU: ``visual_step``, ``update_after_external_solve``,
``VisualOdometry.process`` (CLAHE off and on), ``CamLidarPipeline.run``
(scans paired with images by ``match_nearest``) and ``run_chunked`` with its
default ``"uint16"`` ingest. The scene, camera and configuration are
``tests/test_torch_camlidar.py``'s (320 × 96, a 128-slot table, four
frames); the JAX tracker's levels run on the Pallas ``lk_level`` in
interpret mode, as there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.models import visual_frontend as jvf
from lidar_visual_odometry_tpu.ops import image as jimg
from lidar_visual_odometry_tpu.ops import lk as jlk
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline
from lidar_visual_odometry_tpu_torch.ops import image as timg
from lidar_visual_odometry_tpu_torch.ops import se3
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_camlidar import N_FRAMES, _config, _to_torch, port_cfg, seq_data  # noqa: F401
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(2)

# scans at 10 Hz; the last one 0.3 s from every image, beyond match_nearest's
# 0.227 s, so it pairs with none and keeps the last visual pose
GAP_SCAN_STAMPS = np.array([0.0, 0.1, 0.2, 0.6])
# as tests/test_torch_camlidar.py: the lidar odometry to 1e-3 m, the visual
# world poses to 5 mm / 1e-3 (sub-pixel LK differences move a replenished
# corner now and then, and the solve amplifies them over frames)
LIDAR_TOL, VIS_TOL_M, VIS_TOL_Q = 1e-3, 5e-3, 1e-3


def _visual(m, clahe=False):
    return dataclasses.replace(_config(m).visual, use_clahe=clahe)


@pytest.fixture(scope="module")
def jax_side(seq_data):  # noqa: F811
    """Every JAX run of this file inside one interpret-mode routing: the
    per-frame frontend over four frames with CLAHE off and on (with its state
    before each frame), frame 1's tracking and step from the state after
    frame 0, and the cam-lidar pipeline per frame (twice: 10 Hz stamps, and
    a scan without an image) and chunked over uint16."""
    _, scans, images = seq_data
    cfg = _config(jcfg)
    pipe = jcl.CamLidarPipeline(cfg)
    clouds = [pipe._cam_cloud(s[:, :3]) for s in scans]
    out = {"clouds": clouds}
    with lk_through_pallas_interpret():
        for clahe in (False, True):
            vo = jvf.VisualOdometry(pipe.cam, _visual(jcfg, clahe))
            poses, states = [], []
            for k in range(N_FRAMES):
                states.append((vo.table, vo.pose_w, vo.warm_rel, vo.prev_pyr, vo.prev_dc))
                poses.append(vo.process(jnp.asarray(images[k]), jnp.asarray(clouds[k][0]),
                                        jnp.asarray(clouds[k][1])))
            out[f"vo_clahe_{clahe}"] = poses, states
        vcfg = _visual(jcfg)
        table, pose_w, warm_rel, prev_pyr, prev_dc = out["vo_clahe_False"][1][1]
        pyr1 = tuple(jimg.build_pyramid(jnp.asarray(images[1]), vcfg.lk_levels))
        out["step1"] = jvf.visual_step(prev_pyr, pyr1, prev_dc, table, pose_w, warm_rel,
                                       pipe.cam, vcfg)
        out["track1"] = jlk.track_pyramid_reverse_checked(
            prev_pyr, pyr1, table.uv, table.active, table.flow, win=vcfg.lk_window,
            iters=vcfg.lk_iters, levels=vcfg.lk_levels, max_reverse_err=vcfg.reverse_check_px,
            reverse_levels=vcfg.lk_reverse_levels or None,
            iters_coarse=vcfg.lk_iters_coarse or None, eps=vcfg.lk_eps, affine=vcfg.lk_affine,
            reverse_affine=vcfg.lk_reverse_affine)
        out["external"] = jvf.update_after_external_solve(*out["track1"], prev_dc, table, pose_w,
                                                          out["step1"][1], pipe.cam)
        out["run"] = jcl.CamLidarPipeline(cfg).run(scans, images)
        out["run_gap"] = jcl.CamLidarPipeline(cfg).run(scans, images,
                                                       scan_stamps=GAP_SCAN_STAMPS)
        out["uint16"] = jcl.CamLidarPipeline(cfg).run_chunked(scans, images, chunk=N_FRAMES - 1)
    return out


def _state(states, k):
    table, pose_w, warm_rel, prev_pyr, prev_dc = states[k]
    return (vf.FeatureTable(*_to_torch(tuple(table))), se3.Pose(*_to_torch(tuple(pose_w))),
            se3.Pose(*_to_torch(tuple(warm_rel))), _to_torch(tuple(prev_pyr)),
            vf.DepthCloud(*_to_torch(tuple(prev_dc))))


def test_visual_step_matches_jax(seq_data, jax_side, port_cfg):  # noqa: F811
    """Frame 1 from the JAX frontend's state after frame 0: as
    tests/test_torch_camlidar.py's frame step, the relative rotation to 2e-6
    and translation to 2e-4 m, tracked features to 2e-3 px."""
    _, _, images = seq_data
    cfg, cam = port_cfg
    table, pose_w, warm_rel, prev_pyr, prev_dc = _state(jax_side["vo_clahe_False"][1], 1)
    pyr1 = tuple(timg.build_pyramid(torch.from_numpy(images[1]), cfg.visual.lk_levels))
    got_table, rel, got_pose = vf.visual_step(prev_pyr, pyr1, prev_dc, table, pose_w, warm_rel,
                                              cam, cfg.visual)
    want_table, want_rel, want_pose = jax_side["step1"]
    np.testing.assert_allclose(rel.t.numpy(), np.asarray(want_rel.t), atol=2e-4)
    np.testing.assert_allclose(rel.q.numpy(), np.asarray(want_rel.q), atol=2e-6)
    np.testing.assert_allclose(got_pose.t.numpy(), np.asarray(want_pose.t), atol=2e-4)
    tracked = np.asarray(want_table.age) > 0
    assert tracked.sum() > 30
    np.testing.assert_array_equal(got_table.active.numpy()[tracked],
                                  np.asarray(want_table.active)[tracked])
    np.testing.assert_allclose(got_table.uv.numpy()[tracked],
                               np.asarray(want_table.uv)[tracked], atol=2e-3)


def test_update_after_external_solve_matches_jax(jax_side, port_cfg):
    """The JAX tracker's frame-1 tracks and relative pose handed to both
    packages' update: the same gates and the same table, the world pose to
    1e-5. The depths come from the ray/plane association and the
    triangulation, whose cancelling sums the reference's compiler fuses into
    multiply-adds: held to tests/test_torch_camlidar.py's 2e-3 relative
    (3.8e-4 at most measured, on 3 of 128 slots)."""
    _, cam = port_cfg
    table, pose_w, _, _, prev_dc = _state(jax_side["vo_clahe_False"][1], 1)
    uv1, ok = (_to_torch(x) for x in jax_side["track1"])
    rel = se3.Pose(*_to_torch(tuple(jax_side["step1"][1])))
    got_table, got_pose = vf.update_after_external_solve(uv1, ok, prev_dc, table, pose_w, rel, cam)
    want_table, want_pose = jax_side["external"]
    assert int(got_table.active.sum()) > 30
    for name in ("uv", "active", "age", "flow"):
        np.testing.assert_array_equal(getattr(got_table, name).numpy(),
                                      np.asarray(getattr(want_table, name)), err_msg=name)
    np.testing.assert_allclose(got_table.depth.numpy(), np.asarray(want_table.depth), rtol=2e-3)
    np.testing.assert_allclose(got_pose.t.numpy(), np.asarray(want_pose.t), atol=1e-5)
    np.testing.assert_allclose(got_pose.q.numpy(), np.asarray(want_pose.q), atol=1e-5)


@pytest.mark.parametrize("clahe", [False, True])
def test_visual_odometry_process_matches_jax(seq_data, jax_side, port_cfg, clahe):  # noqa: F811
    """Four frames through ``VisualOdometry.process``; frame 0 only seeds the
    table and stays at the identity."""
    _, _, images = seq_data
    cfg, cam = port_cfg
    vo = vf.VisualOdometry(cam, _visual(tcfg, clahe), device="cpu")
    for k, (want, (xyz, mask)) in enumerate(zip(jax_side[f"vo_clahe_{clahe}"][0],
                                                jax_side["clouds"], strict=True)):
        got = vo.process(torch.from_numpy(images[k]), torch.from_numpy(xyz),
                         torch.from_numpy(mask))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=VIS_TOL_M)
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=VIS_TOL_Q)
        if k == 0:
            np.testing.assert_array_equal(got.t.numpy(), 0.0)
    assert float(vo.pose_w.t[2]) > 2.5     # camera z = forward, 1 m a frame
    assert int(vo.table.active.sum()) > 30


def _close(got, want):
    np.testing.assert_allclose(got.lidar_positions, want.lidar_positions, atol=LIDAR_TOL)
    np.testing.assert_allclose(got.visual_positions, want.visual_positions, atol=VIS_TOL_M)
    np.testing.assert_allclose(got.visual_quats, want.visual_quats, atol=VIS_TOL_Q)


def test_camlidar_run_matches_jax(seq_data, jax_side, port_cfg):  # noqa: F811
    """``CamLidarPipeline.run`` at 10 Hz stamps: every scan pairs with its
    image. The lidar half is ``OdometryPipeline.run``'s bit for bit."""
    _, scans, images = seq_data
    cfg, _ = port_cfg
    got = tcl.CamLidarPipeline(cfg, device="cpu").run(scans, images)
    assert got.visual_positions.shape == got.lidar_positions.shape == (N_FRAMES, 3)
    _close(got, jax_side["run"])
    np.testing.assert_array_equal(got.lidar_positions,
                                  OdometryPipeline(cfg, device="cpu").run(scans).positions)


def test_camlidar_run_pairs_by_match_nearest(seq_data, jax_side, port_cfg):  # noqa: F811
    """A scan 0.3 s from every image pairs with none and keeps the last
    visual pose, as the reference's run does."""
    _, scans, images = seq_data
    cfg, _ = port_cfg
    got = tcl.CamLidarPipeline(cfg, device="cpu").run(scans, images, scan_stamps=GAP_SCAN_STAMPS)
    _close(got, jax_side["run_gap"])
    np.testing.assert_array_equal(got.visual_positions[3], got.visual_positions[2])
    np.testing.assert_array_equal(got.visual_positions[:3],
                                  tcl.CamLidarPipeline(cfg, device="cpu").run(
                                      scans[:3], images[:3]).visual_positions)


def test_camlidar_run_chunked_uint16_matches_jax(seq_data, jax_side, port_cfg):  # noqa: F811
    """The default ingest: the scans quantised at 3.9 mm with a count a
    frame, the camera clouds cut on the host and quantised alike, the images
    as uint8."""
    _, scans, images = seq_data
    cfg, _ = port_cfg
    got = tcl.CamLidarPipeline(cfg, device="cpu").run_chunked(scans, images, chunk=N_FRAMES - 1)
    assert got.visual_positions.shape == (N_FRAMES, 3)
    _close(got, jax_side["uint16"])
