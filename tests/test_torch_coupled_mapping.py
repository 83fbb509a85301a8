"""The port's uncoupled cam-lidar mapping mode against the JAX package on the
CPU: ``camlidar_slam_chunk`` with ``map_skip`` 1 on the JAX run's own inputs
and ``run_chunked(mapping=True)``. The coupled mapping mode and its
checkpoints are in ``tests/test_torch_coupled_mapping_resume.py``, which
imports this file's helpers (a file each, so that their JAX compilations run
on two workers).

Sizes and routing as ``tests/test_torch_coupled.py``, with the default map
(``MappingConfig()``). Tolerances: the lidar and camera poses as in
``tests/test_torch_coupled.py``; mapped positions 1e-2 m (the reference's
plane fits are ill-conditioned tens of metres out: LU against the port's
cofactors, ROADMAP "decided differences"), mapped quaternions 1e-3."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import device_mapping as dm
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_coupled import (CHUNK, LIDAR_TOL_M, N_FRAMES, QUAT_TOL, RAW_LIDAR_TOL_M,
                                VISUAL_TOL_M, assert_close, chunk_inputs, outputs,
                                seq_data)  # noqa: F401
from test_torch_coupled import config
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(2)

MAP_TOL_M = 1e-2
STOP = dict(checkpoint_every=2, stop_after=2)
MODES = {"mapping": dict(mapping=True), "both": dict(coupled=True, mapping=True, map_skip=2)}


def port_pipe():
    return tcl.CamLidarPipeline(config(tcfg), device="cpu")


def run_kw(mode, **extra):
    return dict(chunk=CHUNK, ingest="polar2", **MODES[mode], **extra)


def mode_runs(mode, scans, images, tmp=None):
    """The runs of ``mode`` that the tests compare: the port's and the JAX
    package's, the first chunk's inputs and the port's ``camlidar_slam_chunk``
    outputs on them, the JAX runs in one interpret-mode routing. With
    ``tmp`` also the checkpoints: the port's run stopped after frame 2 (its
    snapshot written before the JAX package resumes from it inside the
    routing) and resumed, and the JAX package's stopped run, resumed in the
    port. The port's runs go in a worker thread beside the JAX runs they do
    not depend on."""
    out = {}
    pipe = port_pipe()

    def port_first():
        out["port"] = outputs(pipe.run_chunked(scans, images, **run_kw(mode)))
        if tmp is not None:
            out["port_stopped"] = outputs(pipe.run_chunked(
                scans, images, **run_kw(mode, checkpoint_path=out["port_ckpt"], **STOP)))

    def port_resumed():
        out["port_resumed"] = outputs(pipe.run_chunked(
            scans, images, **run_kw(mode, checkpoint_path=out["port_ckpt"], resume=True)))
        out["port_from_jax"] = outputs(pipe.run_chunked(
            scans, images, **run_kw(mode, checkpoint_path=out["jax_ckpt"], resume=True)))

    if tmp is not None:
        out["port_ckpt"], out["jax_ckpt"] = str(tmp / "port.npz"), str(tmp / "jax.npz")
    cfg = config(jcfg)
    with ThreadPoolExecutor(1) as ex, lk_through_pallas_interpret():
        first = ex.submit(port_first)
        out["inputs"] = chunk_inputs(scans, images, cfg)
        chunk = ex.submit(slam_chunk_outputs, out["inputs"], mode)
        jpipe = jcl.CamLidarPipeline(cfg)
        out["jax"] = outputs(jpipe.run_chunked(scans, images, **run_kw(mode)))
        if tmp is not None:
            jpipe.run_chunked(scans, images, **run_kw(mode, checkpoint_path=out["jax_ckpt"],
                                                     **STOP))
            first.result()
            resumed = ex.submit(port_resumed)
            out["jax_from_port"] = outputs(jpipe.run_chunked(
                scans, images, **run_kw(mode, checkpoint_path=out["port_ckpt"], resume=True)))
            resumed.result()
        first.result()
        out["slam_chunk"] = chunk.result()
    return out


def close(got, want):
    """From the raw scans both packages pack the polar images with the
    native packer; at 512 azimuth bins the lidar trajectories then lie up to
    9.2e-5 m apart over four frames (1.3e-4 m in the coupled mode):
    ``RAW_LIDAR_TOL_M``."""
    assert_close(got, want, lidar_tol=RAW_LIDAR_TOL_M, map_tol=MAP_TOL_M)


def slam_chunk_outputs(inp, mode):
    """The port's ``camlidar_slam_chunk`` on the first chunk's inputs and
    frame-0 states as the JAX run made them (frames 1-2), its map state, and
    the chunks without mapping on the same inputs (coupled or not, as
    ``mode``)."""
    pipe = port_pipe()
    cfg = pipe.cfg
    frames = (inp["pimgs"], inp["imgs"], inp["clouds"], inp["cmasks"])
    ext = (pipe.T_lidar_cam, pipe.T_cam_lidar, pipe.cam, cfg.lidar, cfg.odometry)
    kw = dict(map_skip=MODES[mode].get("map_skip", 1), coupled=MODES[mode].get("coupled", False))
    _, mp, _, odom, mapped, visual = tcl.camlidar_slam_chunk(
        inp["odo0"], dm.init_state(cfg.mapping, "cpu"), inp["vis0"], *frames, *ext,
        cfg.mapping, cfg.visual, start_idx=1, **kw)
    if kw["coupled"]:
        _, _, lidar_c, visual_c = tcl.camlidar_coupled_chunk(inp["odo0"], inp["vis0"], *frames,
                                                             *ext, cfg.visual)
    else:
        _, lidar_c = lo.odometry_chunk_polar(inp["odo0"], inp["pimgs"], cfg.lidar, cfg.odometry,
                                             device="cpu")
        _, visual_c = vf.visual_chunk(inp["vis0"], *frames[1:], pipe.cam, cfg.visual)
    return dict(map_state=mp, odom=odom, mapped=mapped, visual=visual, lidar_c=lidar_c,
                visual_c=visual_c)


def check_slam_chunk(runs, mode):
    """``camlidar_slam_chunk`` on the first chunk's inputs and frame-0 states
    as the JAX run made them (frames 1-2; with ``map_skip`` 2 frame 1
    composes the correction and frame 2 is mapped): the JAX run's poses. Its
    odometry and camera poses are those of the chunks without mapping on the
    same inputs, bit for bit: mapping does not feed back into odometry."""
    want, got = runs["jax"], runs["slam_chunk"]
    pipe = port_pipe()
    odom, mapped, visual = got["odom"], got["mapped"], got["visual"]
    rows = slice(1, 1 + CHUNK)
    np.testing.assert_allclose(odom.t.numpy(), want["lidar_positions"][rows], atol=LIDAR_TOL_M)
    np.testing.assert_allclose(mapped.t.numpy(), want["mapped_positions"][rows], atol=MAP_TOL_M)
    np.testing.assert_allclose(mapped.q.numpy(), want["mapped_quats"][rows], atol=QUAT_TOL)
    vq, vt = tcl._map_cam_poses_to_lidar(visual.q, visual.t, pipe.T_lidar_cam, pipe.T_cam_lidar)
    np.testing.assert_allclose(vt.numpy(), want["visual_positions"][rows], atol=VISUAL_TOL_M)
    if MODES[mode].get("map_skip", 1) == 2:
        # frame 1 is not mapped: the correction (identity on an empty map) applies
        torch.testing.assert_close(mapped.t[0], odom.t[0], rtol=0, atol=0)
    for a, b in ((odom, got["lidar_c"]), (visual, got["visual_c"])):
        torch.testing.assert_close(a.t, b.t, rtol=0, atol=0)
        torch.testing.assert_close(a.q, b.q, rtol=0, atol=0)
    assert got["map_state"].corner_mask.any() and got["map_state"].surf_mask.any()


@pytest.fixture(scope="module")
def runs(seq_data):  # noqa: F811
    _, scans, images = seq_data
    return mode_runs("mapping", scans, images)


def test_slam_chunk_matches_jax(runs):
    check_slam_chunk(runs, "mapping")


def test_run_chunked_mapping_matches_jax(runs):
    """``run_chunked(mapping=True)`` (uncoupled, ``map_skip`` 1) from the raw
    scans: the JAX run's lidar, camera and mapped trajectories."""
    assert runs["port"]["mapped_positions"].shape == (N_FRAMES, 3)
    close(runs["port"], runs["jax"])
