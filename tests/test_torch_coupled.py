"""The port's coupled cam-lidar mode against the JAX package on the CPU: the
visual prior's gate, ``camlidar_coupled_chunk`` on the JAX run's own inputs,
and ``CamLidarPipeline.run_chunked(coupled=True)`` on five frames in chunks of
two, with the ingest checks of the coupled and mapping modes. The mapping
modes are in ``tests/test_torch_coupled_mapping.py``.

Sizes: 512 azimuth bins, a 320 × 96 camera, 128 feature slots, 4096 depth
points. The JAX tracker's levels run on the Pallas ``lk_level`` in interpret
mode (the TPU's semantics, which the port's kernel K6 reproduces), all JAX
runs of a file inside one such routing.

Tolerances: on the same inputs the chunk's poses agree within 1e-3 m (the
lidar solve's float32 rounding, tests/test_torch_odometry.py, fed back into
the next frame's warm start) and 5e-3 m for the camera (the visual solve,
tests/test_torch_camlidar.py); from raw scans ``run_chunked`` packs the
polar images with the native packer, as the JAX package does, so the lidar
poses there are held to ``RAW_LIDAR_TOL_M`` (measured 1.3e-4 m)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.data.native_pack import pack_polar_chunk as jpack
from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.models import lidar_odometry as jlo
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.models import visual_frontend as jvf
from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.ops import pointcloud as tpc
from lidar_visual_odometry_tpu_torch.ops import se3
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_camlidar import CAM, EXT, VIS, _state_to_torch
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(2)

N_FRAMES, CHUNK = 5, 2
LIDAR_TOL_M, VISUAL_TOL_M, QUAT_TOL = 1e-3, 5e-3, 1e-3
RAW_LIDAR_TOL_M = 5e-4


def config(m):
    """tests/test_torch_camlidar.py's camera configuration at 512 azimuth
    bins."""
    return m.SystemConfig(
        lidar=m.LidarConfig(azimuth_bins=512),
        camera=m.CameraConfig(**CAM),
        visual=m.VisualConfig(**VIS),
        extrinsic=m.ExtrinsicConfig(matrix=EXT),
    )


@pytest.fixture(scope="module")
def seq_data():
    seq = jsyn.SyntheticSequence(n_frames=N_FRAMES, width=600, speed=1.0, yaw_rate=0.004,
                                 noise=0.01)
    scans = [seq.scan(k) for k in range(N_FRAMES)]
    images = [jsyn.render_image(seq.scene, *jsyn.camera_from_velodyne_pose(*seq.pose(k)),
                                **CAM)[0] for k in range(N_FRAMES)]
    return seq, scans, images


def chunk_inputs(scans, images, cfg):
    """The first chunk's device inputs as the JAX ``run_chunked`` makes them
    (its native packer, uint8 images, clouds decoded from the polar images)
    and its frame-0 states, on both sides."""
    lcfg, vcfg = cfg.lidar, cfg.visual
    E = np.asarray(cfg.extrinsic.matrix, np.float32)
    R_cl, t_cl = E[:, :3], np.ascontiguousarray(E[:, 3])
    packed = jpack([s[:, :3] for s in scans[1:1 + CHUNK]], n_scans=lcfg.n_scans,
                   width=lcfg.azimuth_bins, min_range=lcfg.min_range, max_range=lcfg.max_range,
                   n_frames=CHUNK, channels=1)
    imgs8 = np.stack([np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)
                      for im in images[1:1 + CHUNK]])
    clouds, cmasks = jcl.cam_clouds_from_polar(jnp.asarray(packed), jnp.asarray(R_cl),
                                               jnp.asarray(t_cl), lcfg, vcfg.depth_cloud_cap)
    xyz0, mask0 = jpc.pad_points(scans[0][:, :3], 131072)
    feats0 = jsr.register_scan(jnp.asarray(xyz0), jnp.asarray(mask0), lcfg).features
    cx0, cm0 = jcl.camera_cloud_select(scans[0][:, :3], R_cl, t_cl, vcfg.depth_cloud_cap)
    vis0 = jvf.init_chunk_state(jnp.asarray(images[0]), jnp.asarray(cx0), jnp.asarray(cm0),
                                jcam.Pinhole.from_config(cfg.camera), vcfg)
    odo0 = jlo.init_state(feats0)
    arrays = {"pose_w_q": np.asarray(odo0.pose_w.q), "pose_w_t": np.asarray(odo0.pose_w.t),
              "pose_rel_q": np.asarray(odo0.pose_rel.q), "pose_rel_t": np.asarray(odo0.pose_rel.t)}
    for prefix, fc in (("prev_ls", odo0.prev_less_sharp), ("prev_lf", odo0.prev_less_flat)):
        for key in ("xyz", "ring", "rel_time", "mask"):
            arrays[f"{prefix}_{key}"] = np.asarray(getattr(fc, key))
    return dict(pimgs=tpc.polar_image_to_tensor(packed, "cpu"), imgs=torch.from_numpy(imgs8),
                clouds=torch.from_numpy(np.array(clouds)),
                cmasks=torch.from_numpy(np.array(cmasks)),
                odo0=lo.odometry_state_from_numpy(arrays, device="cpu"),
                vis0=_state_to_torch(vis0))


def port_pipe():
    return tcl.CamLidarPipeline(config(tcfg), device="cpu")


def outputs(res):
    """A ``CamLidarResult``'s arrays, the mapped ones where present."""
    names = ("lidar_positions", "lidar_quats", "visual_positions", "visual_quats",
             "mapped_positions", "mapped_quats")
    return {n: getattr(res, n) for n in names if getattr(res, n) is not None}


def assert_close(got: dict, want: dict, lidar_tol=LIDAR_TOL_M, map_tol=5e-3):
    assert sorted(got) == sorted(want)
    tols = {"lidar_positions": lidar_tol, "visual_positions": VISUAL_TOL_M,
            "mapped_positions": map_tol}
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], atol=tols.get(name, QUAT_TOL),
                                   err_msg=name)


@pytest.fixture(scope="module")
def coupled_runs(seq_data, tmp_path_factory):
    """The JAX package's coupled run and the first chunk's inputs, in one
    interpret-mode routing, and beside them in a worker thread the port's
    coupled ``run_chunked``: uninterrupted, stopped after frame 2 (a
    checkpoint in ``path``) and resumed."""
    _, scans, images = seq_data
    path = str(tmp_path_factory.mktemp("coupled") / "coupled.npz")

    def port_runs():
        pipe = port_pipe()
        kw = dict(chunk=CHUNK, ingest="polar2", coupled=True)
        full = outputs(pipe.run_chunked(scans, images, **kw))
        kw.update(checkpoint_path=path)
        stopped = outputs(pipe.run_chunked(scans, images, checkpoint_every=2, stop_after=2, **kw))
        resumed = outputs(pipe.run_chunked(scans, images, resume=True, **kw))
        return dict(full=full, stopped=stopped, resumed=resumed, path=path)

    cfg = config(jcfg)
    with ThreadPoolExecutor(1) as ex, lk_through_pallas_interpret():
        port = ex.submit(port_runs)
        inputs = chunk_inputs(scans, images, cfg)
        res = jcl.CamLidarPipeline(cfg).run_chunked(scans, images, chunk=CHUNK, ingest="polar2",
                                                     coupled=True)
        return inputs, outputs(res), port.result()


@pytest.fixture(scope="module")
def jax_coupled(coupled_runs):
    """The first chunk's inputs and the JAX package's coupled run."""
    return coupled_runs[:2]


# ---- the gate ----------------------------------------------------------------------

def _extrinsics():
    pipe = port_pipe()
    return pipe.T_lidar_cam, pipe.T_cam_lidar


def _jpose(p):
    return jse3.Pose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy()))


CASES = ["plausible", "nan", "long_step", "large_angle", "few_tracks", "enough_tracks"]


@pytest.mark.parametrize("case", CASES)
def test_visual_prior_gate_matches_jax(rng, case):
    """``visual_prior_gate`` on a random camera motion (a plausible one, and
    each way to fail: a NaN, a step over ``max_prior_step``, an angle over
    0.6 rad, too few tracks), against the JAX function on the same poses:
    the same choice, and the same pose bit for bit."""
    T_lc, T_cl = _extrinsics()
    w = rng.normal(size=3) * 0.02
    v = rng.normal(size=3) * 0.3
    if case == "long_step":
        v = np.array([0.0, 0.0, 2.5])
    if case == "large_angle":
        w = np.array([0.0, 0.7, 0.0])
    rel = se3.se3_exp(torch.tensor(np.concatenate([v, w]), dtype=torch.float32))
    if case == "nan":
        rel = se3.Pose(rel.q, torch.tensor([0.1, float("nan"), 0.2]))
    fallback = se3.Pose(torch.tensor([0.99999, 0.0, 0.0045, 0.0]), torch.tensor([0.0, 0.0, 0.9]))
    fallback = se3.Pose(se3.quat_normalize(fallback.q), fallback.t)
    kw = {}
    if case in ("few_tracks", "enough_tracks"):
        kw = dict(min_tracked=64)
        n = 63 if case == "few_tracks" else 64
    got = tcl.visual_prior_gate(fallback, rel, T_lc, T_cl, 2.0,
                                n_tracked=torch.tensor(n) if kw else None, **kw)
    want = jcl.visual_prior_gate(_jpose(fallback), _jpose(rel), _jpose(T_lc), _jpose(T_cl), 2.0,
                                 n_tracked=jnp.asarray(n) if kw else None, **kw)
    fell_back = bool(torch.equal(got.q, fallback.q) and torch.equal(got.t, fallback.t))
    assert fell_back == (case not in ("plausible", "enough_tracks")), case
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


# ---- the coupled chunk and run -----------------------------------------------------

def test_coupled_chunk_matches_jax(jax_coupled):
    """``camlidar_coupled_chunk`` on the first chunk's inputs and frame-0
    states as the JAX run made them: its lidar and camera poses are the JAX
    run's frames 1-2."""
    inp, want = jax_coupled
    pipe = port_pipe()
    cfg = pipe.cfg
    odo, vis, lidar, visual = tcl.camlidar_coupled_chunk(
        inp["odo0"], inp["vis0"], inp["pimgs"], inp["imgs"], inp["clouds"], inp["cmasks"],
        pipe.T_lidar_cam, pipe.T_cam_lidar, pipe.cam, cfg.lidar, cfg.odometry, cfg.visual)
    rows = slice(1, 1 + CHUNK)
    np.testing.assert_allclose(lidar.t.numpy(), want["lidar_positions"][rows], atol=LIDAR_TOL_M)
    np.testing.assert_allclose(lidar.q.numpy(), want["lidar_quats"][rows], atol=QUAT_TOL)
    vq, vt = tcl._map_cam_poses_to_lidar(visual.q, visual.t, pipe.T_lidar_cam, pipe.T_cam_lidar)
    np.testing.assert_allclose(vt.numpy(), want["visual_positions"][rows], atol=VISUAL_TOL_M)
    np.testing.assert_allclose(vq.numpy(), want["visual_quats"][rows], atol=QUAT_TOL)
    torch.testing.assert_close(odo.pose_w.t, lidar.t[-1], rtol=0, atol=0)
    torch.testing.assert_close(vis.pose_w.t, visual.t[-1], rtol=0, atol=0)


def test_run_chunked_coupled_matches_jax(seq_data, coupled_runs):
    """``run_chunked(coupled=True)`` from the raw scans: the JAX run's
    trajectories; the car moves 1 m a frame, so the coupled lidar poses land
    near the truth. Stopped after frame 2 and resumed, it equals the
    uninterrupted run bit for bit; its checkpoint cannot resume a mapping
    run (it carries no map state)."""
    seq, scans, images = seq_data
    _, want, port = coupled_runs
    res = port["full"]
    assert_close(res, want, lidar_tol=RAW_LIDAR_TOL_M)
    R0, t0 = seq.pose(0)
    gt = np.stack([R0.T @ (seq.pose(k)[1] - t0) for k in range(N_FRAMES)])
    assert np.abs(res["lidar_positions"] - gt).max() < 0.05
    for name in res:
        np.testing.assert_array_equal(port["stopped"][name], res[name][:3])
        np.testing.assert_array_equal(port["resumed"][name], res[name])
    with pytest.raises(ValueError, match="no map state"):
        port_pipe().run_chunked(scans, images, chunk=CHUNK, ingest="polar2", coupled=True,
                                checkpoint_path=port["path"], resume=True, mapping=True)


@pytest.mark.parametrize("kw", [dict(coupled=True), dict(mapping=True),
                                dict(coupled=True, mapping=True)])
def test_coupled_and_mapping_modes_need_a_polar_ingest(seq_data, kw):
    """The JAX package asserts a polar ingest in these modes; the port
    raises ``ValueError``, before any work, as for its other ingest checks."""
    _, scans, images = seq_data
    with pytest.raises(ValueError, match="polar ingest"):
        port_pipe().run_chunked(scans, images, ingest="uint16", **kw)
    with pytest.raises(ValueError, match="ingest"):
        port_pipe().run_chunked(scans, images, ingest="float", **kw)
