"""Checkpoint / resume of the port's four ``run_chunked``s against the JAX
package's on the CPU: ``OdometryPipeline`` (its default ``"float"``
ingest), ``FullPipeline`` (``"uint16"``), ``CamLidarPipeline`` (``"uint16"``)
and ``DirectVOChunked``.

Five frames in chunks of two: a run with ``checkpoint_every=2`` and
``stop_after=2`` stops at the first chunk boundary past frame 2 (frames 0-2
done) and leaves a snapshot there, as the reference's drivers do. For each
path:

* the port's stopped run, resumed, equals its uninterrupted run bit for bit;
* a checkpoint written by the JAX package resumes in the port, within the
  path's parity tolerance of the JAX package's uninterrupted run;
* a checkpoint written by the port has the JAX package's keys, shapes and
  dtypes, loads in its ``load_checkpoint`` / ``load_chunk_states`` /
  ``load_map_state``, and resumes there within the same tolerance.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.models import direct_vo as jdv
from lidar_visual_odometry_tpu.models import pipeline as jpipe
from lidar_visual_odometry_tpu.utils import checkpoint as jckpt
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import direct_vo as tdv
from lidar_visual_odometry_tpu_torch.models import pipeline as tpipe
from lidar_visual_odometry_tpu_torch.utils import checkpoint as tckpt
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_camlidar import CAM, _config as camlidar_config
from test_torch_direct import CAP, jax_cam, port_cam
from test_torch_drivers import CAPACITY, MAP_TOL_M, MAP_TOL_Q, ODOM_TOL_M, ODOM_TOL_Q, _configs
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(4)

N_FRAMES, CHUNK, EVERY, STOP_AFTER = 5, 2, 2, 2
PATHS = ("odometry", "slam", "camlidar", "direct")
# each path's parity tolerance (tests/test_torch_drivers.py, test_torch_mapping.py,
# test_torch_camlidar.py and test_torch_direct.py, BA off), one an output array
TOLERANCES = {
    "odometry": (ODOM_TOL_M, ODOM_TOL_Q),
    "slam": (ODOM_TOL_M, ODOM_TOL_Q, MAP_TOL_M, MAP_TOL_Q),
    "camlidar": (1e-3, 1e-3, 5e-3, 1e-3),
    "direct": (5e-4, 5e-4),
}


@functools.cache
def _inputs(lidar_only: bool):
    """The lidar paths run the corridor of tests/test_torch_drivers.py, where
    their tolerances were set; the camera paths that of
    tests/test_torch_camlidar.py (faster and noisier), with its images and
    camera-frame clouds."""
    if lidar_only:
        seq = jsyn.SyntheticSequence(n_frames=N_FRAMES, width=600, noise=0.005)
        return [seq.scan(k) for k in range(N_FRAMES)], None, None, None
    seq = jsyn.SyntheticSequence(n_frames=N_FRAMES, width=600, speed=1.0, yaw_rate=0.004,
                                 noise=0.01)
    scans = [seq.scan(k) for k in range(N_FRAMES)]
    images = [jsyn.render_image(seq.scene, *jsyn.camera_from_velodyne_pose(*seq.pose(k)),
                                **CAM)[0] for k in range(N_FRAMES)]
    pipe = tcl.CamLidarPipeline(camlidar_config(tcfg), device="cpu")
    clouds, masks = zip(*(pipe._cam_cloud(s[:, :3]) for s in scans))
    return scans, images, list(clouds), list(masks)


def _direct_cfg(m):
    return m.VisualConfig(pyramid_levels=3, keyframe_window=3)


def run(path: str, side: str, **kw) -> tuple[np.ndarray, ...]:
    """One ``run_chunked`` of ``path`` in the JAX package (``side`` "jax")
    or the port ("port"); its output arrays in a fixed order."""
    scans, images, clouds, masks = _inputs(path in ("odometry", "slam"))
    m, port = (tcfg, True) if side == "port" else (jcfg, False)
    dev = dict(device="cpu") if port else {}
    if path in ("odometry", "slam"):
        cfg = _configs()[1 if port else 0]
        if path == "odometry":
            cls = tpipe.OdometryPipeline if port else jpipe.OdometryPipeline
            res = cls(cfg, capacity=CAPACITY, **dev).run_chunked(scans, chunk=CHUNK, **kw)
            return res.positions, res.quaternions
        cls = tpipe.FullPipeline if port else jpipe.FullPipeline
        odo, mapped = cls(cfg, capacity=CAPACITY, **dev).run_chunked(scans, chunk=CHUNK,
                                                                      map_skip=1, **kw)
        return odo.positions, odo.quaternions, mapped.positions, mapped.quaternions
    if path == "camlidar":
        cls = tcl.CamLidarPipeline if port else jcl.CamLidarPipeline
        res = cls(camlidar_config(m), capacity=CAPACITY, **dev).run_chunked(
            scans, images, chunk=CHUNK, **kw)
        return res.lidar_positions, res.lidar_quats, res.visual_positions, res.visual_quats
    if port:
        vo = tdv.DirectVOChunked(port_cam(), _direct_cfg(tcfg), point_cap=CAP,
                                 run_window_ba=False, device="cpu")
    else:
        vo = jdv.DirectVOChunked(jax_cam(), _direct_cfg(jcfg), point_cap=CAP, run_window_ba=False)
    positions, quats, _ = vo.run_chunked(images, clouds, masks, chunk=CHUNK, **kw)
    return positions, quats


def _routing(path: str):
    """The JAX camera path's tracker on the Pallas kernel in interpret mode
    (tests/test_torch_visual.py); the routing clears JAX's caches, so the
    other paths run without it."""
    return lk_through_pallas_interpret() if path == "camlidar" else contextlib.nullcontext()


@functools.cache
def _runs(path: str, tmp: str) -> dict:
    """Every run of ``path`` that the tests compare, the JAX ones inside one
    routing."""
    stop = dict(checkpoint_every=EVERY, stop_after=STOP_AFTER)
    out = {"port_full": run(path, "port"),
           "port_ckpt": f"{tmp}/{path}_port.npz", "jax_ckpt": f"{tmp}/{path}_jax.npz"}
    out["port_stopped"] = run(path, "port", checkpoint_path=out["port_ckpt"], **stop)
    out["port_resumed"] = run(path, "port", checkpoint_path=out["port_ckpt"], resume=True)
    with _routing(path):
        out["jax_full"] = run(path, "jax")
        run(path, "jax", checkpoint_path=out["jax_ckpt"], **stop)
        # the JAX package resumes from the port's snapshot (written above)
        out["jax_from_port"] = run(path, "jax", checkpoint_path=out["port_ckpt"], resume=True)
    out["port_from_jax"] = run(path, "port", checkpoint_path=out["jax_ckpt"], resume=True)
    return out


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


def _close(got, want, path):
    assert len(got) == len(want) == len(TOLERANCES[path])
    for g, w, tol in zip(got, want, TOLERANCES[path]):
        assert g.shape == w.shape == (N_FRAMES, g.shape[1])
        np.testing.assert_allclose(g, w, atol=tol)


@pytest.mark.parametrize("path", PATHS)
def test_stop_and_resume_equal_the_uninterrupted_run(path, tmp):
    """The stopped run returns frames 0-2; the resumed one replays the same
    operations on the same carried state: the same bits as one run."""
    r = _runs(path, tmp)
    for stopped, full, resumed in zip(r["port_stopped"], r["port_full"], r["port_resumed"]):
        assert stopped.shape[0] == STOP_AFTER + 1
        np.testing.assert_array_equal(stopped, full[:STOP_AFTER + 1])
        np.testing.assert_array_equal(resumed, full)
    assert int(np.load(r["port_ckpt"])["frame_idx"]) == STOP_AFTER + 1


@pytest.mark.parametrize("path", PATHS)
def test_jax_checkpoint_resumes_in_the_port(path, tmp):
    r = _runs(path, tmp)
    _close(r["port_from_jax"], r["jax_full"], path)


@pytest.mark.parametrize("path", PATHS)
def test_port_checkpoint_loads_in_jax(path, tmp):
    """Keys, shapes and dtypes as the JAX package writes them; its readers
    restore the states, and its run resumes from them."""
    r = _runs(path, tmp)
    ours, theirs = np.load(r["port_ckpt"]), np.load(r["jax_ckpt"])
    assert sorted(ours.files) == sorted(theirs.files)
    for key in theirs.files:
        assert ours[key].shape == theirs[key].shape, key
        assert ours[key].dtype == theirs[key].dtype, key
    frame_idx, state, traj_q, traj_t = jckpt.load_checkpoint(r["port_ckpt"])
    assert frame_idx == STOP_AFTER + 1
    np.testing.assert_array_equal(traj_t, ours["traj_t"])
    vchunk, dchunk = jckpt.load_chunk_states(r["port_ckpt"])
    assert (state is not None) == (path != "direct")
    assert (vchunk is not None) == (path == "camlidar")
    assert (dchunk is not None) == (path == "direct")
    if path == "slam":
        assert jckpt.load_map_state(r["port_ckpt"], (0.0,) * 6) is not None
    _close(r["jax_from_port"], r["jax_full"], path)


@pytest.mark.parametrize("path", ["odometry", "slam"])
def test_checkpoint_schedule_is_the_references(path, tmp_path):
    """``checkpoint_every`` without ``stop_after`` snapshots at every chunk
    boundary at least that far from the last (the last one at frame 5);
    without ``checkpoint_every`` nothing is written; ``stop_after`` alone
    stops at the first boundary past it (frame 3 done) without writing. The
    port's and the JAX package's runs do the same. (``DirectVOChunked``'s:
    tests/test_torch_pipeline_api.py.)"""
    seen = {}
    for side in ("port", "jax"):
        every = tmp_path / f"{side}_every.npz"
        never = tmp_path / f"{side}_never.npz"
        full = run(path, side, checkpoint_path=str(every), checkpoint_every=EVERY)
        run(path, side, checkpoint_path=str(never))
        cut = run(path, side, stop_after=1)
        seen[side] = (int(np.load(every)["frame_idx"]), never.exists(),
                      [a.shape[0] for a in full], [a.shape[0] for a in cut], cut)
    assert seen["port"][:4] == seen["jax"][:4] == (
        N_FRAMES, False, [N_FRAMES] * len(TOLERANCES[path]), [3] * len(TOLERANCES[path]))
    for got, want, tol in zip(seen["port"][4], seen["jax"][4], TOLERANCES[path]):
        np.testing.assert_allclose(got, want, atol=tol)
    loaded = tckpt.load_checkpoint(str(tmp_path / "jax_every.npz"), device="cpu")
    assert loaded[0] == N_FRAMES and loaded[1] is not None


def _per_frame_states(side: str, rng):
    """A host cube map, a device map and a visual frontend of each package,
    filled with the same random contents."""
    m = tcfg if side == "port" else jcfg
    mcfg = m.MappingConfig(map_corner_cap=256, map_surf_cap=512, max_corner_map_local=512,
                           max_surf_map_local=512)
    vcfg = m.VisualConfig(max_tracked=16, lk_levels=2)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    arr = {
        "cubes": [(rng.normal(size=(300, 3)) * [90.0, 60.0, 5.0]).astype(np.float32)
                  for _ in range(2)],
        "corr": (np.array([0.999, 0.01, -0.02, 0.03], np.float32),
                 np.array([1.0, -2.0, 0.5], np.float32)),
        "dmap": [rng.normal(size=(256, 3)).astype(np.float32), rng.uniform(size=256) > 0.5,
                 rng.normal(size=(512, 3)).astype(np.float32), rng.uniform(size=512) > 0.5],
        # FeatureTable: uv, active, depth, start_un, start_q, start_t, age, flow
        "table": [f32(16, 2), rng.uniform(size=16) > 0.3, f32(16) + 5.0, f32(16, 2), f32(16, 4),
                  f32(16, 3), rng.integers(0, 9, 16).astype(np.int32), f32(16, 2)],
        "pyr": [f32(96, 320), f32(48, 160)],
        "dc": [f32(64, 3), f32(64) + 5.0, rng.uniform(size=64) > 0.2],
    }
    if side == "port":
        from lidar_visual_odometry_tpu_torch.models import device_mapping as tdm
        from lidar_visual_odometry_tpu_torch.models import lidar_mapping as tlm
        from lidar_visual_odometry_tpu_torch.models import visual_frontend as tvf
        from lidar_visual_odometry_tpu_torch.ops import se3 as tse3

        t = torch.from_numpy
        mapper = tlm.LidarMapping(mcfg, device="cpu")
        mapper.correction = tse3.Pose(t(arr["corr"][0]), t(arr["corr"][1]))
        dmapper = tdm.DeviceMapping(mcfg, device="cpu")
        dmapper.state = tdm.DeviceMapState(*(t(a) for a in arr["dmap"]), mapper.correction)
        visual = tvf.VisualOdometry(port_cam(), vcfg, device="cpu")
        visual.table = tvf.FeatureTable(*(t(a) for a in arr["table"]))
        visual.pose_w = mapper.correction
        visual.prev_pyr = tuple(t(a) for a in arr["pyr"])
        visual.prev_dc = tvf.DepthCloud(*(t(a) for a in arr["dc"]))
    else:
        import jax.numpy as jnp
        from lidar_visual_odometry_tpu.models import device_mapping as jdm
        from lidar_visual_odometry_tpu.models import lidar_mapping as jlm
        from lidar_visual_odometry_tpu.models import visual_frontend as jvf
        from lidar_visual_odometry_tpu.ops import se3 as jse3

        t = jnp.asarray
        mapper = jlm.LidarMapping(mcfg)
        mapper.correction = jse3.Pose(t(arr["corr"][0]), t(arr["corr"][1]))
        dmapper = jdm.DeviceMapping(mcfg)
        dmapper.state = jdm.DeviceMapState(*(t(a) for a in arr["dmap"]), mapper.correction)
        visual = jvf.VisualOdometry(jax_cam(), vcfg)
        visual.table = jvf.FeatureTable(*(t(a) for a in arr["table"]))
        visual.pose_w = mapper.correction
        visual.prev_pyr = tuple(t(a) for a in arr["pyr"])
        visual.prev_dc = jvf.DepthCloud(*(t(a) for a in arr["dc"]))
    mapper.initialized = True
    for store, pts in zip((mapper.corner_map, mapper.surf_map), arr["cubes"]):
        store.insert(pts)
    dmapper._frame = 7
    return mapper, dmapper, visual


def _per_frame_arrays(mapper, dmapper, visual):
    """Everything a checkpoint restores into the per-frame drivers, as host
    arrays in a fixed order."""
    out = [np.asarray(mapper.correction.q), np.asarray(mapper.correction.t),
           np.asarray(mapper.initialized), np.asarray(dmapper._frame)]
    for store in (mapper.corner_map, mapper.surf_map):
        for k in sorted(store.cubes):
            out += [np.asarray(k), store.cubes[k]]
    for tree in (dmapper.state[:4], tuple(dmapper.state.correction), tuple(visual.table),
                 tuple(visual.pose_w), tuple(visual.warm_rel), visual.prev_pyr,
                 tuple(visual.prev_dc)):
        out += [np.asarray(x) for x in tree]
    return out


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_per_frame_driver_states_cross_packages(tmp_path, writer, reader):
    """The host cube store, the device map with its frame count and the
    visual frontend (table, poses, previous pyramid and depth cloud): written
    by one package's ``save_checkpoint``, restored in place by the other's
    ``load_checkpoint``, every array the same."""
    written = _per_frame_states(writer, np.random.default_rng(3))
    blank = _per_frame_states(reader, np.random.default_rng(4))
    path = str(tmp_path / "drivers.npz")
    save = tckpt.save_checkpoint if writer == "port" else jckpt.save_checkpoint
    save(path, frame_idx=9, trajectory_q=np.zeros((9, 4), np.float32),
         trajectory_t=np.zeros((9, 3), np.float32), mapper=written[0], device_mapper=written[1],
         visual=written[2])
    if reader == "port":
        got = tckpt.load_checkpoint(path, *blank, device="cpu")
    else:
        got = jckpt.load_checkpoint(path, *blank)
    assert got[0] == 9 and got[1] is None
    want = _per_frame_arrays(*written)
    restored = _per_frame_arrays(*blank)
    assert len(restored) == len(want)
    for a, b in zip(restored, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
