"""The port's pipeline entry points against the JAX package's: the four
``run_chunked`` signatures (names, order, defaults), the reference's default
ingests (``"float"`` for ``OdometryPipeline``, ``"uint16"`` for the others)
and checkpoint arguments, which run and match the JAX package's (the tests
named ``*_raise_naming_a7`` pinned them to ``NotImplementedError`` until
ROADMAP A.7 ported them), and the pyramidal tracker routing its levels as the
TPU does (kernel K6 only for slot counts that are a multiple of 8)."""

import contextlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.models import direct_vo as jdv
from lidar_visual_odometry_tpu.models import pipeline as jpipe
from lidar_visual_odometry_tpu.ops import image as jimg
from lidar_visual_odometry_tpu.ops import lk as jlk
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.kernels import lk as klk
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import direct_vo as tdv
from lidar_visual_odometry_tpu_torch.models import pipeline as tpipe
from lidar_visual_odometry_tpu_torch.ops import lk as tlk
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_direct import CAP as DIRECT_CAP, frames, jax_cam, port_cam  # noqa: F401
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(2)

PAIRS = {
    "odometry": (tpipe.OdometryPipeline, jpipe.OdometryPipeline),
    "slam": (tpipe.FullPipeline, jpipe.FullPipeline),
    "camlidar": (tcl.CamLidarPipeline, jcl.CamLidarPipeline),
}
CAM = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)
CAM_INTRINSICS = {k: CAM[k] for k in ("fx", "fy", "cx", "cy", "width", "height")}
CAPACITY = 65536


def _params(cls):
    sig = inspect.signature(cls.run_chunked)
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


@pytest.fixture(scope="module")
def seq():
    return jsyn.SyntheticSequence(n_frames=3, width=600, noise=0.005)


@pytest.fixture(scope="module")
def scans(seq):
    return [seq.scan(k) for k in range(3)]


@pytest.fixture(scope="module")
def images(seq):
    return [jsyn.render_image(seq.scene, *jsyn.camera_from_velodyne_pose(*seq.pose(k)),
                              **CAM)[0] for k in range(3)]


def _pipe(name):
    return PAIRS[name][0](tcfg.SystemConfig(), device="cpu")


def _run(name, pipe, scans, *args, images=None, **kw):
    if name == "camlidar":
        if images is None:
            images = [np.zeros((96, 320), np.uint8)] * len(scans)
        return pipe.run_chunked(scans, images, *args, **kw)
    return pipe.run_chunked(scans, *args, **kw)


def _small(m, name):
    """A configuration small enough for the CPU: 1024 azimuth bins, two
    re-association rounds, the mapping caps of tests/test_torch_mapping.py
    and a 320 × 96 camera with a 128-slot feature table."""
    kw = dict(lidar=m.LidarConfig(azimuth_bins=1024), odometry=m.OdometryConfig(outer_iters=2))
    if name == "slam":
        kw["mapping"] = m.MappingConfig(outer_iters=2, gn_iters=4, corner_slot=1024,
                                        surf_slot=1024, map_corner_cap=2048, map_surf_cap=2048)
    if name == "camlidar":
        kw["camera"] = m.CameraConfig(**CAM_INTRINSICS)
        kw["visual"] = m.VisualConfig(depth_cloud_cap=4096, lk_window=9, lk_levels=3,
                                      max_tracked=128, grid_rows=4, grid_cols=6)
    return m.SystemConfig(**kw)


def _arrays(name, res):
    """A ``run_chunked`` result as its arrays, with each one's tolerance
    against the JAX package (tests/test_torch_odometry.py's chunked
    pipeline, tests/test_torch_mapping.py's fused SLAM and
    tests/test_torch_camlidar.py's pipeline)."""
    if name == "odometry":
        return [(res.positions, 2e-4), (res.quaternions, 1e-5)]
    if name == "slam":
        odo, mapped = res
        return [(odo.positions, 2e-4), (odo.quaternions, 1e-5), (mapped.positions, 1e-2),
                (mapped.quaternions, 1e-3)]
    return [(res.lidar_positions, 1e-3), (res.lidar_quats, 1e-3), (res.visual_positions, 5e-3),
            (res.visual_quats, 1e-3)]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_run_chunked_signature_is_the_references(name):
    port, ref = PAIRS[name]
    assert _params(port) == _params(ref)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_run_chunked_default_ingest_raises_naming_a7(name, scans, images, tmp_path):
    """The default ingest runs and matches the JAX package's, and the
    checkpoint arguments run: one frame a chunk, stopped after frame 1 with
    a snapshot, then resumed, equals the default run bit for bit (the port
    runs a chunk frame by frame, so the chunk size changes no bits)."""
    port_cls, jax_cls = PAIRS[name]
    routing = lk_through_pallas_interpret() if name == "camlidar" else contextlib.nullcontext()
    with routing:
        want = _run(name, jax_cls(_small(jcfg, name), capacity=CAPACITY), scans, images=images)

    def port_run(**kw):
        return _run(name, port_cls(_small(tcfg, name), capacity=CAPACITY, device="cpu"), scans,
                    images=images, **kw)

    got = port_run()
    for (g, tol), (w, _) in zip(_arrays(name, got), _arrays(name, want), strict=True):
        assert g.shape == w.shape == (3, g.shape[1])
        np.testing.assert_allclose(g, w, atol=tol)
    path = str(tmp_path / "run.npz")
    stopped = port_run(chunk=1, checkpoint_path=path, checkpoint_every=8, stop_after=1)
    resumed = port_run(chunk=1, checkpoint_path=path, resume=True)
    for (g, _), (st, _), (r, _) in zip(_arrays(name, got), _arrays(name, stopped),
                                       _arrays(name, resumed)):
        np.testing.assert_array_equal(st, g[:2])
        np.testing.assert_array_equal(r, g)


def test_direct_run_chunked_signature_is_the_references():
    assert _params(tdv.DirectVOChunked) == _params(jdv.DirectVOChunked)
    bound = inspect.signature(tdv.DirectVOChunked.run_chunked).bind(
        "self", "images", "clouds", "masks", 8, True)
    assert bound.arguments["chunk"] == 8 and bound.arguments["progress"] is True


@pytest.mark.parametrize("kw", [dict(checkpoint_path="x.npz", checkpoint_every=8),
                                dict(checkpoint_path="x.npz"), dict(resume=True),
                                dict(stop_after=1)])
def test_direct_checkpoint_arguments_raise_naming_a7(kw, tmp_path, frames):
    """The checkpoint arguments of ``DirectVOChunked.run_chunked`` act as the
    reference's on six frames in chunks of two: every 8 frames and never
    (``checkpoint_every=0``) write no snapshot in a run this short,
    ``resume`` continues from a snapshot the JAX package wrote after frame 2,
    and ``stop_after=1`` stops at the first boundary past it (frame 2 done).
    Positions and quaternions within 5e-4 of the JAX package's (BA off, as
    tests/test_torch_direct.py's chunk)."""
    jcf = jcfg.VisualConfig(pyramid_levels=3, keyframe_window=3)
    tcf = tcfg.VisualConfig(pyramid_levels=3, keyframe_window=3)
    args = ([f[0] for f in frames], [f[1] for f in frames], [f[2] for f in frames])
    jvo = jdv.DirectVOChunked(jax_cam(), jcf, point_cap=DIRECT_CAP, run_window_ba=False)
    tvo = tdv.DirectVOChunked(port_cam(), tcf, point_cap=DIRECT_CAP, run_window_ba=False,
                              device="cpu")
    kws = {}
    for side in ("jax", "port"):
        kws[side] = dict(kw)
        if "checkpoint_path" in kw:
            kws[side]["checkpoint_path"] = str(tmp_path / f"{side}.npz")
    if kw.get("resume"):
        start = str(tmp_path / "start.npz")
        jvo.run_chunked(*args, chunk=2, checkpoint_path=start, checkpoint_every=2, stop_after=2)
        for side in kws:
            kws[side]["checkpoint_path"] = start
    want_t, want_q, _ = jvo.run_chunked(*args, chunk=2, **kws["jax"])
    got_t, got_q, wall = tvo.run_chunked(*args, chunk=2, **kws["port"])
    n = 3 if kw.get("stop_after") else 6
    assert got_t.shape == want_t.shape == (n, 3) and got_q.shape == (n, 4) and wall > 0
    np.testing.assert_allclose(got_t, want_t, atol=5e-4)
    np.testing.assert_allclose(got_q, want_q, atol=5e-4)
    if "checkpoint_path" in kw:
        assert not (tmp_path / "jax.npz").exists() and not (tmp_path / "port.npz").exists()


@pytest.mark.parametrize("kw, ingest", [({}, "float"), (dict(quantize=True), "uint16"),
                                        (dict(ingest="float"), "float"),
                                        (dict(ingest="uint16", quantize=True), "uint16")])
def test_odometry_unported_ingests_raise_naming_a7(scans, kw, ingest):
    """``ingest=None`` means "uint16" with ``quantize`` and "float" without, as
    in the reference, and an explicit ``ingest`` wins over ``quantize``: each
    call equals the port's call with the ingest named bit for bit, and the
    JAX package's same call within tests/test_torch_odometry.py's 2e-4 m and
    1e-5."""
    got = tpipe.OdometryPipeline(_small(tcfg, "odometry"), capacity=CAPACITY,
                                 device="cpu").run_chunked(scans, **kw)
    named = tpipe.OdometryPipeline(_small(tcfg, "odometry"), capacity=CAPACITY,
                                   device="cpu").run_chunked(scans, ingest=ingest)
    want = jpipe.OdometryPipeline(_small(jcfg, "odometry"), capacity=CAPACITY).run_chunked(
        scans, **kw)
    np.testing.assert_array_equal(got.positions, named.positions)
    np.testing.assert_array_equal(got.quaternions, named.quaternions)
    np.testing.assert_allclose(got.positions, want.positions, atol=2e-4)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=1e-5)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_third_positional_argument_is_progress(name):
    port = PAIRS[name][0]
    args = ("self", "scans") + (("images",) if name == "camlidar" else ())
    bound = inspect.signature(port.run_chunked).bind(*args, 8, True)
    assert bound.arguments["chunk"] == 8
    assert bound.arguments["progress"] is True


def test_progress_prints_the_frame_rate(scans, capsys):
    cfg = tcfg.SystemConfig(lidar=tcfg.LidarConfig(azimuth_bins=1024),
                            odometry=tcfg.OdometryConfig(outer_iters=2))
    res = tpipe.OdometryPipeline(cfg, device="cpu").run_chunked(scans, 2, True, ingest="polar2")
    assert res.positions.shape == (3, 3)
    assert "3 frames (2 computed)" in capsys.readouterr().out
    tpipe.OdometryPipeline(cfg, device="cpu").run_chunked(scans, 2, ingest="polar2")
    assert capsys.readouterr().out == ""


# -------------------------------------------------- the tracker's routing --

@pytest.fixture(scope="module")
def pyramids():
    """Two photo-consistent 320 × 96 renders of the corridor (the camera
    0.4 m forward, turning 0.01 rad), as 3-level pyramids for both packages."""
    scene = jsyn.BoxScene.corridor(0)
    imgs = []
    for dx, yaw in ((0.0, 0.0), (0.4, 0.01)):
        R, t = jsyn.camera_from_velodyne_pose(jsyn.yaw_matrix(yaw), np.array([dx, 0.0, 1.5]))
        imgs.append(jsyn.render_image(scene, R, t, **CAM)[0])
    pyr_j = [tuple(jimg.build_pyramid(jnp.asarray(im), 3)) for im in imgs]
    pyr_t = [tuple(torch.from_numpy(np.array(p)) for p in pyr) for pyr in pyr_j]
    return pyr_j, pyr_t


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(20, 300, n), rng.uniform(15, 80, n)], -1).astype(np.float32)
    flow = rng.normal(0, 1.0, (n, 2)).astype(np.float32)
    return uv, flow


@pytest.mark.parametrize("n, to_kernel", [(20, False), (21, False), (24, True), (768, True)])
def test_levels_reach_k6_only_for_multiples_of_8(monkeypatch, pyramids, n, to_kernel):
    """Every level fits win 13, so the slot count alone decides: the TPU's
    ``uv0.shape[0] % 8 == 0``."""
    calls = []

    def recording_level(img0, img1, uv0, guess, *args, **kw):
        calls.append(uv0.shape[0])
        return guess.clone(), torch.ones(uv0.shape[0], dtype=torch.bool)

    monkeypatch.setattr(klk, "lk_level", recording_level)
    _, (p0, p1) = pyramids
    uv, flow = _features(n)
    tlk.track_pyramid(p0, p1, torch.from_numpy(uv), torch.from_numpy(flow), win=13, iters=4,
                      levels=3)
    assert calls == ([n] * 3 if to_kernel else [])


def test_slots_not_a_multiple_of_8_match_the_jax_xla_tracker(pyramids):
    """20 slots: every level takes the gather path in both packages (on the
    CPU the JAX package always does), so the port's tracker follows the JAX
    tracker as ``_track_level`` follows the JAX ``_track_level``
    (tests/test_torch_visual.py: ok flags equal, displacements to 2e-4 px)."""
    (j0, j1), (p0, p1) = pyramids
    uv, flow = _features(20, seed=1)
    act = np.ones(20, bool)
    act[::5] = False
    kw = dict(win=13, iters=6, levels=3, iters_coarse=4, eps=0.01)
    uv_j, ok_j = jlk.track_pyramid(j0, j1, jnp.asarray(uv), jnp.asarray(flow),
                                   jnp.asarray(act), **kw)
    uv_t, ok_t = tlk.track_pyramid(p0, p1, torch.from_numpy(uv), torch.from_numpy(flow),
                                   torch.from_numpy(act), **kw)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() >= 10
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=2e-4)
