"""The port's pipeline entry points against the JAX package's: the four
``run_chunked`` signatures (names, order, defaults), the reference's default
ingests and checkpoint arguments raising ``NotImplementedError`` until they
are ported, and the pyramidal tracker routing its levels as the TPU does
(kernel K6 only for slot counts that are a multiple of 8)."""

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
from lidar_visual_odometry_tpu_torch.kernels import lk as klk
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import direct_vo as tdv
from lidar_visual_odometry_tpu_torch.models import pipeline as tpipe
from lidar_visual_odometry_tpu_torch.ops import camera as tcam
from lidar_visual_odometry_tpu_torch.ops import lk as tlk
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

PAIRS = {
    "odometry": (tpipe.OdometryPipeline, jpipe.OdometryPipeline),
    "slam": (tpipe.FullPipeline, jpipe.FullPipeline),
    "camlidar": (tcl.CamLidarPipeline, jcl.CamLidarPipeline),
}
CAM = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)


def _params(cls):
    sig = inspect.signature(cls.run_chunked)
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


@pytest.fixture(scope="module")
def scans():
    seq = jsyn.SyntheticSequence(n_frames=3, width=600, noise=0.005)
    return [seq.scan(k) for k in range(3)]


def _pipe(name):
    return PAIRS[name][0](tcfg.SystemConfig(), device="cpu")


def _run(name, pipe, scans, *args, **kw):
    if name == "camlidar":
        return pipe.run_chunked(scans, [np.zeros((96, 320), np.uint8)] * len(scans), *args, **kw)
    return pipe.run_chunked(scans, *args, **kw)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_run_chunked_signature_is_the_references(name):
    port, ref = PAIRS[name]
    assert _params(port) == _params(ref)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_run_chunked_default_ingest_raises_naming_a7(name, scans):
    pipe = _pipe(name)
    with pytest.raises(NotImplementedError, match="A.7"):
        _run(name, pipe, scans)
    for kw in (dict(checkpoint_path="x.npz", checkpoint_every=8), dict(resume=True),
               dict(stop_after=1)):
        with pytest.raises(NotImplementedError, match="A.7"):
            _run(name, pipe, scans, ingest="polar2", **kw)


def test_direct_run_chunked_signature_is_the_references():
    assert _params(tdv.DirectVOChunked) == _params(jdv.DirectVOChunked)
    bound = inspect.signature(tdv.DirectVOChunked.run_chunked).bind(
        "self", "images", "clouds", "masks", 8, True)
    assert bound.arguments["chunk"] == 8 and bound.arguments["progress"] is True


@pytest.mark.parametrize("kw", [dict(checkpoint_path="x.npz", checkpoint_every=8),
                                dict(checkpoint_path="x.npz"), dict(resume=True),
                                dict(stop_after=1)])
def test_direct_checkpoint_arguments_raise_naming_a7(kw):
    cam = tcam.Pinhole(120.0, 120.0, 160.0, 48.0, 320, 96, torch.zeros(5))
    vo = tdv.DirectVOChunked(cam, tcfg.VisualConfig(), device="cpu")
    n = 2
    with pytest.raises(NotImplementedError, match="A.7"):
        vo.run_chunked([np.zeros((96, 320), np.uint8)] * n, [np.zeros((16, 3), np.float32)] * n,
                       [np.zeros(16, bool)] * n, **kw)


@pytest.mark.parametrize("kw, ingest", [({}, "float"), (dict(quantize=True), "uint16"),
                                        (dict(ingest="float"), "float"),
                                        (dict(ingest="uint16", quantize=True), "uint16")])
def test_odometry_unported_ingests_raise_naming_a7(scans, kw, ingest):
    """``ingest=None`` means "uint16" with ``quantize`` and "float" without, as
    in the reference; both are A.7's."""
    with pytest.raises(NotImplementedError, match=rf"ingest='{ingest}'.*A\.7"):
        _pipe("odometry").run_chunked(scans, **kw)


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
