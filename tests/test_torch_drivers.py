"""The port's per-frame lidar drivers and default ingests against the JAX
package on the CPU: ``quantize_scan``, the float and uint16 chunk programs,
``LidarOdometry`` / ``OdometryPipeline.run``, ``DeviceMapping`` and the
uint16 fused SLAM chunk, the host cube map (``CubeMap``, ``mapping_step``,
``LidarMapping``) through ``FullPipeline.run``, and ``data/sync.py``.

The scans are the 5-frame corridor of ``tests/test_torch_mapping.py`` (600
azimuth steps, 1024 bins, capacity 65536), the mapping configuration its
``SMALL`` one. The host cube map keeps the default local caps (16384 and
32768 points, whole 512-point chunks), which five frames do not fill: above
a cap the reference's every-k-th subsample of the gathered cubes shifts
wholesale when one point more or less lands in an earlier cube, so two runs
whose odometry differs by float32 rounding gather different submaps (on the
card against the CPU, 4.6 cm apart by frame 4 at caps of 2048 and 4096)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import sync as jsync
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import lidar_mapping as jlm
from lidar_visual_odometry_tpu.models import lidar_odometry as jlo
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.models.pipeline import FullPipeline as JaxFullPipeline
from lidar_visual_odometry_tpu.models.pipeline import OdometryPipeline as JaxPipeline
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.data import sync as tsync
from lidar_visual_odometry_tpu_torch.models import lidar_mapping as lm
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
from lidar_visual_odometry_tpu_torch.ops import se3
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

torch.set_num_threads(4)

CAPACITY = 65536
N_FRAMES = 5
MAPPING = dict(outer_iters=2, gn_iters=4, corner_slot=1024, surf_slot=1024,
               map_corner_cap=2048, map_surf_cap=2048)
# as tests/test_torch_odometry.py's chunked pipeline: frame 0 enters through
# build_compact_scan (ring 0 on the field-of-view gate, atan2 ulps), and the
# association and solve differ in float32 rounding
ODOM_TOL_M, ODOM_TOL_Q = 2e-4, 1e-5
# as tests/test_torch_mapping.py's fused SLAM: the same neighbours, but the
# reference's plane fits are ill-conditioned tens of metres out, a few mm
MAP_TOL_M, MAP_TOL_Q = 1e-2, 1e-3


def _configs(skip=1):
    def make(m):
        return m.SystemConfig(lidar=m.LidarConfig(azimuth_bins=1024),
                              odometry=m.OdometryConfig(outer_iters=4, skip_frame_num=skip),
                              mapping=m.MappingConfig(**MAPPING))
    return make(jcfg), make(tcfg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fc_to_torch(fc):
    return F.FeatureCloud(*(_t(x) for x in fc))


@pytest.fixture(scope="module")
def corridor():
    seq = jsyn.SyntheticSequence(n_frames=N_FRAMES, width=600, noise=0.005)
    return seq, [seq.scan(k) for k in range(N_FRAMES)]


# ------------------------------------------------------------------ ingests --

def test_quantize_scan_is_the_references(rng):
    """Bit for bit up to the count: points beyond ±128 m clamp, more points
    than the capacity are cut (the rows past the count are unset on both
    sides, and masked by the decode)."""
    pts = rng.normal(scale=60.0, size=(700, 4)).astype(np.float32)
    pts[:5, 0] = [-200.0, 200.0, -128.0, 127.99, 0.0]
    for cap in (1024, 512):
        want_q, want_n = jlo.quantize_scan(pts, cap)
        got_q, got_n = lo.quantize_scan(pts, cap)
        assert got_q.shape == (cap, 3) and got_q.dtype == np.uint16 and got_n.dtype == np.int32
        assert int(got_n) == int(want_n) == min(700, cap)
        np.testing.assert_array_equal(got_q[:got_n], want_q[:want_n])
    # the device decode is the reference's, and reads the int16 upload alike
    want_q = want_q[:want_n]
    q = _t(want_q.view(np.int16))
    want = np.asarray(jnp.asarray(want_q).astype(jnp.float32) * jlo.QUANT_SCALE
                      + jlo.QUANT_OFFSET)
    np.testing.assert_array_equal(lo.dequantize(q).numpy(), want)
    np.testing.assert_array_equal(lo.dequantize(_t(want_q)).numpy(), want)


@pytest.fixture(scope="module")
def chunk_inputs(corridor):
    """Frame 0's JAX odometry state (carried to the port through the
    checkpoint's keys) and frames 1-3 padded and quantised."""
    _, scans = corridor
    cfg_j, _ = _configs()
    xyz0, mask0 = jpc.pad_points(scans[0][:, :3], CAPACITY)
    state_j = jlo.init_state(jsr.register_scan(jnp.asarray(xyz0), jnp.asarray(mask0),
                                               cfg_j.lidar).features)
    padded = [jpc.pad_points(s[:, :3], CAPACITY) for s in scans[1:4]]
    quant = [jlo.quantize_scan(s, CAPACITY) for s in scans[1:4]]
    return dict(
        state_j=state_j,
        state_t=lo.odometry_state_from_numpy(lo.odometry_state_to_numpy(_state_torch(state_j)),
                                             device="cpu"),
        xyz=np.stack([p for p, _ in padded]), mask=np.stack([m for _, m in padded]),
        q=np.stack([q for q, _ in quant]), n=np.stack([n for _, n in quant]))


def _state_torch(state_j):
    return lo.OdometryState(se3.Pose(_t(state_j.pose_w.q), _t(state_j.pose_w.t)),
                            se3.Pose(_t(state_j.pose_rel.q), _t(state_j.pose_rel.t)),
                            _fc_to_torch(state_j.prev_less_sharp),
                            _fc_to_torch(state_j.prev_less_flat))


@pytest.mark.parametrize("ingest", ["float", "uint16"])
def test_odometry_chunks_match_jax(chunk_inputs, ingest):
    """``odometry_chunk`` and ``odometry_chunk_quantized`` over three frames
    from the same carried state; the quantised decode masks the codes
    beyond each frame's count."""
    c = chunk_inputs
    cfg_j, cfg_t = _configs()
    if ingest == "float":
        st_j, want = jlo.odometry_chunk(c["state_j"], jnp.asarray(c["xyz"]),
                                        jnp.asarray(c["mask"]), cfg_j.lidar, cfg_j.odometry)
        st_t, got = lo.odometry_chunk(c["state_t"], _t(c["xyz"]), _t(c["mask"]), cfg_t.lidar,
                                      cfg_t.odometry)
    else:
        st_j, want = jlo.odometry_chunk_quantized(c["state_j"], jnp.asarray(c["q"]),
                                                  jnp.asarray(c["n"]), cfg_j.lidar,
                                                  cfg_j.odometry)
        st_t, got = lo.odometry_chunk_quantized(c["state_t"], _t(c["q"].view(np.int16)),
                                                _t(c["n"]), cfg_t.lidar, cfg_t.odometry)
    assert got.t.shape == (3, 3) and got.q.shape == (3, 4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=ODOM_TOL_M)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=ODOM_TOL_Q)
    np.testing.assert_array_equal(st_t.prev_less_flat.mask.numpy(),
                                  np.asarray(st_j.prev_less_flat.mask))


@pytest.fixture(scope="module")
def odometry_runs(corridor):
    """The per-frame and the default chunked runs on both sides."""
    _, scans = corridor
    cfg_j, cfg_t = _configs()
    kernels.reset_launch_counts()
    return dict(
        run_j=JaxPipeline(cfg_j, capacity=CAPACITY).run(scans),
        float_j=JaxPipeline(cfg_j, capacity=CAPACITY).run_chunked(scans, chunk=2),
        run_t=OdometryPipeline(cfg_t, capacity=CAPACITY, device="cpu").run(scans),
        float_t=OdometryPipeline(cfg_t, capacity=CAPACITY, device="cpu").run_chunked(
            scans, chunk=2),
        uint16_t=OdometryPipeline(cfg_t, capacity=CAPACITY, device="cpu").run_chunked(
            scans, chunk=2, quantize=True))


def test_odometry_pipeline_run_matches_jax(odometry_runs):
    """``OdometryPipeline.run`` (``process_scan`` → ``LidarOdometry``)
    against the JAX package's, frame 0 at the identity."""
    r = odometry_runs
    got, want = r["run_t"], r["run_j"]
    assert got.positions.shape == (N_FRAMES, 3) and len(got.per_frame_s) == N_FRAMES
    np.testing.assert_array_equal(got.positions[0], 0.0)
    np.testing.assert_allclose(got.positions, want.positions, atol=ODOM_TOL_M)
    np.testing.assert_allclose(got.quaternions, want.quaternions, atol=ODOM_TOL_Q)
    np.testing.assert_allclose(r["float_t"].positions, r["float_j"].positions, atol=ODOM_TOL_M)


def test_per_frame_run_is_the_float_chunk_bit_for_bit(odometry_runs):
    """The per-frame driver and the float chunk run the same operations on
    the same points: the same bits. The uint16 run sees the points moved by
    up to 2 mm and lands within a few mm."""
    r = odometry_runs
    np.testing.assert_array_equal(r["run_t"].positions, r["float_t"].positions)
    np.testing.assert_array_equal(r["run_t"].quaternions, r["float_t"].quaternions)
    assert 0 < np.abs(r["uint16_t"].positions - r["float_t"].positions).max() < 1e-2


def test_lidar_odometry_process_warm_start(corridor):
    """``LidarOdometry.process``: the first frame seeds the state at the
    identity; ``init_rel`` replaces the constant-velocity warm start, as the
    reference's does."""
    _, scans = corridor
    cfg_j, cfg_t = _configs()
    geom = dict(n_scans=64, width=1024, min_range=0.1, max_range=120.0)
    feats_j = [jsr.register_polar(jnp.asarray(jpc.pack_polar_scan(s, channels=1, **geom)),
                                  cfg_j.lidar).features for s in scans[:3]]
    od_j, od_t = jlo.LidarOdometry(cfg_j.odometry), lo.LidarOdometry(cfg_t.odometry)
    prior = (np.array([0.99999, 0.0, 0.0, 0.0045], np.float32),
             np.array([0.9, 0.0, 0.0], np.float32))
    for k, f in enumerate(feats_j):
        init_j = jse3.Pose(*map(jnp.asarray, prior)) if k == 2 else None
        init_t = se3.Pose(*map(_t, prior)) if k == 2 else None
        wj, rj = od_j.process(f, init_j)
        wt, rt = od_t.process(F.ScanFeatures(*(_fc_to_torch(fc) for fc in f)), init_t)
        np.testing.assert_allclose(wt.t.numpy(), np.asarray(wj.t), atol=ODOM_TOL_M)
        np.testing.assert_allclose(rt.q.numpy(), np.asarray(rj.q), atol=ODOM_TOL_Q)
        if k == 0:
            np.testing.assert_array_equal(wt.q.numpy(), [1.0, 0.0, 0.0, 0.0])


# ------------------------------------------------------------------ mapping --

def test_slam_chunk_quantized_matches_jax(corridor):
    """``FullPipeline.run_chunked`` with its default uint16 ingest
    (``slam_chunk_quantized``): odometry and mapped poses."""
    _, scans = corridor
    cfg_j, cfg_t = _configs()
    odo_j, map_j = JaxFullPipeline(cfg_j, capacity=CAPACITY).run_chunked(scans, chunk=2,
                                                                         map_skip=1)
    kernels.reset_launch_counts()
    odo_t, map_t = FullPipeline(cfg_t, capacity=CAPACITY, device="cpu").run_chunked(
        scans, chunk=2, map_skip=1)
    assert kernels.launch_counts()["segment_sum"] == 0   # CPU tensors run the plain versions
    np.testing.assert_allclose(odo_t.positions, odo_j.positions, atol=ODOM_TOL_M)
    np.testing.assert_allclose(map_t.positions, map_j.positions, atol=MAP_TOL_M)
    np.testing.assert_allclose(map_t.quaternions, map_j.quaternions, atol=MAP_TOL_Q)
    odo_u = OdometryPipeline(cfg_t, capacity=CAPACITY, device="cpu").run_chunked(
        scans, chunk=2, quantize=True)
    np.testing.assert_array_equal(odo_t.positions, odo_u.positions)


@pytest.mark.parametrize("device_map, skip", [(True, 1), (True, 2), (False, 1), (False, 2)])
def test_full_pipeline_run_matches_jax(corridor, odometry_runs, device_map, skip):
    """``FullPipeline.run``: ``DeviceMapping.process`` with ``skip`` 1 and 2
    (frames between mapped ones compose the correction) and the host cube
    map (``LidarMapping``: ``CubeMap`` + ``mapping_step``), against the JAX
    package's. The port's host map searches with K4's cell window, the
    reference's on the CPU with the dense ``knn.knn`` (near ties reorder)."""
    seq, scans = corridor
    cfg_j, cfg_t = _configs(skip)
    odo_j, map_j = JaxFullPipeline(cfg_j, capacity=CAPACITY, device_map=device_map).run(scans)
    odo_t, map_t = FullPipeline(cfg_t, capacity=CAPACITY, device_map=device_map,
                                device="cpu").run(scans)
    np.testing.assert_allclose(odo_t.positions, odo_j.positions, atol=ODOM_TOL_M)
    np.testing.assert_allclose(map_t.positions, map_j.positions, atol=MAP_TOL_M)
    np.testing.assert_allclose(map_t.quaternions, map_j.quaternions, atol=MAP_TOL_Q)
    if skip == 1:
        np.testing.assert_array_equal(odo_t.positions, odometry_runs["run_t"].positions)
        gt = np.stack([seq.pose(k)[1] - seq.pose(0)[1] for k in range(N_FRAMES)])
        assert np.max(np.abs(map_t.positions - gt)) < 0.05
    else:   # frame 1 composes frame 0's correction: the identity
        np.testing.assert_array_equal(map_t.positions[1], odo_t.positions[1])


def test_cube_map_is_the_references(rng):
    """``CubeMap.insert`` (per-cube voxel filter) and ``gather_local`` (the
    neighbourhood, the every-k-th cut above the cap) are numpy on both
    sides: the same bits."""
    pts = [(rng.normal(size=(4000, 3)) * [80.0, 60.0, 8.0]).astype(np.float32) for _ in range(2)]
    jm, tm = jlm.CubeMap(50.0, 0.4), lm.CubeMap(50.0, 0.4, device="cpu")
    for batch in pts:
        jm.insert(batch)
        tm.insert(batch)
    assert sorted(jm.cubes) == sorted(tm.cubes) and len(tm.cubes) > 10
    for k in jm.cubes:
        np.testing.assert_array_equal(tm.cubes[k], jm.cubes[k])
    for center, cap in (((10.0, -20.0, 1.0), 2048), ((60.0, 0.0, 0.0), 8192),
                        ((500.0, 0.0, 0.0), 512)):
        want = jm.gather_local(np.asarray(center, np.float32), (2, 2, 1), cap)
        got = tm.gather_local(np.asarray(center, np.float32), (2, 2, 1), cap)
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_mapping_step_matches_jax(corridor):
    """One ``mapping_step`` against a host cube map of frames 0 and 1 at
    their true poses, frame 2 starting 5 cm off, both packages given the same
    submap. Gathered with caps of 2048 and 4096, the corners (4007 points)
    are cut to every second one, and the solve is ill-conditioned in roll
    and height: the reference's own
    jitted and eager runs of this step lie 9.6e-5 apart in q and 5.5 mm in
    t (measured on the CPU), the port 1.4e-4 and 3.9 mm from the jitted one.
    Held to ``tests/test_torch_mapping.py``'s fused-SLAM tolerance, 1e-2 m
    and 1e-3."""
    seq, scans = corridor
    cfg_j, cfg_t = _configs()
    geom = dict(n_scans=64, width=1024, min_range=0.1, max_range=120.0)
    feats = [jsr.register_polar(jnp.asarray(jpc.pack_polar_scan(s, channels=1, **geom)),
                                cfg_j.lidar).features for s in scans[:3]]
    corner, surf = jlm.CubeMap(50.0, 0.4), jlm.CubeMap(50.0, 0.8)
    for k in range(2):
        R, t = seq.pose(k)
        t = t - seq.pose(0)[1]
        for store, fc in ((corner, feats[k].less_sharp), (surf, feats[k].less_flat)):
            xyz = np.asarray(fc.xyz)[np.asarray(fc.mask)]
            store.insert((xyz @ R.T + t).astype(np.float32))
    R2, t2 = seq.pose(2)
    yaw = np.arctan2(R2[1, 0], R2[0, 0])
    q = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32)
    t = (t2 - seq.pose(0)[1] + [0.05, -0.03, 0.02]).astype(np.float32)
    center = t.astype(np.float32)
    mc = cfg_j.mapping
    local_j = jlm.LocalMap(corner.gather_local(center, mc.submap_radius, 2048),
                           surf.gather_local(center, mc.submap_radius, 4096))
    local_t = lm.LocalMap(*(pc.PointBatch(_t(b.xyz), _t(b.mask)) for b in local_j))
    f = feats[2]
    want = jlm.mapping_step(f.less_sharp.xyz, f.less_sharp.mask, f.less_flat.xyz,
                            f.less_flat.mask, local_j, jse3.Pose(jnp.asarray(q), jnp.asarray(t)),
                            mc)
    ls, lfl = _fc_to_torch(f.less_sharp), _fc_to_torch(f.less_flat)
    got = lm.mapping_step(ls.xyz, ls.mask, lfl.xyz, lfl.mask, local_t, se3.Pose(_t(q), _t(t)),
                          cfg_t.mapping)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=MAP_TOL_M)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=MAP_TOL_Q)
    # the solve moved the 5 cm offset back towards the truth
    assert np.abs(got.t.numpy() - (t2 - seq.pose(0)[1])).max() < 0.02


def test_full_pipeline_ingests_and_device_map_rules(corridor):
    """The JAX package runs any ingest that is not polar as uint16 in
    ``FullPipeline.run_chunked``; the port raises for "float" (a decided
    difference, ROADMAP §C), and ``run_chunked`` needs the device map."""
    _, scans = corridor
    _, cfg_t = _configs()
    with pytest.raises(ValueError, match="ingest"):
        FullPipeline(cfg_t, device="cpu").run_chunked(scans, ingest="float")
    with pytest.raises(ValueError, match="device_map"):
        FullPipeline(cfg_t, device_map=False, device="cpu").run_chunked(scans)


# --------------------------------------------------------------------- sync --

def test_sync_is_the_references(rng):
    """``match_nearest``, ``bundle_imu`` and ``derotate_cloud`` on random
    stamps and orientations: numpy on both sides, exact."""
    lidar = np.sort(rng.uniform(0, 10, 60))
    images = np.sort(rng.uniform(0, 10, 45))
    imu = np.sort(rng.uniform(-1, 11, 900))
    for tol in (0.05, 0.227):
        np.testing.assert_array_equal(tsync.match_nearest(lidar, images, tol),
                                      jsync.match_nearest(lidar, images, tol))
    np.testing.assert_array_equal(tsync.match_nearest(lidar, images),
                                  jsync.match_nearest(lidar, images))
    for a, b in zip(tsync.bundle_imu(lidar, imu), jsync.bundle_imu(lidar, imu), strict=True):
        np.testing.assert_array_equal(a, b)
    pts = rng.normal(size=(100, 3))
    for _ in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(tsync.derotate_cloud(pts, q), jsync.derotate_cloud(pts, q))
