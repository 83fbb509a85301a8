"""The port's visual frontend and cam-lidar pipeline against the JAX package on
the CPU: depth association, triangulation, the pose solve with host-checked
exits, replenishment, one frame step, a three-frame visual chunk and the
four-frame ``CamLidarPipeline.run_chunked``. The JAX tracker's levels run on
the Pallas ``lk_level`` in interpret mode (the TPU's semantics, which the
port's kernel K6 reproduces), not on the CPU's XLA gather path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.data.native_pack import pack_polar_chunk as jpack
from lidar_visual_odometry_tpu.models import cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.models import visual_frontend as jvf
from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.utils import checkpoint as jckpt
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as tcl
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline
from lidar_visual_odometry_tpu_torch.ops import camera as tcam
from lidar_visual_odometry_tpu_torch.ops import knn as tknn
from lidar_visual_odometry_tpu_torch.ops import pointcloud as tpc
from lidar_visual_odometry_tpu_torch.ops import se3
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_visual import lk_through_pallas_interpret

torch.set_num_threads(2)

N_FRAMES = 4
CAM = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)
R_SC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
EXT = tuple(tuple(float(v) for v in row) + (0.0,) for row in R_SC.T)
VIS = dict(depth_cloud_cap=4096, lk_window=9, lk_levels=3, lk_reverse_levels=1,
           lk_iters_coarse=4, max_tracked=128, grid_rows=4, grid_cols=6)


def _config(m):
    """The bench's cam-lidar configuration (``bench.py:_config``) cut to a
    320 × 96 camera, 1024 azimuth bins and a 128-slot feature table."""
    return m.SystemConfig(
        lidar=m.LidarConfig(azimuth_bins=1024),
        camera=m.CameraConfig(**{k: CAM[k] for k in ("fx", "fy", "cx", "cy", "width", "height")}),
        visual=m.VisualConfig(**VIS),
        extrinsic=m.ExtrinsicConfig(matrix=EXT),
    )


def _to_torch(x):
    if hasattr(x, "_fields"):
        return type(x)(*(_to_torch(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_to_torch(v) for v in x)
    return torch.from_numpy(np.array(x))


def _state_to_torch(js):
    return vf.VisualChunkState(
        vf.FeatureTable(*_to_torch(tuple(js.table))), se3.Pose(*_to_torch(tuple(js.pose_w))),
        se3.Pose(*_to_torch(tuple(js.warm_rel))), _to_torch(tuple(js.prev_pyr)),
        vf.DepthCloud(*_to_torch(tuple(js.prev_dc))))


@pytest.fixture(scope="module")
def seq_data():
    seq = jsyn.SyntheticSequence(n_frames=N_FRAMES, width=600, speed=1.0, yaw_rate=0.004,
                                 noise=0.01)
    scans = [seq.scan(k) for k in range(N_FRAMES)]
    images = [jsyn.render_image(seq.scene, *jsyn.camera_from_velodyne_pose(*seq.pose(k)),
                                **CAM)[0] for k in range(N_FRAMES)]
    return seq, scans, images


@pytest.fixture(scope="module")
def jax_runs(seq_data):
    """Every JAX-side run of this file, in one interpret-mode routing: the
    frame-0 state, one frame step, a three-frame visual chunk and the whole
    pipeline, with the inputs they were given."""
    _, scans, images = seq_data
    cfg = _config(jcfg)
    vcfg, lcfg = cfg.visual, cfg.lidar
    E = np.asarray(cfg.extrinsic.matrix, np.float32)
    R_cl, t_cl = E[:, :3], np.ascontiguousarray(E[:, 3])
    cam = jcam.Pinhole.from_config(cfg.camera)
    cx0, cm0 = jcl.camera_cloud_select(scans[0][:, :3], R_cl, t_cl, vcfg.depth_cloud_cap)
    packed = jpack([s[:, :3] for s in scans[1:]], n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
                   min_range=lcfg.min_range, max_range=lcfg.max_range,
                   n_frames=N_FRAMES - 1, channels=1)
    imgs8 = np.stack([np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8) for im in images[1:]])
    with lk_through_pallas_interpret():
        state0 = jvf.init_chunk_state(jnp.asarray(images[0]), jnp.asarray(cx0), jnp.asarray(cm0),
                                      cam, vcfg)
        clouds, cmasks = jcl.cam_clouds_from_polar(jnp.asarray(packed), jnp.asarray(R_cl),
                                                   jnp.asarray(t_cl), lcfg, vcfg.depth_cloud_cap)
        step = jax.jit(jvf.chunk_frame_step, static_argnames=("cfg",))(
            state0, jnp.asarray(imgs8[0]), clouds[0], cmasks[0], cam, vcfg)
        chunk = jvf.visual_chunk(state0, jnp.asarray(imgs8), clouds, cmasks, cam, vcfg)
        pipe = jcl.CamLidarPipeline(cfg).run_chunked(scans, images, chunk=N_FRAMES - 1,
                                                     ingest="polar2")
    return dict(cfg=cfg, cx0=cx0, cm0=cm0, packed=packed, imgs8=imgs8, state0=state0,
                clouds=np.array(clouds), cmasks=np.array(cmasks), step=step, chunk=chunk,
                pipe=pipe)


@pytest.fixture(scope="module")
def port_cfg():
    cfg = _config(tcfg)
    return cfg, tcam.Pinhole.from_config(cfg.camera, device="cpu")


# ------------------------------------------------------------ depth, poses --

def _depth_float64(un, dc):
    """``associate_depth``'s clamped ray/plane depth from the same float32
    neighbour coordinates, its determinant sums taken in float64."""
    q = torch.cat([10.0 * un, torch.full_like(un[:, :1], 10.0)], dim=-1)
    idx, _ = tknn.knn(q, dc.plane10, dc.mask, 3)
    z32, p10 = dc.z[idx], dc.plane10[idx]
    x1, x2, x3 = (p10[..., 0] * z32 * np.float32(0.1)).double().unbind(1)
    y1, y2, y3 = (p10[..., 1] * z32 * np.float32(0.1)).double().unbind(1)
    z = z32.double()
    z1, z2, z3 = z.unbind(1)
    u, v = un[:, 0].double(), un[:, 1].double()
    num = x1 * y2 * z3 - x1 * y3 * z2 - x2 * y1 * z3 + x2 * y3 * z1 + x3 * y1 * z2 - x3 * y2 * z1
    den = (x1 * y2 - x2 * y1 - x1 * y3 + x3 * y1 + x2 * y3 - x3 * y2
           + u * y1 * z2 - u * y2 * z1 - v * x1 * z2 + v * x2 * z1
           - u * y1 * z3 + u * y3 * z1 + v * x1 * z3 - v * x3 * z1
           + u * y2 * z3 - u * y3 * z2 - v * x2 * z3 + v * x3 * z2)
    s = num / den
    zmin, zmax = z.min(-1).values, z.max(-1).values
    s = torch.where(s - zmax > 0.2, zmax, s)
    return torch.where(s - zmin < -0.2, zmin, s)


def test_depth_cloud_and_association_match_jax(rng, seq_data, jax_runs, port_cfg):
    """The 10-plane cloud exactly, the gates exactly, and the ray/plane
    depth as accurate as the reference's: its determinant sums cancel
    heavily on thin triangles, the reference's compiler fuses them into
    multiply-adds and the port sums them as written, so each is held to the
    float64 evaluation of the same sums (mean and largest relative error
    within twice the reference's)."""
    cfg, _ = port_cfg
    jdc = jvf.build_depth_cloud(jnp.asarray(jax_runs["cx0"]), jnp.asarray(jax_runs["cm0"]))
    tdc = vf.build_depth_cloud(torch.from_numpy(jax_runs["cx0"]),
                               torch.from_numpy(jax_runs["cm0"]))
    for a, b in zip(jdc, tdc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    un = np.stack([rng.uniform(-1.3, 1.3, 200), rng.uniform(-0.4, 0.4, 200)], -1)
    un = un.astype(np.float32)
    act = rng.uniform(size=200) > 0.1
    d_j, ok_j = jax.jit(jvf.associate_depth)(jnp.asarray(un), jnp.asarray(act), jdc)
    d_t, ok_t = vf.associate_depth(torch.from_numpy(un), torch.from_numpy(act), tdc)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = ok_t.numpy()
    assert ok.sum() > 50
    want = _depth_float64(torch.from_numpy(un), tdc).numpy()[ok]
    err_t = np.abs(d_t.numpy()[ok] - want) / want
    err_j = np.abs(np.asarray(d_j)[ok] - want) / want
    assert err_t.mean() <= 2 * err_j.mean() and err_t.max() <= 2 * err_j.max(), (
        err_t.mean(), err_j.mean(), err_t.max(), err_j.max())


def test_triangulate_matches_jax(rng):
    """Same gates; depths to 2e-3 relative: the normal equations' determinant
    a00·a11 + a10² cancels for near-parallel rays, and the reference's
    compiler fuses multiply-adds there that the port rounds separately
    (7e-4 at most on these pairs)."""
    n = 300
    un0 = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    start = (un0 + rng.normal(0, 0.05, (n, 2))).astype(np.float32)
    xi = np.concatenate([rng.normal(0, 1.0, (n, 3)), rng.normal(0, 0.02, (n, 3))], 1)
    T_j = jax.vmap(jse3.se3_exp)(jnp.asarray(xi.astype(np.float32)))
    d_j, ok_j = jax.jit(jvf.triangulate)(jnp.asarray(un0), jnp.asarray(start), T_j)
    d_t, ok_t = vf.triangulate(torch.from_numpy(un0), torch.from_numpy(start),
                               se3.Pose(*_to_torch(tuple(T_j))))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() > 50
    np.testing.assert_allclose(d_t.numpy()[ok_t.numpy()], np.asarray(d_j)[ok_t.numpy()],
                               rtol=2e-3)


def _solve_inputs(rng, n=200):
    """Features of a known relative motion, half with (noisy) depth."""
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(4, 30, n)], -1)
    rel = jse3.se3_exp(jnp.asarray([0.02, -0.01, -0.9, 0.002, 0.015, -0.001], jnp.float32))
    p1 = np.asarray(jse3.se3_apply(rel, jnp.asarray(pts.astype(np.float32))))
    un0 = (pts[:, :2] / pts[:, 2:]).astype(np.float32)
    un1 = (p1[:, :2] / p1[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    depth = (pts[:, 2] * (1 + rng.normal(0, 0.01, n))).astype(np.float32)
    has_depth = rng.uniform(size=n) > 0.5
    epi_ok = ~has_depth
    return un0, un1, depth, has_depth, epi_ok


@pytest.mark.parametrize("gn_tol", [1e-5, 0.0])
def test_solve_pose_matches_jax_while_loop(rng, gn_tol):
    """The host-checked exit gives the JAX while_loop's pose: with the
    default tolerance it stops early, with 0 it runs all 150 iterations
    (through the staged gates at 25 and 70)."""
    ins = _solve_inputs(rng)
    vj = jcfg.VisualConfig(gn_tol=gn_tol)
    vt = tcfg.VisualConfig(gn_tol=gn_tol)
    warm = jse3.identity_pose()
    p_j = jax.jit(jvf.solve_pose, static_argnames=("cfg", "reduce_fn"))(
        warm, *(jnp.asarray(x) for x in ins), cfg=vj)
    vf.reset_stats()
    p_t = vf.solve_pose(se3.identity_pose("cpu"), *(torch.from_numpy(x) for x in ins), vt)
    its = int(vf.stats["solve_iterations"])
    assert (its == 150) if gn_tol == 0.0 else (5 < its < 100), its
    np.testing.assert_allclose(p_t.t.numpy(), np.asarray(p_j.t), atol=2e-5)
    np.testing.assert_allclose(p_t.q.numpy(), np.asarray(p_j.q), atol=2e-6)
    assert abs(float(p_t.t[2]) + 0.9) < 0.02


# ------------------------------------------------------------ the frontend --

def test_replenish_matches_jax(jax_runs, port_cfg):
    """From an empty table (frame 0) and from the tracked table after one
    step: the same candidates in the same slots."""
    cfg, cam = port_cfg
    st0 = _state_to_torch(jax_runs["state0"])
    empty = vf.empty_table(cfg.visual.max_tracked, device="cpu")
    tab = vf._replenish(empty, st0.prev_pyr[0], cam, se3.identity_pose("cpu"), cfg.visual)
    for a, b in zip(jax_runs["state0"].table, tab):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a partly filled table: replenish the JAX step's pre-replenish survivors
    jstate, jrel, _ = jax_runs["step"]
    keep = np.asarray(jstate.table.active) & (np.arange(cfg.visual.max_tracked) % 3 == 0)
    part = jstate.table._replace(active=jnp.asarray(keep))
    want = jax.jit(jvf._replenish, static_argnames=("cfg",))(
        part, jstate.prev_pyr[0], jcam.Pinhole.from_config(jax_runs["cfg"].camera),
        jstate.pose_w, jax_runs["cfg"].visual)
    got = vf._replenish(vf.FeatureTable(*_to_torch(tuple(part))), _to_torch(jstate.prev_pyr[0]),
                        cam, se3.Pose(*_to_torch(tuple(jstate.pose_w))), cfg.visual)
    for name, a, b in zip(vf.FeatureTable._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_chunk_frame_step_matches_jax(jax_runs, port_cfg):
    """One frame from the same carried state: same tracked count, relative
    rotation to 2e-6 and translation to 2e-4 m (the depth association's
    sums, which cancel heavily, round otherwise than the reference's fused
    ones: ~1e-4 m), tracked features to 2e-3 px (LK sums in another
    order)."""
    cfg, cam = port_cfg
    st0 = _state_to_torch(jax_runs["state0"])
    got = vf.chunk_frame_step(st0, torch.from_numpy(jax_runs["imgs8"][0]),
                              torch.from_numpy(jax_runs["clouds"][0]),
                              torch.from_numpy(jax_runs["cmasks"][0]), cam, cfg.visual)
    jstate, jrel, jn = jax_runs["step"]
    assert int(got[2]) == int(jn) and int(jn) > 30
    np.testing.assert_allclose(got[1].t.numpy(), np.asarray(jrel.t), atol=2e-4)
    np.testing.assert_allclose(got[1].q.numpy(), np.asarray(jrel.q), atol=2e-6)
    tracked = np.asarray(jstate.table.age) > 0
    np.testing.assert_array_equal(got[0].table.active.numpy()[tracked],
                                  np.asarray(jstate.table.active)[tracked])
    np.testing.assert_allclose(got[0].table.uv.numpy()[tracked],
                               np.asarray(jstate.table.uv)[tracked], atol=2e-3)
    # the 2×2 means to 2 ulp of their four-value sums (< 4): inside the
    # reference's fused frame program the uint8 dequantisation fuses into the
    # level-1 sums (multiply-adds) and level 2 sums pairwise
    for a, b in zip(jstate.prev_pyr, got[0].prev_pyr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2.4e-7)


def test_visual_chunk_matches_jax(jax_runs, port_cfg):
    """Three frames carried from frame 0: world poses within 5 mm / 1e-3 of
    the JAX chunk (sub-pixel LK differences move a replenished corner now
    and then, and the solve amplifies them over frames)."""
    cfg, cam = port_cfg
    st, poses = vf.visual_chunk(_state_to_torch(jax_runs["state0"]),
                                torch.from_numpy(jax_runs["imgs8"]),
                                torch.from_numpy(jax_runs["clouds"]),
                                torch.from_numpy(jax_runs["cmasks"]), cam, cfg.visual)
    jst, jposes = jax_runs["chunk"]
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(jposes.t), atol=5e-3)
    np.testing.assert_allclose(poses.q.numpy(), np.asarray(jposes.q), atol=1e-3)
    assert abs(float(poses.t[-1, 2]) - 3.0) < 0.1     # camera z = forward, 1 m a frame


def test_cam_clouds_from_polar_match_jax(jax_runs, port_cfg):
    cfg, _ = port_cfg
    E = np.asarray(cfg.extrinsic.matrix, np.float32)
    xyz, mask = tcl.cam_clouds_from_polar(
        tpc.polar_image_to_tensor(jax_runs["packed"], "cpu"), torch.from_numpy(E[:, :3]),
        torch.from_numpy(np.ascontiguousarray(E[:, 3])), cfg.lidar, cfg.visual.depth_cloud_cap)
    np.testing.assert_array_equal(mask.numpy(), jax_runs["cmasks"])
    # the 3×3 extrinsic product in another summation order
    np.testing.assert_allclose(xyz.numpy(), jax_runs["clouds"], atol=2e-5)


def test_run_chunked_matches_jax(seq_data, jax_runs, port_cfg):
    """The whole uncoupled pipeline on four frames: visual positions within
    5 mm of the JAX pipeline's, and lidar positions identical to the port's
    own ``OdometryPipeline`` (the visual half does not feed odometry)."""
    seq, scans, images = seq_data
    cfg, _ = port_cfg
    res = tcl.CamLidarPipeline(cfg, device="cpu").run_chunked(scans, images, chunk=N_FRAMES - 1,
                                                               ingest="polar2")
    want = jax_runs["pipe"]
    assert res.visual_positions.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(res.visual_positions, want.visual_positions, atol=5e-3)
    np.testing.assert_allclose(res.visual_quats, want.visual_quats, atol=1e-3)
    odo = OdometryPipeline(cfg, device="cpu").run_chunked(scans, chunk=N_FRAMES - 1,
                                                          ingest="polar2")
    np.testing.assert_array_equal(res.lidar_positions, odo.positions)
    np.testing.assert_array_equal(res.lidar_quats, odo.quaternions)
    # as tests/test_torch_odometry.py: the JAX lidar odometry to 1e-3 m
    np.testing.assert_allclose(res.lidar_positions, want.lidar_positions, atol=1e-3)


def test_visual_chunk_state_from_numpy_roundtrips_a_jax_checkpoint(tmp_path, jax_runs,
                                                                   port_cfg):
    cfg, cam = port_cfg
    jstate = jax_runs["step"][0]
    path = str(tmp_path / "vchunk.npz")
    jckpt.save_checkpoint(path, frame_idx=2, trajectory_q=np.zeros((1, 4), np.float32),
                          trajectory_t=np.zeros((1, 3), np.float32), visual_chunk=jstate)
    data = np.load(path)
    levels = int(data["vchunk_levels"])
    st = vf.visual_chunk_state_from_numpy(data, levels, device="cpu")
    want = jax.tree.leaves(jstate)
    got = [*st.table, *st.pose_w, *st.warm_rel, *st.prev_pyr, *st.prev_dc]
    assert len(got) == len(want) == 15 + levels
    for a, b in zip(want, got):
        assert b.dtype == {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32}.get(
            np.asarray(a).dtype, torch.float32)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the restored state carries on
    nxt, _, n = vf.chunk_frame_step(st, torch.from_numpy(jax_runs["imgs8"][1]),
                                    torch.from_numpy(jax_runs["clouds"][1]),
                                    torch.from_numpy(jax_runs["cmasks"][1]), cam, cfg.visual)
    assert int(n) > 30 and torch.isfinite(nxt.pose_w.t).all()


def test_unported_modes_raise(seq_data, port_cfg, monkeypatch, tmp_path):
    """The coupled and mapping modes raise, naming ROADMAP A.8. The options
    A.7 ported run (tests/test_torch_visual_drivers.py holds them to the JAX
    package): the default "uint16" ingest, whose lidar half is the uint16
    odometry chunk bit for bit; a run stopped after frame 1 with a snapshot
    and resumed, equal to the uninterrupted one bit for bit; and the
    per-frame ``run``, whose lidar half is ``OdometryPipeline.run``'s."""
    _, scans, images = seq_data
    cfg, _ = port_cfg
    pipe = tcl.CamLidarPipeline(cfg, device="cpu")
    for kw, what in ((dict(coupled=True), r"coupled.*A\.8"),
                     (dict(mapping=True), r"mapping.*A\.8")):
        with pytest.raises(NotImplementedError, match=what):
            pipe.run_chunked(scans, images, **kw)
    full = pipe.run_chunked(scans, images, chunk=2)
    odo = OdometryPipeline(cfg, device="cpu").run_chunked(scans, chunk=2, quantize=True)
    np.testing.assert_array_equal(full.lidar_positions, odo.positions)
    path = str(tmp_path / "camlidar.npz")
    stopped = pipe.run_chunked(scans, images, chunk=1, checkpoint_path=path, checkpoint_every=8,
                               stop_after=1)
    resumed = pipe.run_chunked(scans, images, chunk=1, checkpoint_path=path, resume=True)
    for name in ("lidar_positions", "lidar_quats", "visual_positions", "visual_quats"):
        np.testing.assert_array_equal(getattr(stopped, name), getattr(full, name)[:2])
        np.testing.assert_array_equal(getattr(resumed, name), getattr(full, name))
    per_frame = tcl.CamLidarPipeline(cfg, device="cpu").run(scans, images)
    np.testing.assert_array_equal(per_frame.lidar_positions,
                                  OdometryPipeline(cfg, device="cpu").run(scans).positions)
    with pytest.raises(ValueError, match="1:1"):
        pipe.run_chunked(scans, images[:2], ingest="polar2")
    with pytest.raises(ValueError, match="ingest"):
        pipe.run_chunked(scans, images, ingest="float")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.CamLidarPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vf.visual_chunk_state_from_numpy({}, 3)
