"""The port's distributed layer (``lidar_visual_odometry_tpu_torch/parallel``)
against the JAX package's sharded functions, on the CPU.

The JAX side runs on conftest's 8-device virtual mesh at
``tests/test_parallel.py``'s sizes; the port runs the same inputs on a gloo
fleet of rank processes (``parallel.launch``, rank functions in
``tests/_torch_mp_worker.py``): two ranks for all four sharded functions, four
for the odometry and the mapping, so that more than two blocks merge. The
ranks must agree within 1e-6, and each function must lie within its bound of
the JAX sharded function's result. The hooks the layer adds to the
single-device functions keep their bits when unused, and the chunked k-NN
gives the JAX package's streamed top-k.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp_worker as W
from lidar_visual_odometry_tpu.data import synthetic
from lidar_visual_odometry_tpu.models import lidar_mapping as jlm
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.models import visual_frontend as jvf
from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu.ops import image as jimage
from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.parallel import sharded_ba as jba
from lidar_visual_odometry_tpu.parallel import sharded_mapping as jsm
from lidar_visual_odometry_tpu.parallel import sharded_odometry as jso
from lidar_visual_odometry_tpu.parallel import sharded_visual as jsv
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as tlo
from lidar_visual_odometry_tpu_torch.models import visual_frontend as tvf
from lidar_visual_odometry_tpu_torch.ops import knn as tknn
from lidar_visual_odometry_tpu_torch.ops import se3 as tse3
from lidar_visual_odometry_tpu_torch.ops.features import FeatureCloud, ScanFeatures
from lidar_visual_odometry_tpu_torch.parallel import launch, multihost, sharded_odometry
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_visual import lk_through_pallas_interpret
from test_window_ba import build_window

_TESTS = os.path.dirname(os.path.abspath(__file__))
FLEET_ENV = {"OMP_NUM_THREADS": "1"}
RANKS_AGREE = 1e-6
FIELDS = ("xyz", "ring", "rel_time", "mask")
CLOUDS = ("sharp", "less_sharp", "flat", "less_flat")


def _np(x):
    return np.asarray(x)


def _odometry_inputs():
    seq = synthetic.SyntheticSequence(n_frames=2, width=900, noise=0.005)
    cfg = jcfg.LidarConfig(azimuth_bins=1024)
    regs = []
    for k in range(2):
        xyz, mask = jpc.pad_points(seq.scan(k), 131072)
        regs.append(jsr.register_scan(jnp.asarray(xyz), jnp.asarray(mask), cfg).features)
    out = {}
    for name in CLOUDS:
        for f in FIELDS:
            out[f"odo_{name}_{f}"] = _np(getattr(getattr(regs[1], name), f))
    for name in ("less_sharp", "less_flat"):
        for f in FIELDS:
            out[f"odo_prev_{name}_{f}"] = _np(getattr(getattr(regs[0], name), f))
    return out, regs


def _mapping_inputs():
    seq = synthetic.SyntheticSequence(n_frames=3, width=1200, noise=0.003)
    cfg = jcfg.LidarConfig(azimuth_bins=1024)
    mcfg = jcfg.MappingConfig(outer_iters=3, gn_iters=4)
    mapper = jlm.LidarMapping(mcfg)

    def reg(k):
        xyz, mask = jpc.pad_points(seq.scan(k), 131072)
        return jsr.register_scan(jnp.asarray(xyz), jnp.asarray(mask), cfg).features

    def pose(k):
        R, t = seq.pose(k)
        return jse3.Pose(jse3.matrix_to_quat(jnp.asarray(R, dtype=jnp.float32)),
                         jnp.asarray(t, dtype=jnp.float32))

    mapper.process(reg(0), pose(0))
    f1 = reg(1)
    noise = jse3.se3_exp(jnp.asarray([0.06, -0.04, 0.02, 0.008, -0.006, 0.01], jnp.float32))
    pert = jse3.se3_compose(noise, pose(1))
    local = jlm.LocalMap(
        mapper.corner_map.gather_local(_np(pert.t), mcfg.submap_radius,
                                       mcfg.max_corner_map_local),
        mapper.surf_map.gather_local(_np(pert.t), mcfg.submap_radius,
                                     mcfg.max_surf_map_local))
    out = {
        "map_corner_xyz": _np(f1.less_sharp.xyz), "map_corner_mask": _np(f1.less_sharp.mask),
        "map_surf_xyz": _np(f1.less_flat.xyz), "map_surf_mask": _np(f1.less_flat.mask),
        "map_lc_xyz": _np(local.corner.xyz), "map_lc_mask": _np(local.corner.mask),
        "map_ls_xyz": _np(local.surf.xyz), "map_ls_mask": _np(local.surf.mask),
        "map_init_q": _np(pert.q), "map_init_t": _np(pert.t),
    }
    return out, (f1, local, pert, mcfg)


MH_X = np.arange(96, dtype=np.float32).reshape(8, 12)
MH_POSE = {"mh_q": np.array([1.0, 0, 0, 0], np.float32), "mh_t": np.array([1.0, 2, 3], np.float32)}

BA_NOISE = np.zeros((3, 6), np.float32)
BA_NOISE[1] = [0.04, -0.03, 0.02, 0.004, -0.006, 0.005]
BA_NOISE[2] = [-0.03, 0.04, -0.03, -0.005, 0.004, -0.006]


def _ba_inputs():
    window, gt_poses, cam = build_window(3)
    pyrs, points, masks, poses = window.stacked()
    dq = jse3.so3_exp(jnp.asarray(BA_NOISE[:, 3:]))
    perturbed = jse3.Pose(jse3.quat_normalize(jse3.quat_mul(dq, poses.q)),
                          poses.t + jnp.asarray(BA_NOISE[:, :3]))
    out = {f"ba_pyr{lvl}": _np(p) for lvl, p in enumerate(pyrs)}
    out.update(ba_points=_np(points), ba_mask=_np(masks), ba_init_q=_np(perturbed.q),
               ba_init_t=_np(perturbed.t))
    return out, (pyrs, points, masks, perturbed, cam, gt_poses)


def _visual_inputs():
    CAM, cfg = W.CAM, jcfg.VisualConfig(**{f: getattr(W.VIS_CFG, f) for f in (
        "gn_iters", "lk_levels", "lk_window", "grid_rows", "grid_cols", "max_tracked",
        "max_features_per_cell", "depth_cloud_cap")})
    cam = jcam.Pinhole(jnp.float32(CAM["fx"]), jnp.float32(CAM["fy"]), jnp.float32(CAM["cx"]),
                       jnp.float32(CAM["cy"]), CAM["width"], CAM["height"], jnp.zeros(5))
    seq = synthetic.SyntheticSequence(n_frames=2, width=600, noise=0.0)
    rng = np.random.default_rng(0)
    frames = []
    for k in range(2):
        R, t = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        img, depth = synthetic.render_image(scene=seq.scene, R_wc=R, t_wc=t, **CAM)
        ys = rng.integers(0, CAM["height"], 1500)
        xs = rng.integers(0, CAM["width"], 1500)
        z = depth[ys, xs]
        okm = np.isfinite(z)
        zz = np.where(okm, z, 1.0)
        pts = np.stack([(xs - CAM["cx"]) / CAM["fx"] * zz, (ys - CAM["cy"]) / CAM["fy"] * zz,
                        zz], -1).astype(np.float32)
        pcm, pmask = jpc.pad_points(pts, cfg.depth_cloud_cap)
        pmask &= np.concatenate([okm, np.zeros(cfg.depth_cloud_cap - okm.shape[0], bool)])
        frames.append((img, pcm, pmask))
    pyr0 = tuple(jimage.build_pyramid(jnp.asarray(frames[0][0]), cfg.lk_levels))
    pyr1 = tuple(jimage.build_pyramid(jnp.asarray(frames[1][0]), cfg.lk_levels))
    dc0 = jvf.build_depth_cloud(jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]))
    table = jvf._replenish_jit(jvf.empty_table(cfg.max_tracked), pyr0[0], cam,
                               jse3.identity_pose(), cfg)
    out = {f"vis_prev{lvl}": _np(p) for lvl, p in enumerate(pyr0)}
    out.update({f"vis_cur{lvl}": _np(p) for lvl, p in enumerate(pyr1)})
    out.update({f"vis_dc_{k}": _np(v) for k, v in zip(tvf.DepthCloud._fields, dc0)})
    out.update({f"vis_table_{k}": _np(v) for k, v in zip(tvf.FeatureTable._fields, table)})
    return out, (pyr0, pyr1, dc0, table, cam, cfg)


@pytest.fixture(scope="module")
def inputs():
    """Each function's inputs: (arrays for the port, the JAX side's own)."""
    return {"odo": _odometry_inputs(), "map": _mapping_inputs(), "ba": _ba_inputs(),
            "vis": _visual_inputs()}


@pytest.fixture(scope="module")
def runs(inputs):
    """The JAX sharded functions on the 8-device mesh and the port's on two
    (all four) and four ranks (odometry and mapping), on the same inputs."""
    (odo_in, regs), (map_in, (f1, local, pert, mcfg)) = inputs["odo"], inputs["map"]
    (ba_in, ba_j), (vis_in, vis_j) = inputs["ba"], inputs["vis"]
    # the fleets run beside the JAX side (launch waits in a thread)
    with ThreadPoolExecutor(2) as ex:
        fleets = {
            2: ex.submit(launch.launch, "_torch_mp_worker:sharded_cases", 2,
                         {**odo_in, **map_in, **ba_in, **vis_in, "mh_x": MH_X, **MH_POSE},
                         device="cpu", cwd=_TESTS, env=FLEET_ENV),
            4: ex.submit(launch.launch, "_torch_mp_worker:sharded_cases", 4,
                         {**odo_in, **map_in, "mh_x": MH_X, **MH_POSE}, device="cpu",
                         cwd=_TESTS, env=FLEET_ENV),
        }
        jax_out = _jax_sharded(regs, (f1, local, pert, mcfg), ba_j, vis_j)
        ports = {n: f.result() for n, f in fleets.items()}
    return ports, jax_out, ba_j[-1]


def _jax_sharded(regs, map_j, ba_j, vis_j):
    f1, local, pert, mcfg = map_j
    mesh = jso.make_mesh()
    jax_out = {}
    pose = jso.sharded_scan_to_scan(mesh, regs[1], regs[0].less_sharp, regs[0].less_flat,
                                    jse3.identity_pose(),
                                    jcfg.OdometryConfig(outer_iters=4, gn_iters=4))
    jax_out.update(odo_q=_np(pose.q), odo_t=_np(pose.t))
    pose = jsm.sharded_mapping_step(mesh, f1.less_sharp.xyz, f1.less_sharp.mask,
                                    f1.less_flat.xyz, f1.less_flat.mask, local, pert, mcfg)
    jax_out.update(map_q=_np(pose.q), map_t=_np(pose.t))
    pyrs, points, masks, perturbed, cam, _ = ba_j
    poses = jba.sharded_refine(mesh, pyrs, points, masks, perturbed, cam,
                               n_iters=W.BA_ITERS, level=0)
    jax_out.update(ba_q=_np(poses.q), ba_t=_np(poses.t))
    pyr0, pyr1, dc0, table, vcam, vcfg = vis_j
    with lk_through_pallas_interpret():
        uv1, ok, rel, pose_w = jsv.sharded_visual_step(mesh, pyr0, pyr1, dc0, table,
                                                       jse3.identity_pose(),
                                                       jse3.identity_pose(), vcam, vcfg)
    jax_out.update(vis_uv1=_np(uv1), vis_ok=_np(ok), vis_rel_t=_np(rel.t),
                   vis_pose_w_t=_np(pose_w.t))
    return jax_out


@pytest.mark.parametrize("ranks", [2, 4])
def test_ranks_agree(runs, ranks):
    ports, _, _ = runs
    first = ports[ranks][0]
    for other in ports[ranks][1:]:
        assert other.keys() == first.keys()
        for key in (k for k in first if not k.startswith("mh_")):    # mh_*: per rank
            np.testing.assert_allclose(other[key], first[key], atol=RANKS_AGREE, err_msg=key)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_scan_to_scan_matches_jax(runs, ranks):
    """Within 1e-4 m of JAX's; two and four ranks give the same bits (each
    rank's partial sums are float64, rounded to float32 after the
    all-reduce)."""
    ports, want, _ = runs
    got = ports[ranks][0]
    np.testing.assert_allclose(got["odo_t"], want["odo_t"], atol=1e-4)
    assert abs(float(got["odo_q"] @ want["odo_q"])) > 1 - 1e-6
    assert np.linalg.norm(got["odo_t"]) > 0.1      # it moved off the identity
    np.testing.assert_array_equal(got["odo_t"], ports[2][0]["odo_t"])
    np.testing.assert_array_equal(got["odo_q"], ports[2][0]["odo_q"])


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_mapping_step_matches_jax(runs, ranks):
    """Held to the single-device mapping step's bound against JAX
    (``tests/test_torch_mapping.py``): the plane fit solves normal equations
    ill-conditioned tens of metres out, by LU in the JAX package and by
    cofactors in the port (ROADMAP C). Measured 3.8e-3 m here, as between
    the two packages' single-device ``mapping_step`` on these inputs; within
    each package the sharded and single-device steps agree to float32 print
    precision. Two and four ranks merge to the same pose, bit for bit: a
    pair's distance does not depend on the rank's block
    (``knn.sqdist_by_axis``)."""
    ports, want, _ = runs
    np.testing.assert_allclose(ports[ranks][0]["map_t"], want["map_t"], atol=5e-3)
    np.testing.assert_array_equal(ports[ranks][0]["map_t"], ports[2][0]["map_t"])


def test_sharded_refine_matches_jax(runs):
    """Both land in the same basin: each keyframe's pose error within 0.02
    of the other's, and below half the perturbation."""
    ports, want, gt_poses = runs
    got = ports[2][0]

    def err(q, t, k):
        est = jse3.Pose(jnp.asarray(q[k]), jnp.asarray(t[k]))
        return float(jnp.linalg.norm(jse3.se3_log(jse3.se3_compose(
            jse3.se3_inverse(gt_poses[k]), est))))

    for k in (1, 2):
        e_port, e_jax = err(got["ba_q"], got["ba_t"], k), err(want["ba_q"], want["ba_t"], k)
        assert abs(e_port - e_jax) < 0.02, (k, e_port, e_jax)
        assert e_port < 0.5 * float(np.linalg.norm(BA_NOISE[k])), (k, e_port)


def test_sharded_visual_step_matches_jax(runs):
    ports, want, _ = runs
    got = ports[2][0]
    np.testing.assert_array_equal(got["vis_ok"], want["vis_ok"])
    # the tracker's bound against the JAX tracker on the Pallas kernel in
    # interpret mode, whose CPU code contracts multiply-adds
    # (tests/test_torch_visual.py; ROADMAP C): measured 9.9e-5 px
    np.testing.assert_allclose(got["vis_uv1"], want["vis_uv1"], atol=2e-4)
    np.testing.assert_allclose(got["vis_rel_t"], want["vis_rel_t"], atol=5e-4)
    np.testing.assert_allclose(got["vis_pose_w_t"], want["vis_pose_w_t"], atol=5e-4)
    assert np.linalg.norm(got["vis_rel_t"]) > 0.1


# ---------------------------------------------------------------- hooks --

def _port_features(regs, k):
    return ScanFeatures(*(FeatureCloud(*(torch.from_numpy(np.array(getattr(getattr(regs[k], c), f)))
                                         for f in FIELDS)) for c in CLOUDS))


def test_scan_to_scan_reduce_hook(inputs):
    """An identity reduction takes the plain GN loop (as the JAX package does
    under any reduction), close to the fused kernel's poses; unused, the hook
    leaves the fused kernel's bits (K3's plain version)."""
    _, regs = inputs["odo"]
    cur, prev = _port_features(regs, 1), _port_features(regs, 0)
    ident = tse3.identity_pose(torch.device("cpu"))
    cfg = tcfg.OdometryConfig(outer_iters=4, gn_iters=4)
    args = (cur, prev.less_sharp, prev.less_flat, ident, cfg)
    fused = tlo.scan_to_scan_impl(*args)
    again = tlo.scan_to_scan_impl(*args, reduce_fn=None)
    calls = []
    plain = tlo.scan_to_scan_impl(*args, reduce_fn=lambda H, g: calls.append(1) or (H, g))
    assert torch.equal(fused.t, again.t) and torch.equal(fused.q, again.q)
    assert len(calls) >= 2 * cfg.gn_iters
    np.testing.assert_allclose(plain.t.numpy(), fused.t.numpy(), atol=1e-5)


def test_solve_pose_reduce_hook(inputs):
    """``solve_pose`` with an identity reduction: the reduction sees float64
    partial sums H (6, 6), g (6,) and sum_e and the int64 count, and the
    pose lies within float32 rounding of the unreduced solve's."""
    vis_in, _ = inputs["vis"]
    t = {k: torch.from_numpy(np.array(v)) for k, v in vis_in.items()}
    cfg = W.VIS_CFG
    tab = tvf.FeatureTable(*(t[f"vis_table_{k}"] for k in tvf.FeatureTable._fields))
    dc = tvf.DepthCloud(*(t[f"vis_dc_{k}"] for k in tvf.DepthCloud._fields))
    prev = tuple(t[f"vis_prev{lvl}"] for lvl in range(cfg.lk_levels))
    cur = tuple(t[f"vis_cur{lvl}"] for lvl in range(cfg.lk_levels))
    cam = W._cam(sharded_odometry.Mesh(0, 1, torch.device("cpu")))
    uv1, ok = tvf._track(prev, cur, tab, cfg)
    ident = tse3.identity_pose(torch.device("cpu"))
    _, un0, un1, depth, has_depth, epi_ok = tvf.depth_gates(uv1, ok, dc, tab, ident, cam)
    seen = []

    def spy(H, g, n, s):
        seen.append((H.shape, H.dtype, g.shape, g.dtype, n.dtype, s.shape, s.dtype))
        return H, g, n, s

    a = tvf.solve_pose(ident, un0, un1, depth, has_depth, epi_ok, cfg)
    b = tvf.solve_pose(ident, un0, un1, depth, has_depth, epi_ok, cfg, reduce_fn=spy)
    assert b.t.dtype == torch.float32
    np.testing.assert_allclose(b.t.numpy(), a.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(b.q.numpy(), a.q.numpy(), atol=1e-6)
    f64 = torch.float64
    assert seen and seen[0] == ((6, 6), f64, (6,), f64, torch.int64, (), f64)


@pytest.mark.parametrize("chunk", [7, 64, 2048])
def test_knn_chunked_matches_jax(rng, chunk):
    """The running top-k over column blocks against the JAX package's
    ``knn(chunk=…)`` on a 1/8 grid (exact distances, ties among them), with
    masked candidates and a query that has fewer than k of them near; the
    unchunked search where every query has k candidates."""
    q = np.round(rng.uniform(-4, 4, (40, 3)) * 8) / 8
    c = np.round(rng.uniform(-4, 4, (300, 3)) * 8) / 8
    mask = rng.uniform(size=300) < 0.9
    q, c = q.astype(np.float32), c.astype(np.float32)
    want_i, want_d = jknn.knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), 5, chunk=chunk)
    got_i, got_d = tknn.knn(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(mask), 5,
                            chunk=chunk)
    np.testing.assert_array_equal(got_d.numpy(), _np(want_d))
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    dense_i, dense_d = tknn.knn(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(mask),
                                5)
    np.testing.assert_array_equal(dense_d.numpy(), got_d.numpy())
    np.testing.assert_array_equal(dense_i.numpy(), got_i.numpy())


@pytest.mark.parametrize("blocks", [2, 3])
def test_knn_chunked_distances_do_not_depend_on_the_blocks(rng, blocks):
    """Off the grid, on random floats: the streamed search's distances are
    the same bits whatever the chunk, and the k best of each block of the
    candidates, merged by (distance, block, slot) as the sharded scan-to-map
    step merges its ranks', are the k best of the whole cloud."""
    q = torch.from_numpy(rng.normal(0, 3, (64, 3)).astype(np.float32))
    c = torch.from_numpy(rng.normal(0, 3, (600, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=600) < 0.8)
    want_i, want_d = tknn.knn(q, c, mask, 5, chunk=64)
    for chunk in (7, 100):
        got_i, got_d = tknn.knn(q, c, mask, 5, chunk=chunk)
        assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    per = 600 // blocks
    parts = []
    for b in range(blocks):
        i, d = tknn.knn(q, c[b * per:(b + 1) * per], mask[b * per:(b + 1) * per], 5, chunk=64)
        parts.append(torch.cat([d[..., None], (i + b * per).to(torch.float32)[..., None]], -1))
    cand = torch.stack(parts, 1).reshape(64, blocks * 5, 2)
    sel, merged_d = tknn._smallest_k(cand[..., 0], 5)
    assert torch.equal(merged_d, want_d)
    assert torch.equal(cand[..., 1].gather(1, sel).to(torch.int64), want_i)


def test_knn_chunked_unfilled_slots_follow_jax():
    """Fewer unmasked candidates than k: the streamed search keeps index 0 at
    1e30 in the unfilled slots, as the JAX package's does."""
    q = np.zeros((2, 3), np.float32)
    c = np.arange(30, dtype=np.float32).reshape(10, 3)
    mask = np.zeros(10, bool)
    mask[[3, 8]] = True
    want_i, want_d = jknn.knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), 4, chunk=4)
    got_i, got_d = tknn.knn(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(mask), 4,
                            chunk=4)
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_array_equal(got_d.numpy(), _np(want_d))


# ------------------------------------------------------ multihost, launch --

def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        sharded_odometry.make_mesh()


def test_initialize_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("file:///nonexistent/store", 1, 0, device="cuda")


def test_block_needs_a_dividing_world_size():
    mesh = sharded_odometry.Mesh(1, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        mesh.block(torch.zeros(8, 3))
    np.testing.assert_array_equal(mesh.block(torch.arange(9)).numpy(), [3, 4, 5])


@pytest.mark.parametrize("ranks", [2, 4])
def test_multihost_placement_on_a_fleet(runs, ranks):
    """``shard_batch`` along either axis and ``replicate`` give back the whole
    arrays on every rank, ``block`` the rank's rows, in rank order."""
    ports, _, _ = runs
    for rank, r in enumerate(ports[ranks]):
        assert int(r["mh_rank"]) == rank and int(r["mh_size"]) == ranks
        assert str(r["mh_device"]) == "cpu"
        np.testing.assert_array_equal(r["mh_along0"], MH_X)
        np.testing.assert_array_equal(r["mh_along1"], MH_X)
        per = MH_X.shape[0] // ranks
        np.testing.assert_array_equal(r["mh_block"], MH_X[per * rank:per * (rank + 1)])
        np.testing.assert_array_equal(r["mh_t"], MH_POSE["mh_t"])


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 was asked to fail"):
        launch.launch("_torch_mp_worker:fail", 2, {}, device="cpu", cwd=_TESTS, env=FLEET_ENV,
                      timeout=120)


def test_launch_rejects_a_bad_target():
    with pytest.raises(ValueError, match="module:function"):
        launch._resolve("no_function_here")
