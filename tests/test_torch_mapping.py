"""The port's mapping slice against the JAX package on the CPU: kernels K4 and
K5 (plain versions) against the Pallas kernels in interpret mode, the flat
segment sum, cell keys, the flat voxel filter, the voxel map merge, the
line/plane fits and the fitted-plane factor, one mapping step from a carried
map state, and ``FullPipeline.run_chunked`` end to end."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import device_mapping as jdm
from lidar_visual_odometry_tpu.models import scan_registration as jsr
from lidar_visual_odometry_tpu.models.pipeline import FullPipeline as JaxFullPipeline
from lidar_visual_odometry_tpu.ops import fit as jfit
from lidar_visual_odometry_tpu.ops import knn as jknn
from lidar_visual_odometry_tpu.ops import lidar_factors as jlf
from lidar_visual_odometry_tpu.ops import pallas_nn, pallas_segsum
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu.ops import se3 as jse3
from lidar_visual_odometry_tpu.ops import voxel_map as jvm
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.kernels import segsum as kseg
from lidar_visual_odometry_tpu_torch.kernels import topk as ktop
from lidar_visual_odometry_tpu_torch.models import device_mapping as dm
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import fit
from lidar_visual_odometry_tpu_torch.ops import lidar_factors as lf
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
from lidar_visual_odometry_tpu_torch.ops import se3
from lidar_visual_odometry_tpu_torch.ops.voxel_map import voxel_merge
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

SMALL = dict(outer_iters=2, gn_iters=4, corner_slot=1024, surf_slot=1024,
             map_corner_cap=2048, map_surf_cap=2048)


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered(rng, n, centers, scale):
    return (centers[rng.integers(0, len(centers), n)]
            + rng.normal(size=(n, 3)) * scale).astype(np.float32)


# ------------------------------------------------------------------ K4, K5


@pytest.mark.parametrize("Q,C,K,GW,qt,ct", [(256, 1024, 5, 64, 64, 128),
                                            (128, 512, 3, 32, 32, 128)])
def test_block_topk_windowed_plain_matches_pallas(rng, Q, C, K, GW, qt, ct):
    """The shapes of tests/test_pallas_gn.py's windowed tests, clustered so
    cells are occupied. Candidates of equal key may sit in another order
    (the reference's sort is not stable), so coordinates and distances are
    compared, not indices."""
    centers = rng.normal(size=(12, 3)).astype(np.float32) * 20
    q = _clustered(rng, Q, centers, 1.0)
    c = _clustered(rng, C, centers, 1.5)
    mask = rng.uniform(size=C) > 0.3
    origin = (np.min(np.concatenate([q, c]), axis=0)[:2] - 3.0).astype(np.float32)
    kw = dict(cell=2.0, grid_w=GW)

    cs_j, ck_j = pallas_nn.sort_by_cell(jnp.asarray(c), jnp.asarray(mask), jnp.asarray(origin), **kw)
    qk_j = pallas_nn.cell_keys(jnp.asarray(q), jnp.asarray(origin), **kw)
    d_j, i_j = pallas_nn.block_topk_windowed(jnp.asarray(q), qk_j, cs_j, ck_j, k=K, q_tile=qt,
                                             c_tile=ct, grid_w=GW, interpret=True)
    cs_t, ck_t = ktop.sort_by_cell(_t(c), _t(mask), _t(origin), **kw)
    qk_t = ktop.cell_keys(_t(q), _t(origin), **kw)
    kernels.reset_launch_counts()
    d_t, i_t = ktop.block_topk_windowed(_t(q), qk_t, cs_t, ck_t, k=K, q_tile=qt, c_tile=ct,
                                        grid_w=GW)
    assert kernels.launch_counts()["block_topk_windowed"] == 0   # the CPU runs the plain version

    np.testing.assert_array_equal(qk_t.numpy(), np.asarray(qk_j))
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    d_j, d_t = np.asarray(d_j), d_t.numpy()
    within = d_j < 4.0                     # one cell: the exactness contract
    np.testing.assert_array_equal(d_t < 4.0, within)
    # the same candidates; XLA's CPU code contracts the distance's products
    # and sums into fused multiply-adds (1 ulp) where the port rounds each:
    # rtol 1e-6, and the same neighbours
    np.testing.assert_allclose(d_t[within], d_j[within], rtol=1e-6)
    np.testing.assert_array_equal(cs_t.numpy()[i_t.numpy()][within],
                                  np.asarray(cs_j)[np.asarray(i_j)][within])
    # every tile reads the same chunks on both sides (equal keys in equal
    # places), so even beyond the cell only equal-key reorderings differ
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)


def test_block_topk_plain_matches_pallas(rng):
    Q, C, K = 256, 1024, 5
    q = rng.normal(size=(Q, 3)).astype(np.float32) * 10
    c = rng.normal(size=(C, 3)).astype(np.float32) * 10
    mask = rng.uniform(size=C) > 0.3
    baked_j = pallas_nn.bake_mask(jnp.asarray(c), jnp.asarray(mask))
    d_j, i_j = pallas_nn.block_topk(jnp.asarray(q), baked_j, k=K, q_tile=128, c_tile=256,
                                    interpret=True)
    d_t, i_t = ktop.block_topk(_t(q), _t(np.asarray(baked_j)), k=K)
    # one candidate order and the same tie rule; distances within 1 ulp
    # (fused multiply-adds in XLA's CPU code, see the windowed test)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_block_topk_ties_and_sentinels():
    """Equal distances go to the lower index; slots no candidate fills (a
    tile whose window misses every chunk) hold 1e30 and index 0."""
    c = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, 0, 3.0]])
    d, i = ktop.block_topk(torch.zeros((1, 3)), c, k=3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2]])
    np.testing.assert_array_equal(d.numpy(), [[1.0, 1.0, 1.0]])
    d, i = ktop.block_topk(torch.zeros((1, 3)), c[:2], k=3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 0]])
    assert d[0, 2] == np.float32(1e30)
    keys = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    d, i = ktop.block_topk_windowed(torch.zeros((2, 3)), torch.tensor([900, 900], dtype=torch.int32),
                                    c, keys, k=2, q_tile=2, c_tile=4, grid_w=8)
    np.testing.assert_array_equal(d.numpy(), np.float32(1e30))
    np.testing.assert_array_equal(i.numpy(), 0)


# ---------------------------------------------------------------- K1, flat


@pytest.mark.parametrize("W,S,sorted_ids", [(1500, 300, True), (1500, 300, False),
                                            (7680, 4097, True)])
def test_flat_segment_sum_plain_matches_pallas(rng, W, S, sorted_ids):
    seg = rng.integers(0, S, W)
    if sorted_ids:
        seg = np.sort(seg)
    seg = seg.astype(np.int32)
    vals = rng.normal(size=(4, W)).astype(np.float32)
    want = pallas_segsum.segment_sum(jnp.asarray(seg), jnp.asarray(vals), n_segments=S,
                                     interpret=True)
    kernels.reset_launch_counts()
    got = kseg.segment_sum(_t(seg), _t(vals), n_segments=S)
    assert kernels.launch_counts()["segment_sum"] == 0
    # one-hot products over rows of ≤ 512 points, then a sum over rows,
    # against one scatter-add: float32 reordering of ≤ W terms of |v| ≲ 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------- keys and voxels


def test_cell_keys_on_cell_boundaries():
    """Points exactly on cell edges and outside the grid land in the same
    cells on both sides (the key is a product with the float32 1/cell)."""
    xs = np.array([-256.0, -2.0, 0.0, 1.9999999, 2.0, 3.0000002, 254.0, 255.99998, 256.0, 1e6],
                  np.float32)
    pts = np.stack([xs, xs[::-1], np.zeros_like(xs)], axis=1)
    origin = np.array([-256.0, -256.0], np.float32)
    want = pallas_nn.cell_keys(jnp.asarray(pts), jnp.asarray(origin), cell=2.0, grid_w=256)
    got = ktop.cell_keys(_t(pts), _t(origin), cell=2.0, grid_w=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boundary_cloud(rng, n, leaf):
    """Random points plus points on exact leaf multiples (voxel edges)."""
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    k = n // 4
    pts[:k] = (np.round(pts[:k] / leaf) * leaf).astype(np.float32)
    return pts


@pytest.mark.parametrize("W,leaf,max_out", [(7680, 0.4, 4096), (7680, 0.8, 300),
                                            (2000, 0.8, 4096)])
def test_voxel_downsample_matches_jax(rng, W, leaf, max_out):
    """(7680, 0.8, 300) overflows: the hash order picks which voxels stay."""
    xyz = _boundary_cloud(rng, W, leaf)
    mask = rng.uniform(size=W) > 0.2
    # jitted, as the reference pipeline runs it: XLA then rewrites the
    # division by the leaf as a product with its float32 reciprocal
    want = jax.jit(partial(jpc.voxel_downsample, leaf=leaf, max_out=max_out))(
        jnp.asarray(xyz), jnp.asarray(mask))
    got = pc.voxel_downsample(_t(xyz), _t(mask), leaf=leaf, max_out=max_out)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # voxel means of the same points, summed in another order: 2e-5 m
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=2e-5)


def _merge_both(map_xyz, map_mask, new_xyz, new_mask, center, **kw):
    want = jax.jit(partial(jvm.voxel_merge, **kw))(     # jitted, as in the pipeline
        jnp.asarray(map_xyz), jnp.asarray(map_mask), jnp.asarray(new_xyz),
        jnp.asarray(new_mask), jnp.asarray(center, jnp.float32))
    got = voxel_merge(_t(map_xyz), _t(map_mask), _t(new_xyz), _t(new_mask),
                      torch.tensor(center, dtype=torch.float32), **kw)
    return got, want


@pytest.mark.parametrize("center,cap,drop", [((0.0, 0.0, 0.0), 2048, 150.0),
                                             ((87.3, -12.1, 1.7), 2048, 150.0),
                                             ((5.0, 3.0, 0.0), 700, 50.0)])
def test_voxel_merge_matches_jax(rng, center, cap, drop):
    """A half-full map merged with a new slab whose points sit partly on leaf
    edges and partly in occupied cells; the last case overflows the cap and
    drops points beyond 50 m."""
    leaf = 0.4
    old = _boundary_cloud(rng, cap, leaf) + np.asarray(center, np.float32)
    old_mask = np.arange(cap) < cap // 2
    new = np.concatenate([old[: cap // 4] + 0.05, _boundary_cloud(rng, 1024 - cap // 4, leaf)])
    new = new.astype(np.float32)
    new_mask = rng.uniform(size=new.shape[0]) > 0.1
    got, want = _merge_both(old, old_mask, new, new_mask, center, leaf=leaf, cap=cap,
                            drop_radius=drop)
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    # the merge copies points: kept coordinates are identical
    np.testing.assert_array_equal(got.xyz.numpy()[m], np.asarray(want.xyz)[m])


# ------------------------------------------------------------------- fits


def _lines(rng, n):
    """5-point neighbourhoods far from the line gate: lines (1.6 m long,
    1 cm noise, λmax / λmid ≫ 3) and blobs, up to 40 m from the origin."""
    base = rng.uniform(-40, 40, (n, 1, 3))
    u = rng.normal(size=(n, 1, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    line = base + u * np.linspace(-0.8, 0.8, 5)[None, :, None] + rng.normal(scale=0.01, size=(n, 5, 3))
    blob = base + rng.normal(scale=0.5, size=(n, 5, 3))
    return np.concatenate([line, blob]).astype(np.float32)


def _planes(rng, n):
    """5-point neighbourhoods far from the 0.2 m planarity gate: planes (5 mm
    noise) and the same points bent ±0.6 m off the plane. The plane fit solves
    normal equations whose conditioning falls with (distance / spread)² (see
    test_fit_gate_flips_on_random_neighbourhoods), so the planes face the
    origin 1.5-3 m away (condition number ~80)."""
    u = rng.normal(size=(n, 1, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(u, rng.normal(size=(n, 1, 3)))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    s = rng.uniform(-0.8, 0.8, (n, 5, 2))
    plane = (u * rng.uniform(1.5, 3.0, (n, 1, 1)) + v * s[..., :1] + np.cross(u, v) * s[..., 1:]
             + rng.normal(scale=0.005, size=(n, 5, 3)))
    bent = plane + u * np.array([1.0, -1.0, 1.0, -1.0, 1.0])[None, :, None] * 0.6
    return np.concatenate([plane, bent]).astype(np.float32)


def test_line_and_plane_fit_match_jax(rng):
    lines = _lines(rng, 256)
    mask = np.ones(lines.shape[:2], bool)
    mask[::17, 2] = False                      # a few incomplete neighbourhoods
    cj, dj, okj = jfit.line_fit(jnp.asarray(lines), jnp.asarray(mask))
    ct, dt, okt = fit.line_fit(_t(lines), _t(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 0.3 < okt.numpy().mean() < 0.7
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    ok = np.asarray(okj)
    sign = np.sign(np.sum(dt.numpy() * np.asarray(dj), axis=-1, keepdims=True))
    # a dominant eigenvector, well separated: 1e-4
    np.testing.assert_allclose((dt.numpy() * sign)[ok], np.asarray(dj)[ok], atol=1e-4)

    planes = _planes(rng, 256)
    nj, offj, pokj = jfit.plane_fit(jnp.asarray(planes), jnp.asarray(mask))
    nt, offt, pokt = fit.plane_fit(_t(planes), _t(mask))
    np.testing.assert_array_equal(pokt.numpy(), np.asarray(pokj))
    assert 0.3 < pokt.numpy().mean() < 0.7
    pok = np.asarray(pokj)
    # Cramer's rule on the normal equations (LU determinants in the
    # reference, cofactors in the port) leaves each normal ~1e-3 from a
    # float64 solve even here: measured 1.0e-3 and 1.7e-3, 1.5e-3 between
    # the two; normals and offsets held to 5e-3
    np.testing.assert_allclose(nt.numpy()[pok], np.asarray(nj)[pok], atol=5e-3)
    np.testing.assert_allclose(offt.numpy()[pok], np.asarray(offj)[pok], atol=5e-3)


@pytest.mark.parametrize("reach", [5.0, 40.0])
def test_fit_gate_flips_on_random_neighbourhoods(rng, reach):
    """Unconstructed neighbourhoods (5 points spread 0.05-0.5 m, within
    ``reach`` of the origin, as map points are) sit on the gates often. The
    line gate (a centred covariance) never flips. The plane gate solves
    ΣppᵀM = −Σp, whose condition number grows as (range / spread)², so both
    sides' gates are noisy there: measured 244 (5 m) and 1331 (40 m) flips
    in 4096, where the reference disagrees with a float64 evaluation 244 and
    2931 times and the port 6 and 1734 times. The port must agree with
    float64 at least as often as the reference does."""
    n = 4096
    base = rng.uniform(-reach, reach, (n, 1, 3))
    nbrs = (base + rng.normal(size=(n, 5, 3)) * rng.uniform(0.05, 0.5, (n, 1, 3))).astype(np.float32)
    mask = np.ones((n, 5), bool)
    _, _, okj = jfit.line_fit(jnp.asarray(nbrs), jnp.asarray(mask))
    _, _, okt = fit.line_fit(_t(nbrs), _t(mask))
    assert int(np.sum(okt.numpy() != np.asarray(okj))) <= 4       # measured 0
    _, _, pokj = jfit.plane_fit(jnp.asarray(nbrs), jnp.asarray(mask))
    _, _, pokt = fit.plane_fit(_t(nbrs), _t(mask))
    A = nbrs.astype(np.float64)
    m = np.linalg.solve(np.einsum("nki,nkj->nij", A, A), -A.sum(1)[..., None])[..., 0]
    norm = np.linalg.norm(m, axis=-1)
    ok64 = np.all(np.abs(np.einsum("nki,ni->nk", A, m / norm[:, None]) + 1.0 / norm[:, None])
                  <= 0.2, axis=-1)
    assert np.sum(pokt.numpy() != ok64) <= np.sum(np.asarray(pokj) != ok64)


def test_det3x3_against_lu_determinant(rng):
    """The cofactor determinant against ``jnp.linalg.det`` (LU) on
    well-conditioned matrices: measured at most 3.0e-6 relative (2048
    matrices, this seed); held to 1e-5."""
    A = rng.normal(size=(2048, 3, 3)).astype(np.float32) + 3.0 * np.eye(3, dtype=np.float32)
    want = np.asarray(jnp.linalg.det(jnp.asarray(A)))
    got = fit.det3x3(_t(A)).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert np.max(rel) < 1e-5, np.max(rel)


def test_norm_plane_residuals_match_jax(rng):
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    d = rng.normal(size=64).astype(np.float32)
    mask = rng.uniform(size=64) > 0.2
    pose = jse3.se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.02, -0.01, 0.05], jnp.float32))
    rj, Jj = jlf.norm_plane_residuals(pose, jlf.NormPlaneCorr(
        jnp.asarray(p), jnp.asarray(n), jnp.asarray(d), jnp.asarray(mask)))
    rt, Jt = lf.norm_plane_residuals(se3.Pose(_t(pose.q), _t(pose.t)),
                                     lf.NormPlaneCorr(_t(p), _t(n), _t(d), _t(mask)))
    # the same float32 arithmetic in another association order: 1e-5
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-5)


# --------------------------------------------------------------- mapping


@pytest.fixture(scope="module")
def corridor():
    seq = jsyn.SyntheticSequence(n_frames=5, width=600, noise=0.005)
    return seq, [seq.scan(k) for k in range(5)]


def _gt_pose(seq, k, dt=(0.0, 0.0, 0.0)):
    yaw = seq.yaw_rate * k
    q = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32)
    return q, (seq.pose(k)[1] + np.asarray(dt)).astype(np.float32)


def _fc_to_torch(fc):
    return F.FeatureCloud(*(torch.from_numpy(np.array(x)) for x in fc))


@pytest.fixture(scope="module")
def carried(corridor):
    """Frames 0 and 1 build a JAX map at their true poses; the map state goes
    across with the checkpoint's keys. Frame 2 comes with its pose 5 cm off."""
    seq, scans = corridor
    lcfg = jcfg.LidarConfig(azimuth_bins=1024)
    mcfg_j = jcfg.MappingConfig(**SMALL)
    geom = dict(n_scans=64, width=1024, min_range=0.1, max_range=120.0)
    feats = [jsr.register_polar(jnp.asarray(jpc.pack_polar_scan(s, channels=1, **geom)),
                                lcfg).features for s in scans[:3]]
    state = jdm.init_state(mcfg_j)
    for k in range(2):
        q, t = _gt_pose(seq, k)
        state, _ = jdm.device_mapping_step(
            state, feats[k].less_sharp.xyz, feats[k].less_sharp.mask,
            feats[k].less_flat.xyz, feats[k].less_flat.mask,
            jse3.Pose(jnp.asarray(q), jnp.asarray(t)), mcfg_j)
    arrays = {f"mapst_{i}": np.asarray(leaf) for i, leaf in enumerate(jax.tree.leaves(state))}
    return state, dm.device_map_state_from_numpy(arrays, device="cpu"), feats[2], \
        _gt_pose(seq, 2, dt=(0.05, -0.03, 0.02))


def test_scan_to_map_association_matches_jax(carried):
    """Round 1 of the solve from the carried map: the reference's CPU branch
    (dense knn.knn, matrix-product distances) against the port's windowed
    search (K4's plain version, direct distances): the same gates, the same
    neighbours, the same accepted lines and planes."""
    state_j, state_t, feats, (q, t) = carried
    mcfg = tcfg.MappingConfig(**SMALL)
    pose_j = jse3.se3_compose(state_j.correction, jse3.Pose(jnp.asarray(q), jnp.asarray(t)))
    pose_t = se3.se3_compose(state_t.correction, se3.Pose(_t(q), _t(t)))
    for cloud, leaf, slot, which in ((feats.less_sharp, mcfg.corner_leaf, mcfg.corner_slot, 0),
                                     (feats.less_flat, mcfg.surf_leaf, mcfg.surf_slot, 2)):
        ds_j = jax.jit(partial(jpc.voxel_downsample, leaf=leaf, max_out=slot))(cloud.xyz, cloud.mask)
        ds_t = pc.voxel_downsample(_t(cloud.xyz), _t(cloud.mask), leaf=leaf, max_out=slot)
        np.testing.assert_array_equal(ds_t.mask.numpy(), np.asarray(ds_j.mask))
        cand_j = (state_j[which], state_j[which + 1])
        cand_t = pc.PointBatch(state_t[which], state_t[which + 1])
        idx, d_j = jknn.knn(jse3.se3_apply(pose_j, ds_j.xyz), *cand_j, 5, chunk=4096)
        nb_j = np.asarray(cand_j[0])[np.asarray(idx)]
        origin = pose_t.t[:2] - 256.0
        c_sorted, c_keys = ktop.sort_by_cell(*cand_t, origin, cell=2.0, grid_w=256)
        qw = se3.se3_apply(pose_t, ds_t.xyz)
        d_t, i_t = ktop.block_topk_windowed(qw, ktop.cell_keys(qw, origin, cell=2.0, grid_w=256),
                                            c_sorted, c_keys, q_tile=256)
        nb_t = c_sorted.numpy()[i_t.numpy()]
        d_j, d_t = np.asarray(d_j), d_t.numpy()
        ok = d_j < 1.0
        np.testing.assert_array_equal(d_t < 1.0, ok)
        assert ok.mean() > 0.3
        # gated neighbours: the same points but for near ties, which the
        # matrix-product distances of the reference (cancellation at
        # |q|² ≲ 1e4 m²: up to 1.05e-3 m² measured) may order otherwise
        same = np.all(nb_t == nb_j, axis=-1)
        assert same[ok].mean() > 0.995          # measured 0.9988 and 0.9993
        exact_j = np.sum((nb_j.astype(np.float64) - qw.numpy()[:, None]) ** 2, axis=-1)
        tie = ok & ~same
        np.testing.assert_allclose(exact_j[tie], d_t[tie], atol=2e-3)
        np.testing.assert_allclose(d_t[ok], d_j[ok], atol=2e-3)
        if which == 0:
            got = fit.line_fit(_t(nb_j), _t(ok))[2].numpy()
            want = np.asarray(jfit.line_fit(jnp.asarray(nb_j), jnp.asarray(ok))[2])
        else:
            got = fit.plane_fit(_t(nb_j), _t(ok))[2].numpy()
            want = np.asarray(jfit.plane_fit(jnp.asarray(nb_j), jnp.asarray(ok))[2])
        # the plane gate may flip on ill-conditioned neighbourhoods
        # (test_fit_gate_flips_on_random_neighbourhoods); measured 0 here
        assert np.sum(got != want) <= 0.01 * got.size


def test_device_mapping_step_from_carried_state(carried):
    """One mapped frame from the carried JAX map on both sides."""
    state_j, state_t, feats, (q, t) = carried
    new_j, ref_j = jdm.device_mapping_step(
        state_j, feats.less_sharp.xyz, feats.less_sharp.mask,
        feats.less_flat.xyz, feats.less_flat.mask,
        jse3.Pose(jnp.asarray(q), jnp.asarray(t)), jcfg.MappingConfig(**SMALL))
    assert int(state_t.corner_mask.sum()) > 500 and int(state_t.surf_mask.sum()) > 500
    ls, lfl = _fc_to_torch(feats.less_sharp), _fc_to_torch(feats.less_flat)
    new_t, ref_t = dm.device_mapping_impl(state_t, ls.xyz, ls.mask, lfl.xyz, lfl.mask,
                                          se3.Pose(_t(q), _t(t)), tcfg.MappingConfig(**SMALL))
    # The same neighbours and gates on both sides
    # (test_scan_to_map_association_matches_jax), but the plane fit solves
    # normal equations that are ill-conditioned tens of metres from the
    # origin: LU (reference) and cofactor (port) determinants give normals
    # up to 0.05 apart on accepted planes. Measured 2.3e-3 m and 2.2e-5 in q
    # after the adaptive rounds; held to 5e-3 m and 1e-4.
    np.testing.assert_allclose(ref_t.t.numpy(), np.asarray(ref_j.t), atol=5e-3)
    np.testing.assert_allclose(ref_t.q.numpy(), np.asarray(ref_j.q), atol=1e-4)
    # the merged map: points placed by poses that close fall in the same
    # leaf cells except at cell edges: ≥ 99% of the masks agree
    for a, b in ((new_t.corner_mask, new_j.corner_mask), (new_t.surf_mask, new_j.surf_mask)):
        assert np.mean(a.numpy() == np.asarray(b)) > 0.99
    # the correction is refined ∘ odometry⁻¹
    corr = se3.se3_compose(new_t.correction, se3.Pose(_t(q), _t(t)))
    np.testing.assert_allclose(corr.t.numpy(), ref_t.t.numpy(), atol=1e-5)


def _configs(mapping=None, bins=1024):
    kw = dict(SMALL, **(mapping or {}))
    return (jcfg.SystemConfig(lidar=jcfg.LidarConfig(azimuth_bins=bins),
                              odometry=jcfg.OdometryConfig(outer_iters=4),
                              mapping=jcfg.MappingConfig(**kw)),
            tcfg.SystemConfig(lidar=tcfg.LidarConfig(azimuth_bins=bins),
                              odometry=tcfg.OdometryConfig(outer_iters=4),
                              mapping=tcfg.MappingConfig(**kw)))


@pytest.fixture(scope="module")
def slam_runs(corridor):
    """The 5-frame corridor through both pipelines (and the port's dense
    search), shared by the end-to-end tests."""
    _, scans = corridor
    cfg_j, cfg_t = _configs()
    want = JaxFullPipeline(cfg_j).run_chunked(scans, chunk=2, map_skip=1, ingest="polar2")
    kernels.reset_launch_counts()
    got = FullPipeline(cfg_t, device="cpu").run_chunked(scans, chunk=2, map_skip=1,
                                                         ingest="polar2")
    dense = FullPipeline(_configs({"windowed_nn": False})[1], device="cpu").run_chunked(
        scans, chunk=2, map_skip=1, ingest="polar2")
    return want, got, dense


def test_full_pipeline_run_chunked_matches_jax(corridor, slam_runs):
    seq, _ = corridor
    (odo_j, map_j), (odo_t, map_t), _ = slam_runs
    assert map_t.positions.shape == (5, 3) and map_t.quaternions.shape == (5, 4)
    # odometry: as tests/test_torch_odometry.py's chunked pipeline, 2e-4 m
    np.testing.assert_allclose(odo_t.positions, odo_j.positions, atol=2e-4)
    # mapping: the same neighbours, but the ill-conditioned plane fits of
    # the reference (see test_device_mapping_step_from_carried_state) put
    # a few mm between the refined poses from frame 2 on, and each frame's
    # map inherits them. Measured 6.1e-3 m; held to 1e-2 m.
    np.testing.assert_allclose(map_t.positions, map_j.positions, atol=1e-2)
    np.testing.assert_allclose(map_t.quaternions, map_j.quaternions, atol=1e-3)
    gt = np.stack([seq.pose(k)[1] - seq.pose(0)[1] for k in range(5)])
    assert np.max(np.abs(map_t.positions - gt)) < 0.05


def test_full_pipeline_dense_search_matches_windowed(slam_runs):
    """windowed_nn=False takes kernel K5: within the 1 m gates the dense and
    windowed searches find the same neighbours, handed to the GN in the same
    order, so the poses are the same."""
    _, (_, map_t), (_, map_d) = slam_runs
    np.testing.assert_array_equal(map_d.positions, map_t.positions)
    np.testing.assert_array_equal(map_d.quaternions, map_t.quaternions)


def test_map_skip_2_composes_correction(corridor):
    """map_skip ≥ 2 maps frames whose global index is a multiple of it; a
    frame in between is the carried correction (mapped ∘ odometry⁻¹ of the
    last mapped frame) composed with its odometry pose. Frames 1-2 map every
    frame, then frames 3-4 run with map_skip=2 from index 3."""
    _, scans = corridor
    cfg = _configs()[1]
    lcfg = cfg.lidar
    geom = dict(n_scans=64, width=1024, min_range=lcfg.min_range, max_range=lcfg.max_range)
    xyz0, mask0 = pc.pad_points(scans[0], 131072)
    odo = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device="cpu").features)
    mp = dm.init_state(cfg.mapping, "cpu")
    odo, mp, op1, mp1 = dm.slam_chunk_polar(
        odo, mp, pc.pack_polar_chunk(scans[1:3], channels=1, **geom), lcfg, cfg.odometry,
        cfg.mapping, start_idx=1, map_skip=1, device="cpu")
    corr = mp.correction
    _, mp_after, op2, mp2 = dm.slam_chunk_polar(
        odo, mp, pc.pack_polar_chunk(scans[3:5], channels=1, **geom), lcfg, cfg.odometry,
        cfg.mapping, start_idx=3, map_skip=2, device="cpu")
    want = se3.se3_compose(corr, se3.Pose(op2.q[0], op2.t[0]))           # frame 3
    np.testing.assert_array_equal(mp2.t[0].numpy(), want.t.numpy())
    np.testing.assert_array_equal(mp2.q[0].numpy(), want.q.numpy())
    assert float((corr.t.abs()).max()) > 1e-4               # a correction, not the identity
    # the correction refined at frame 2 is mapped(2) ∘ odometry(2)⁻¹
    refit = se3.se3_compose(se3.Pose(mp1.q[1], mp1.t[1]),
                            se3.se3_inverse(se3.Pose(op1.q[1], op1.t[1])))
    np.testing.assert_allclose(refit.t.numpy(), corr.t.numpy(), atol=1e-5)
    # frame 4 is mapped: a new correction
    assert not torch.equal(mp_after.correction.t, corr.t)


def test_full_pipeline_map_skip_2(corridor):
    """The same rule through FullPipeline: frame 2, the first mapped frame,
    meets an empty map (zero step), so frames 1-3 keep their odometry poses;
    frame 4 is refined."""
    _, scans = corridor
    odo, mapped = FullPipeline(_configs()[1], device="cpu").run_chunked(
        scans, chunk=3, map_skip=2, ingest="polar2")
    np.testing.assert_allclose(mapped.positions[:4], odo.positions[:4], atol=1e-6)
    assert not np.allclose(mapped.positions[4], odo.positions[4], atol=1e-6)


def test_full_pipeline_cuda_and_unported_options_raise(monkeypatch, corridor):
    """device="cuda" (the default) raises without a card, and the parts of
    FullPipeline outside this slice say so."""
    _, scans = corridor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.SystemConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FullPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.init_state(cfg.mapping)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.device_map_state_from_numpy({})
    with pytest.raises(NotImplementedError, match="A.7"):
        FullPipeline(cfg, device_map=False, device="cpu")
    pipe = FullPipeline(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        pipe.run(scans)
    with pytest.raises(NotImplementedError, match="A.7"):
        pipe.run_chunked(scans, checkpoint_path="x.npz", checkpoint_every=8)
    with pytest.raises(NotImplementedError, match="uint16"):
        pipe.run_chunked(scans, ingest="uint16")
