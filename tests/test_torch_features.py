"""The port's feature selection (``kernels/features.py``, reached through
``ops/features.extract_features``) against the JAX package's
``extract_features`` on the CPU, on rendered scans at three widths and on
crafted rings that force each behaviour of the greedy picks. On the CPU the
wrapper runs its plain version; ``tests/test_torch_cuda.py`` holds the kernel
to it on the card, on the same cases."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _feature_cases import CRAFTED, crafted_scan

from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.ops import features as jF
from lidar_visual_odometry_tpu.ops import pointcloud as jpc
from lidar_visual_odometry_tpu_torch import kernels
from lidar_visual_odometry_tpu_torch.kernels import features as K
from lidar_visual_odometry_tpu_torch.ops import features as F
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc

torch.set_num_threads(2)

CRAFTED_W = 256


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same_features(scan, kw):
    """extract_features of both packages on one compacted scan: the same
    picked points, rings, times and masks; the less-flat cloud's mask equal
    and its centroids within 1e-5 m (test_torch_ops' rule)."""
    arrays = (scan["xyz"], scan["valid"], scan["rel_time"], scan["count"])
    want = jax.jit(partial(jF.extract_features, **kw))(jpc.CompactScan(*map(jnp.asarray, arrays)))
    got = F.extract_features(pc.CompactScan(*map(_t, arrays)), **kw)
    for name in ("sharp", "less_sharp", "flat"):
        g, w = getattr(got, name), getattr(want, name)
        for field in ("mask", "xyz", "ring", "rel_time"):
            np.testing.assert_array_equal(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
                                          err_msg=f"{name}.{field}")
    np.testing.assert_array_equal(got.less_flat.mask.numpy(), np.asarray(want.less_flat.mask))
    np.testing.assert_allclose(got.less_flat.xyz.numpy(), np.asarray(want.less_flat.xyz),
                               atol=1e-5)
    return got


def _selection(scan, kw):
    """The port's selection outputs and its inputs, on the CPU."""
    cs = pc.CompactScan(*map(_t, (scan["xyz"], scan["valid"], scan["rel_time"], scan["count"])))
    curv, eligible = F.curvature(cs)
    reach_l, reach_r = F._suppression_reach(cs)
    sel = {k: kw.get(k, v) for k, v in dict(n_sectors=6, max_less_sharp=20, max_flat=4,
                                             edge_gate=0.1, surf_gate=0.1).items()}
    out = K.select_features(curv, eligible & cs.valid, reach_l, reach_r, cs.count, **sel)
    bounds = [K.sector_bounds(cs.count, sel["n_sectors"], j) for j in range(sel["n_sectors"])]
    sp = torch.stack([b[0] for b in bounds], 1).numpy()
    return [o.numpy() for o in out], sp, reach_r.numpy()


@pytest.mark.parametrize("W", [600, 1024, 2048])
def test_extract_features_matches_jax_on_rendered_scans(W):
    seq = jsyn.SyntheticSequence(n_frames=2, width=1800 if W == 2048 else 600, noise=0.005)
    pts = seq.scan(1)
    build = jax.jit(partial(jpc.build_compact_scan, n_scans=64, width=W, min_range=0.1,
                            max_range=120.0))
    cs = build(jnp.asarray(pts), jnp.ones(len(pts), bool))
    scan = dict(zip(("xyz", "valid", "rel_time", "count"), map(np.asarray, cs)))
    got = _assert_same_features(scan, {})
    assert int(got.sharp.mask.sum()) > 100 and int(got.flat.mask.sum()) > 100


@pytest.mark.parametrize("case", CRAFTED)
def test_extract_features_matches_jax_on_crafted_rings(case):
    """Each case also checks that its behaviour happens in the picks."""
    scan, kw = crafted_scan(case, CRAFTED_W)
    _assert_same_features(scan, kw)
    (cp, cok, fp, fok, label), sp, reach_r = _selection(scan, kw)
    count = scan["count"]
    if case == "short_rings":
        assert not cok[count < 17].any() and not fok[count < 17].any()
        assert (cp[count < 17] == 0).all() and cok[count >= 17].any()
    elif case == "empty_sector":
        # a sector with no available point left: pick 0, not ok, on eligible rings
        assert ((cp == 0) & ~cok)[count >= 17].any() and ((fp == 0) & ~fok)[count >= 17].any()
        assert not cok[3, 1].any() and (cp[3, 1] == 0).all()     # the invalid sector
    elif case == "wrong_side_of_gate":
        # no corner of a straight run passes: the sector's first point, repeated
        assert not cok[0].any() and (cp[0] == sp[0][:, None]).all()
        assert not fok[2].any() and (fp[2] > 0).all()
    elif case == "equal_curvatures":
        # curvature 2.25 on every interior point, no suppression past the pick
        first = sp[0, 0]
        np.testing.assert_array_equal(cp[0, 0], first + np.arange(20))
        np.testing.assert_array_equal(fp[1, 0], sp[1, 0] + 6 * np.arange(4))
    elif case == "across_sector_boundary":
        assert (cp[:, 1:, 0] > sp[:, 1:]).any()
    elif case == "gaps_stop_suppression":
        picked = reach_r[np.arange(len(count))[:, None, None], cp][cok]
        assert ((picked > 0) & (picked < 5)).any() and (picked == 0).any()
    elif case == "non_default":
        assert cp.shape == (8, 4, 7) and fp.shape == (8, 4, 2) and cok.any() and fok.any()
    assert label.dtype == np.int8 and set(np.unique(label)) <= {0, 1}
    assert label.sum() == len(set(zip(*np.nonzero(cok)[:1], cp[cok])))


def test_cpu_tensors_run_the_plain_version():
    scan, kw = crafted_scan("across_sector_boundary", CRAFTED_W)
    kernels.reset_launch_counts()
    out, _, _ = _selection(scan, kw)
    assert kernels.launch_counts()["feature_select"] == 0
    cs = pc.CompactScan(*map(_t, (scan["xyz"], scan["valid"], scan["rel_time"], scan["count"])))
    curv, eligible = F.curvature(cs)
    reach_l, reach_r = F._suppression_reach(cs)
    plain = K.select_features_plain(curv, eligible & cs.valid, reach_l, reach_r, cs.count,
                                    n_sectors=6, max_less_sharp=20, max_flat=4, edge_gate=0.1,
                                    surf_gate=0.1)
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b.numpy())
    assert kernels.launch_counts()["feature_select"] == 0
