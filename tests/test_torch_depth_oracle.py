"""The float64 oracle of ``associate_depth`` (``tools/camera_step_diff.depth_oracle``)
and the port's ``associate_depth`` on inputs where the answer is exact.

The oracle judges each package's lidar depths on the bench corridor (ROADMAP
C.7), so it is held to closed forms first. On planes whose points lie on a
1/8 grid, at depths 4 and 5 (so the 10-plane coordinates 10·x/z and the
metric points recovered from them are exact in float32 and float64), the
oracle's depth must equal the ray-plane intersection computed in rationals
within ``ORACLE_TOL`` (relative), and the port's float32 determinant within
``PORT_TOL_M``, two float32 ulps of a 5 m depth (measured: at most 2.2e-7 m
over these planes; on the corridor's lidar planes the same determinant
cancels far more, ``tools/camera_step_diff.py --corridor``). The oracle's brute-force 3-NN
must agree with a list of every candidate sorted by (exact distance,
index)."""

import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from camera_step_diff import depth_oracle  # noqa: E402

ORACLE_TOL = 1e-12
PORT_TOL_M = 1e-6
N_PLANES = 48
CLOUD = 512


def _planes(seed: int = 0):
    """``N_PLANES`` triangles, each in its own cell of the image (0.25 apart
    in normalized coordinates): vertices projecting near (cu, cv), (cu +
    1/16, cv), (cu, cv + 1/16) at depths 4 or 5 with x and y rounded to the
    1/8 grid, and a query at (cu + 1/64, cv + 1/64), inside the triangle.
    Returns the queries (N, 2), the cloud (plane10, z, mask) padded with
    masked points to ``CLOUD``, and each query's vertices in rationals."""
    rng = np.random.default_rng(seed)
    un, pts, exact = [], [], []
    for i in range(N_PLANES):
        cu, cv = Fraction(i % 8 - 4, 4), Fraction(i // 8 - 3, 4)
        verts = []
        for du, dv in ((0, 0), (Fraction(1, 16), 0), (0, Fraction(1, 16))):
            z = int(rng.integers(4, 6))
            x = Fraction(round((cu + du) * z * 8), 8)
            y = Fraction(round((cv + dv) * z * 8), 8)
            verts.append((x, y, Fraction(z)))
        un.append((cu + Fraction(1, 64), cv + Fraction(1, 64)))
        pts += verts
        exact.append(verts)
    plane10 = np.full((CLOUD, 3), 1e6, np.float32)
    z = np.ones(CLOUD, np.float32)
    mask = np.zeros(CLOUD, bool)
    for j, (x, y, zz) in enumerate(pts):
        plane10[j] = (float(10 * x / zz), float(10 * y / zz), 10.0)
        z[j] = float(zz)
        mask[j] = True
    assert all(Fraction(float(p[k])) == 10 * c / zz for (x, y, zz), p in zip(pts, plane10)
               for k, c in enumerate((x, y)))          # the 10-plane is exact
    return np.asarray(un, np.float32), (plane10, z, mask), exact, un


def _exact_depth(verts, u, v):
    """The ray (u, v, 1)'s depth where it meets the vertices' plane."""
    (a, b, c) = verts
    e1 = [b[k] - a[k] for k in range(3)]
    e2 = [c[k] - a[k] for k in range(3)]
    n = (e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0])
    return (n[0] * a[0] + n[1] * a[1] + n[2] * a[2]) / (n[0] * u + n[1] * v + n[2])


@pytest.fixture(scope="module")
def planes():
    return _planes()


def test_oracle_equals_the_exact_intersection(planes):
    un, cloud, exact, un_exact = planes
    depth, ok, idx = depth_oracle(un, np.ones(len(un), bool), *cloud)
    assert ok.all()
    for i, verts in enumerate(exact):
        assert list(idx[i]) == [3 * i, 3 * i + 1, 3 * i + 2]
        want = _exact_depth(verts, *un_exact[i])
        assert abs(depth[i] - float(want)) <= ORACLE_TOL * float(want), (i, depth[i], want)


def test_port_equals_the_oracle_within_float32(planes):
    un, cloud, exact, _ = planes
    want, want_ok, _ = depth_oracle(un, np.ones(len(un), bool), *cloud)
    dc = vf.DepthCloud(*(torch.from_numpy(x) for x in cloud))
    got, ok = vf.associate_depth(torch.from_numpy(un), torch.ones(len(un), dtype=torch.bool), dc)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PORT_TOL_M)


@pytest.mark.parametrize("seed", [1, 2])
def test_oracle_nn_agrees_with_a_sorted_list(seed):
    rng = np.random.default_rng(seed)
    M, Q = 300, 40
    plane10 = np.concatenate([rng.uniform(-3, 3, (M, 2)), np.full((M, 1), 10.0)],
                             axis=1).astype(np.float32)
    plane10[::7, :2] = plane10[1::7, :2][: len(plane10[::7])]      # exact ties
    z = rng.uniform(2, 30, M).astype(np.float32)
    mask = rng.random(M) > 0.2
    un = rng.uniform(-0.3, 0.3, (Q, 2)).astype(np.float32)
    _, _, idx = depth_oracle(un, np.ones(Q, bool), plane10, z, mask)
    for i in range(Q):
        q = [Fraction(10 * float(un[i, 0])), Fraction(10 * float(un[i, 1])), Fraction(10)]
        ranked = sorted((sum((Fraction(float(plane10[j, k])) - q[k]) ** 2 for k in range(3)), j)
                        for j in range(M) if mask[j])
        assert list(idx[i]) == sorted(j for _, j in ranked[:3]), i
