"""The plain reference: it recovers a tiny drive's ground-truth motion, and
its control (TF32 matrix products) misses what the float64 check holds."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import traffic_gen
from benchmark.entries import lidar_odometry
from benchmark.reference import aloam
from benchmark.tests.small import small_config, small_traffic


def _drive(n=4, seed=2147483697, stream=1):
    traffic = small_traffic()
    boxes, R, t = traffic_gen.sequence(traffic, seed, stream)
    return traffic_gen.render(traffic, boxes, R[:n], t[:n], seed, stream, "cpu"), R[:n], t[:n]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0], dtype=torch.float32)
    assert aloam.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]


def test_reference_recovers_the_ground_truth_motion():
    """At this tiny size (450 rays a ring, 512 columns) a frame's motion of
    about 1.1 m comes out within 2-7 cm; a broken solve misses by a metre."""
    scans, R, t = _drive()
    cfg = small_config("aloam_hdl64_odom")
    L, O, _ = lidar_odometry.settings(cfg)
    q, p = aloam.odometry_chain(aloam.FLOAT64, aloam.sequence_features(scans, L, aloam.FLOAT64), O)
    errs = []
    for k in range(1, len(scans)):
        gt = R[k - 1].T @ (t[k] - t[k - 1])
        rel = aloam.compose(aloam.inverse((q[k - 1], p[k - 1])), (q[k], p[k]))
        errs.append(np.linalg.norm(rel[1].numpy() - gt))
        assert aloam.rotation_angle(rel[0], torch.tensor([1.0, 0, 0, 0], dtype=rel[0].dtype)) < 0.01
    assert max(errs) < 0.08 and np.median(errs) < 0.04, errs


def test_control_fails_where_the_check_holds():
    """The reference in the program's place, in float32 with TF32 matrix
    products, against its own float64 check: some gap over its limit."""
    scans, _R, _t = _drive(n=5)
    cfg = small_config("aloam_hdl64_odom")
    out = lidar_odometry.control(scans, cfg, aloam.control_arith("cpu"))
    checks = lidar_odometry.check(scans, out, cfg, aloam.FLOAT64, [1, 2, 3, 4])
    assert checks["frames_ok"]
    assert any(max(checks[k.partition(".")[0]]) > lim for k, lim in cfg["limits"].items())
    sound = lidar_odometry.control(scans, cfg, aloam.FLOAT64)
    checks = lidar_odometry.check(scans, sound, cfg, aloam.FLOAT64, [1, 2, 3, 4])
    assert all(max(checks[k.partition(".")[0]]) <= lim for k, lim in cfg["limits"].items())
