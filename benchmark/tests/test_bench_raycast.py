"""The benchmark's traffic generator: the device raycaster against a
brute-force ray-box loop, and the same inputs from the same seed."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import spec, traffic_gen


def _brute(origin, d, boxes, max_range=math.inf):
    best = math.inf
    for lo, hi in boxes:
        t0, t1 = -math.inf, math.inf
        for a in range(3):
            if abs(d[a]) < 1e-12:
                if origin[a] < lo[a] or origin[a] > hi[a]:
                    break
                continue
            ta, tb = (lo[a] - origin[a]) / d[a], (hi[a] - origin[a]) / d[a]
            t0, t1 = max(t0, min(ta, tb)), min(t1, max(ta, tb))
        else:
            if t1 >= t0 and t0 > 0:
                best = min(best, t0)
    if d[2] < -1e-9:
        best = min(best, -origin[2] / d[2])
    return best


def test_raycaster_agrees_with_brute_force():
    traffic = spec.traffic("city_x8")
    boxes, R, t = traffic_gen.sequence(traffic, 2147483695, 0)
    dirs = traffic_gen.ray_dirs(24, "cpu") @ torch.as_tensor(R[5]).T
    hit = traffic_gen.ray_hits(torch.as_tensor(t[5]), dirs, torch.as_tensor(boxes),
                               box_chunk=7).numpy()
    for i in range(0, dirs.shape[0], 5):
        want = _brute(t[5], dirs[i].numpy(), boxes)
        assert (np.isinf(hit[i]) and np.isinf(want)) or abs(hit[i] - want) < 1e-9, i


def test_same_seed_same_scans_and_every_seed_the_same_structure():
    traffic = spec.traffic("city_x8")
    traffic["sensor"]["azimuth_steps"] = 90
    a = traffic_gen.render(traffic, *traffic_gen.sequence(traffic, 2**31 + 5, 3)[:1],
                           *[x[:2] for x in traffic_gen.sequence(traffic, 2**31 + 5, 3)[1:]],
                           2**31 + 5, 3, "cpu")
    b = traffic_gen.render(traffic, *traffic_gen.sequence(traffic, 2**31 + 5, 3)[:1],
                           *[x[:2] for x in traffic_gen.sequence(traffic, 2**31 + 5, 3)[1:]],
                           2**31 + 5, 3, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == np.float32 and a[0].shape[1] == 3
    for seed in (1, 2**31 + 9, 10**12):
        _boxes, R, t = traffic_gen.sequence(traffic, seed, 0)
        assert len(t) == traffic["frames_per_sequence"]
        yaw = np.degrees(np.arctan2(R[:, 1, 0], R[:, 0, 0]))
        assert abs(abs(yaw[-1]) - 90.0) < 1e-6 and abs(yaw[0]) < 1e-9    # one 90° turn
        step = np.linalg.norm(np.diff(t, axis=0), axis=1)
        lo, hi = traffic["route"]["speed_m_per_frame"]
        assert step.min() > 0.95 * lo and step.max() < 1.0001 * hi
