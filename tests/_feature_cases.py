"""Inputs for the feature selection's tests, in numpy alone (no JAX, no
torch), so that the CPU tests against the JAX package and the card tests of
the kernel against its plain version share them.

``crafted_scan(case, W)`` builds a compacted scan of 8 rings whose geometry
forces one behaviour of the greedy selection; coordinates are multiples of
1/8 m, so every curvature and gap is exact in float32 and equal curvatures
are equal bit for bit. ``selection_inputs(case, R, W, rng)`` builds the
selection's own inputs directly, including values no scan gives (NaN, ±inf,
−0, curvatures equal to the gate, reaches and counts out of range).
"""

from __future__ import annotations

import numpy as np

CRAFTED = ("short_rings", "empty_sector", "wrong_side_of_gate", "equal_curvatures",
           "across_sector_boundary", "gaps_stop_suppression", "non_default")
SELECTION = ("random", "ties_and_gate", "nan_inf_zero", "wild_reaches", "wild_counts")

#: extract_features' keyword arguments of the "non_default" case
NON_DEFAULT = dict(n_sectors=4, max_sharp=1, max_less_sharp=7, max_flat=2, edge_gate=0.05,
                   surf_gate=0.25, max_less_flat_per_ring=64)


def line(n):
    """A straight run 1/8 m apart: every curvature 0, every gap 1/64 m²."""
    i = np.arange(n)
    return np.stack([4.0 + 0.125 * i, np.full(n, 2.0), np.full(n, 0.5)], -1)


def zigzag(n, step):
    """Alternating offsets of ``step`` across a run ``step`` apart: every
    interior curvature (6·step)² (equal), every gap 2·step²."""
    i = np.arange(n)
    return np.stack([4.0 + step * i, 2.0 + step * (i % 2), np.full(n, 0.5)], -1)


def noisy(n, rng, jump_every=0):
    """A curve with 1/8-m noise; a 1-m jump (a gap that stops suppression)
    every ``jump_every`` points when set."""
    i = np.arange(n)
    x = 4.0 + 0.125 * i + np.round(rng.normal(size=n) * 0.5) * 0.125
    y = 2.0 + np.round(8 * np.sin(i / 17.0)) * 0.125 + rng.integers(0, 2, n) * 0.125
    if jump_every:
        y = y + (i // jump_every) * 1.0
    return np.stack([x, y, np.full(n, 0.5)], -1)


def _scan(rings, W, holes=()):
    """Rings (each (n, 3), n ≤ W) into a (8, W) compacted scan; ``holes``:
    (ring, start, stop) ranges marked not valid."""
    R = len(rings)
    xyz = np.zeros((R, W, 3), np.float32)
    valid = np.zeros((R, W), bool)
    count = np.zeros(R, np.int32)
    for r, pts in enumerate(rings):
        n = len(pts)
        xyz[r, :n] = pts
        valid[r, :n] = True
        count[r] = n
    for r, a, b in holes:
        valid[r, a:b] = False
    rel_time = (np.arange(W, dtype=np.float32) / W)[None, :].repeat(R, 0)
    return dict(xyz=xyz, valid=valid, rel_time=rel_time, count=count)


def crafted_scan(case, W, seed=0):
    """(scan dict, extract_features keyword arguments) of one case."""
    rng = np.random.default_rng(seed)
    n = W - 16
    if case == "short_rings":
        rings = [zigzag(c, 0.125) for c in (0, 5, 11, 12, 16, 17, 18)] + [noisy(25, rng)]
        return _scan(rings, W), {}
    if case == "empty_sector":
        # rings 0-1: 20 corners ~6 apart over-fill sectors of ~(n-11)/6 points,
        # so the last steps of each find nothing; ring 2: count 17, six
        # one-point sectors, the first corner clears the next five; ring 3:
        # a sector's points all not valid
        rings = [zigzag(n, 0.125), zigzag(n // 2, 0.125), zigzag(17, 0.125),
                 noisy(n, rng), zigzag(n, 0.25), line(n), noisy(n // 3, rng), zigzag(40, 0.125)]
        span = n - 11
        return _scan(rings, W, holes=[(3, 5 + span // 6, 5 + 2 * span // 6)]), {}
    if case == "wrong_side_of_gate":
        # straight runs: no corner passes 0.1 (each sector repeats its first
        # point, not ok); zigzags of curvature 2.25: no flat passes
        rings = [line(n), line(n // 2), zigzag(n, 0.25), zigzag(n // 2, 0.25)] * 2
        return _scan(rings, W), {}
    if case == "equal_curvatures":
        # every interior curvature 2.25 (corners) or 0 (flats): the lowest index wins
        rings = [zigzag(n, 0.25), line(n), zigzag(n - 3, 0.25), line(n - 5),
                 zigzag(n, 0.125), zigzag(n - 7, 0.125), line(17), zigzag(30, 0.25)]
        return _scan(rings, W), {}
    if case == "across_sector_boundary":
        # curvature 0.5625 everywhere, gaps 1/32 m²: each corner clears ±5,
        # so a sector's last corner clears the next sector's first points
        rings = [zigzag(c, 0.125) for c in (n, n - 1, n - 2, n - 3, n - 5, n - 8, n // 2, 100)]
        return _scan(rings, W), {}
    if case == "gaps_stop_suppression":
        rings = [noisy(n, rng, jump_every=k) for k in (2, 3, 4, 5, 6, 7, 9, 13)]
        return _scan(rings, W), {}
    if case == "non_default":
        rings = [noisy(n, rng), noisy(n, rng, 6), zigzag(n, 0.125), zigzag(n, 0.25), line(n),
                 noisy(n // 2, rng), noisy(40, rng, 3), zigzag(17, 0.125)]
        return _scan(rings, W), dict(NON_DEFAULT)
    raise ValueError(case)


def selection_inputs(case, R, W, rng):
    """(curv, avail, reach_l, reach_r, count) of one direct case: float32,
    bool, int32, int32, int32."""
    curv = rng.exponential(0.2, (R, W)).astype(np.float32)
    avail = rng.uniform(size=(R, W)) < 0.85
    reach_l = rng.integers(0, 6, (R, W)).astype(np.int32)
    reach_r = rng.integers(0, 6, (R, W)).astype(np.int32)
    count = rng.integers(0, W + 1, R).astype(np.int32)
    count[:4] = [0, 16, 17, W][: min(4, R)]
    if case == "ties_and_gate":
        levels = np.array([0.0, -0.0, 0.05, np.float32(0.1), 0.2, 1.0, 1.0], np.float32)
        curv = levels[rng.integers(0, len(levels), (R, W))]
    elif case == "nan_inf_zero":
        specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30, -3e30, 3e30],
                            np.float32)
        pick = rng.uniform(size=(R, W)) < 0.05
        curv[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    elif case == "wild_reaches":
        big = np.array([-W - 7, -W, -3, -1, W, W + 9, 2**31 - 1, -2**31], np.int64)
        for reach in (reach_l, reach_r):
            pick = rng.uniform(size=(R, W)) < 0.1
            reach[pick] = big[rng.integers(0, len(big), int(pick.sum()))].astype(np.int32)
    elif case == "wild_counts":
        count = rng.choice(np.array([-5, 0, 11, 12, 16, 17, 23, W - 1, W, W + 1, 2 * W, 5000],
                                    np.int32), R)
    elif case != "random":
        raise ValueError(case)
    return curv, avail, reach_l, reach_r, count
