#!/usr/bin/env python
"""Scaling of the distributed stages over ranks, on the PyTorch port.

The port's counterpart of ``scripts/bench_scaling.py``, with its fixtures: the
psum-reduced odometry Gauss-Newton (``sharded_scan_to_scan``, frame 1's
features against frame 0's of a 2-frame synthetic sequence at width 1200,
``LidarConfig(azimuth_bins=1024)``, ``OdometryConfig(outer_iters=5,
gn_iters=4)``), the submap-sharded mapping step (``sharded_mapping_step``,
frame 0's features as the local map, ``MappingConfig(outer_iters=2,
gn_iters=4)``) and the points-sharded window BA (``sharded_refine``, 5
keyframes of random 256 × 128 images, 4096 points each, 4 iterations at
level 0), and the BA's weak-scaling row with 4096·D points (drawn from the
JAX script's generator in its order, so every D gets the JAX script's
points).

Each fleet is ``parallel.launch``'s: D rank processes, each building the
fixtures on its device and timing every stage after a warm run (CUDA-event
time a rep on the card, the wall clock on the CPU; the collectives keep the
ranks in step). On the card one rank runs on NCCL and two on gloo (NCCL
refuses two ranks on one card); four ranks run, on NCCL, only where four
cards are present. ``--device cpu`` runs gloo fleets on the CPU. Nothing falls
back to the CPU on its own.

Prints one JSON row a fleet with the JAX script's keys (``devices``,
``odometry_ms``, ``mapping_ms``, ``ba_ms``, ``ba_weak_ms`` and the
``*_eff`` keys: speed-up over one rank, per rank) and, beside them, each
stage's largest pose difference from the one-rank run (``*_vs_1_rank``; the
ranks sum in float64, so odometry and mapping should give one rank's bits),
each stage's translation (``*_t``), the largest difference between the
fleet's ranks, the backend and the kernel launches of the fleet's rank 0. The last line is the list of rows. It
writes no file.

Usage:
    python scripts/bench_scaling_torch.py                     # on the card
    python scripts/bench_scaling_torch.py --device cpu --reps 0   # one cold call a stage
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

STAGES = ("odometry", "mapping", "ba", "ba_weak")
K_FRAMES, POINTS, LEVEL, BA_ITERS = 5, 4096, 0, 4


def _fixtures(mesh):
    """The JAX script's fixtures on ``mesh.device``: the registered features
    of the two frames, the BA camera, pyramids, points and poses, and the
    weak-scaling points for ``mesh.size`` ranks."""
    import torch

    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
    from lidar_visual_odometry_tpu_torch.ops import camera, se3
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.config import LidarConfig

    dev = mesh.device
    seq = synthetic.SyntheticSequence(n_frames=2, width=1200, noise=0.01)
    cfg = LidarConfig(azimuth_bins=1024)
    regs = [sr.register_scan(*pc.pad_points(seq.scan(k), 131072), cfg, dev) for k in range(2)]
    rng = np.random.default_rng(0)
    cam = camera.Pinhole(240.0, 240.0, 128.0, 64.0, 256, 128, torch.zeros(5, device=dev))
    pyrs = tuple(torch.from_numpy(rng.random((K_FRAMES, 128 >> lvl, 256 >> lvl))
                                  .astype(np.float32)).to(dev) for lvl in range(2))

    def points(n):
        return torch.from_numpy(np.stack([rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]
                                          for _ in range(K_FRAMES)]).astype(np.float32)).to(dev)

    ba_pts = points(POINTS)
    ba_poses = se3.Pose(
        torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(K_FRAMES, 1),
        torch.from_numpy(rng.normal(scale=0.05, size=(K_FRAMES, 3)).astype(np.float32)).to(dev))
    n = 1
    while True:     # the JAX script draws the weak points for D = 1, 2, 4, ... in turn
        weak = points(POINTS * n)
        if n >= mesh.size:
            break
        n *= 2
    return regs, cam, pyrs, ba_pts, ba_poses, weak


def rank_stages(mesh, inputs):
    """Every stage on one rank of a ``parallel.launch`` fleet: each stage's
    pose and its time a rep (ms) after one warm run (``reps`` 0: the one
    run, cold), and the kernel launches of the whole run."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.models.lidar_mapping import LocalMap
    from lidar_visual_odometry_tpu_torch.ops import se3
    from lidar_visual_odometry_tpu_torch.ops.pointcloud import PointBatch
    from lidar_visual_odometry_tpu_torch.parallel import sharded_ba, sharded_mapping
    from lidar_visual_odometry_tpu_torch.parallel import sharded_odometry as so
    from lidar_visual_odometry_tpu_torch.utils.config import MappingConfig, OdometryConfig

    reps = int(inputs["reps"])
    dev = mesh.device
    cuda = dev.type == "cuda"
    regs, cam, pyrs, ba_pts, ba_poses, weak = _fixtures(mesh)
    ocfg = OdometryConfig(outer_iters=5, gn_iters=4)
    mcfg = MappingConfig(outer_iters=2, gn_iters=4)
    f0, f1 = regs[0].features, regs[1].features
    local = LocalMap(PointBatch(f0.less_sharp.xyz, f0.less_sharp.mask),
                     PointBatch(f0.less_flat.xyz, f0.less_flat.mask))
    ident = se3.identity_pose(dev)
    runs = {
        "odometry": lambda: so.sharded_scan_to_scan(mesh, f1, f0.less_sharp, f0.less_flat,
                                                    ident, ocfg),
        "mapping": lambda: sharded_mapping.sharded_mapping_step(
            mesh, f1.less_sharp.xyz, f1.less_sharp.mask, f1.less_flat.xyz, f1.less_flat.mask,
            local, ident, mcfg),
        "ba": lambda: sharded_ba.sharded_refine(
            mesh, pyrs, ba_pts, torch.ones(ba_pts.shape[:2], dtype=torch.bool, device=dev),
            ba_poses, cam, n_iters=BA_ITERS, level=LEVEL),
        "ba_weak": lambda: sharded_ba.sharded_refine(
            mesh, pyrs, weak, torch.ones(weak.shape[:2], dtype=torch.bool, device=dev),
            ba_poses, cam, n_iters=BA_ITERS, level=LEVEL),
    }

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(run, n):
        """(the last result, ms a call) of ``n`` calls."""
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                res = run()
            end.record()
            sync()
            return res, start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            res = run()
        return res, (time.perf_counter() - t0) / n * 1e3

    out = {}
    sync()
    kernels.reset_launch_counts()
    for name, run in runs.items():
        if reps:
            run()       # the warm run
            sync()
        pose, ms = timed(run, max(reps, 1))
        out.update({f"{name}_q": pose.q, f"{name}_t": pose.t, f"{name}_ms": np.float64(ms)})
    counts = kernels.launch_counts()
    out["launch_names"] = np.array(list(counts))
    out["launches"] = np.array(list(counts.values()), np.int64)
    return out


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def fleet_sizes(device: str) -> list[int]:
    """1 and 2 ranks; 4 where four cards are present."""
    import torch

    sizes = [1, 2]
    if device == "cuda" and torch.cuda.device_count() >= 4:
        sizes.append(4)
    return sizes


def backend_for(device: str, ranks: int) -> str:
    """NCCL on the card while each rank has a card of its own, else gloo."""
    import torch

    if device == "cuda" and ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls a stage after a warm one (0: one cold call, timed)")
    ap.add_argument("--ranks", default=None,
                    help="fleet sizes, e.g. 1,2 (default: 1 and 2, and 4 on four cards)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Runs each fleet; prints a row a fleet and the list of rows last, and
    returns the rows."""
    from lidar_visual_odometry_tpu_torch.parallel import launch
    from lidar_visual_odometry_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device).type
    sizes = ([int(x) for x in args.ranks.split(",")] if args.ranks else fleet_sizes(device))
    if sizes[0] != 1:
        raise SystemExit("the first fleet must be one rank: the others are held to it")
    target = f"{os.path.abspath(__file__)}:rank_stages"
    rows, first = [], None
    for n in sizes:
        backend = backend_for(device, n)
        t0 = time.perf_counter()
        ranks = launch.launch(target, n, {"reps": np.int64(args.reps)}, backend=backend,
                              device=device)
        r = ranks[0]
        first = first or r
        row = {"devices": n}
        row.update({f"{s}_ms": float(r[f"{s}_ms"]) for s in STAGES})
        row.update({f"{s}_vs_1_rank": max(_diff(r[f"{s}_q"], first[f"{s}_q"]),
                                          _diff(r[f"{s}_t"], first[f"{s}_t"]))
                    for s in STAGES if s != "ba_weak"})
        row.update({f"{s}_t": r[f"{s}_t"].tolist() for s in STAGES})
        row["ranks_agree"] = max((_diff(o[k], r[k]) for o in ranks[1:] for k in r
                                  if k.endswith(("_q", "_t"))), default=0.0)
        row["slowest_rank_ms"] = {s: max(float(o[f"{s}_ms"]) for o in ranks) for s in STAGES}
        row["backend"] = backend
        row["launches"] = {str(k): int(v) for k, v in zip(r["launch_names"], r["launches"]) if v}
        row["fleet_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    for key in ("odometry_ms", "mapping_ms", "ba_ms"):
        base = rows[0][key]
        for r in rows:
            r[key.replace("_ms", "_eff")] = base / r[key] / r["devices"]
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
