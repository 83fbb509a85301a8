#!/usr/bin/env python
"""Long-horizon fused-SLAM stress on the PyTorch port.

The port's counterpart of ``scripts/stress_long.py``, with the same drive,
the same flags and report keys, and ``--device`` (default ``cuda``) in place
of ``--cpu``. A 500+-frame multi-lap drive through the corridor (each lap
revisits the same ground, with two 180-degree U-turns) through the fused SLAM
path (mapping every frame, the polar2 ingest):

* map-cap eviction across revisits (occupancy at the caps),
* steady-state frames/s excluding the frame-0 bootstrap and the first chunk,
* a mid-run snapshot of the odometry and map states, written to an npz,
  read back into fresh tensors and resumed, which must reproduce the
  uninterrupted trajectory bit for bit.

Each chunk is packed by the native packer (``data/native_pack.py``, only the
real frames) and run by ``models/device_mapping.slam_chunk_polar``. Scans are
rendered in threads with numpy's BLAS held to one thread (several BLAS
threads under several Python threads have corrupted renders) and cached
beside the repo in the ``.stress_scans_*`` file that ``scripts/stress_long.py``
reads and writes.

Usage:
    python scripts/stress_long_torch.py [--laps 4] [--leg 50] [--turn 14]
    python scripts/stress_long_torch.py --device cpu --laps 1 --leg 2 --turn 2 --width 600
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Set before numpy is first imported (see above).
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from lidar_visual_odometry_tpu_torch.data import native_pack, synthetic  # noqa: E402
from lidar_visual_odometry_tpu_torch.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu_torch.models import device_mapping as dm  # noqa: E402
from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo  # noqa: E402
from lidar_visual_odometry_tpu_torch.models import scan_registration as sr  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import se3  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.device import resolve_device  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--leg", type=int, default=50)
    ap.add_argument("--turn", type=int, default=14)
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-resume-check", action="store_true")
    return ap.parse_args(argv)


def drive(args) -> synthetic.PiecewiseArcSequence:
    """``stress_long.py``'s multi-lap out-and-back: leg, U-turn, leg, U-turn,
    ``laps`` times; every lap re-traverses the same corridor segment."""
    lap = (
        (args.leg, 1.0, 0.0),
        (args.turn, 0.6, np.pi / args.turn),
        (args.leg, 1.0, 0.0),
        (args.turn, 0.6, np.pi / args.turn),
    )
    return synthetic.PiecewiseArcSequence(width=args.width, noise=0.01,
                                          segments=lap * args.laps)


def render_all(fn, n: int) -> list:
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, range(n)))


def load_scans(args, seq, root: str) -> list:
    """The drive's scans, from the cache file in ``root`` shared with
    ``stress_long.py``."""
    n = seq.n_frames
    cache = os.path.join(root, f".stress_scans_{args.laps}x{args.leg}_{args.turn}_"
                               f"{args.width}.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        return [data[f"s{k}"] for k in range(n)]
    t0 = time.time()
    scans = render_all(seq.scan, n)
    print(f"rendered {n} scans in {time.time() - t0:.0f}s", flush=True)
    np.savez_compressed(cache, **{f"s{k}": s for k, s in enumerate(scans)})
    return scans


def ground_truth(seq):
    """Positions (n, 3) and quaternions (n, 4) relative to frame 0."""
    n = seq.n_frames
    R0, t0 = seq.pose(0)
    gt = np.stack([R0.T @ (seq.pose(k)[1] - t0) for k in range(n)])
    gt_q = np.stack([se3.matrix_to_quat(torch.tensor(R0.T @ seq.pose(k)[0],
                                                     dtype=torch.float32)).numpy()
                     for k in range(n)])
    return gt, gt_q


def save_states(path: str, odo: lo.OdometryState, mp: dm.DeviceMapState) -> None:
    """The odometry and map states as an npz of host arrays, in the keys of
    the checkpoints (``utils/checkpoint.py``)."""
    arrays = lo.odometry_state_to_numpy(odo)
    for i, leaf in enumerate((mp.corner, mp.corner_mask, mp.surf, mp.surf_mask,
                              mp.correction.q, mp.correction.t)):
        arrays[f"mapst_{i}"] = leaf.detach().cpu().numpy()
    np.savez(path, **arrays)


def load_states(path: str, dev):
    data = np.load(path)
    return (lo.odometry_state_from_numpy(data, device=dev),
            dm.device_map_state_from_numpy(data, device=dev))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    seq = drive(args)
    n = seq.n_frames
    scans = load_scans(args, seq, ROOT)

    cfg = SystemConfig()
    lcfg = cfg.lidar
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def run(start_chunk=0, odo_state=None, map_state=None, n_chunks=None,
            sync_after_first=False):
        """Chunks [start_chunk, start_chunk + n_chunks) of the drive; returns
        (odometry state, map state, (odometry q, t, mapped q, t) on the host,
        chunk wall times). Frame 0 bootstraps when starting from scratch."""
        if odo_state is None:
            xyz0, mask0 = pc.pad_points(np.asarray(scans[0])[:, :3], 131072)
            odo_state = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device=dev).features)
            map_state = dm.init_state(cfg.mapping, dev)
        starts = list(range(1, n, args.chunk))
        sel = starts[start_chunk:None if n_chunks is None else start_chunk + n_chunks]
        oq, ot, mq, mt, walls = [], [], [], [], []
        for s in sel:
            t0 = time.time()
            batch = scans[s:s + args.chunk]
            imgs = native_pack.pack_polar_chunk(batch, n_frames=len(batch), channels=1, **geom)
            odo_state, map_state, op, mp = dm.slam_chunk_polar(
                odo_state, map_state, imgs, lcfg, cfg.odometry, cfg.mapping,
                start_idx=s, map_skip=1, device=dev)
            oq.append(op.q)
            ot.append(op.t)
            mq.append(mp.q)
            mt.append(mp.t)
            if sync_after_first and s == sel[0]:
                # chunk 0's work done, not only queued, so that the
                # steady-state window leaves it out entirely
                sync()
            walls.append(time.time() - t0)
        out = [torch.cat(x).cpu().numpy() for x in (oq, ot, mq, mt)]
        return odo_state, map_state, out, walls

    # ---- uninterrupted run ----
    t_all0 = time.time()
    odo1, map1, (oq, ot, mq, mt), _ = run()
    wall_total = time.time() - t_all0

    # steady state: a second run (kernels built, caches warm), every chunk
    # after the first: no build, no frame-0 bootstrap
    t1 = time.time()
    _, _, _, walls = run(sync_after_first=True)
    wall_warm = time.time() - t1
    frames_warm = n - 1 - args.chunk
    steady_fps = frames_warm / max(wall_warm - walls[0], 1e-9)

    gt, gt_q = ground_truth(seq)
    mapped_pos = np.concatenate([np.zeros((1, 3), np.float32), mt])[:n]
    odom_pos = np.concatenate([np.zeros((1, 3), np.float32), ot])[:n]
    ate_map = metrics.ate_rmse(mapped_pos, gt, align=False)
    ate_odo = metrics.ate_rmse(odom_pos, gt, align=False)
    mapped_q = np.concatenate([np.array([[1.0, 0, 0, 0]], np.float32), mq])[:n]
    t_rel, r_rel = metrics.kitti_relative_errors(
        metrics.poses_to_matrices(mapped_q, mapped_pos),
        metrics.poses_to_matrices(gt_q, gt), step=4)
    occ_corner = float(map1.corner_mask.sum()) / cfg.mapping.map_corner_cap
    occ_surf = float(map1.surf_mask.sum()) / cfg.mapping.map_surf_cap

    report = {
        "frames": n,
        "laps": args.laps,
        "ate_odom_m": round(float(ate_odo), 4),
        "ate_mapped_m": round(float(ate_map), 4),
        "t_rel_pct": round(float(t_rel), 3),
        "r_rel_deg_per_100m": round(float(r_rel), 4),
        "fps_total_cold": round((n - 1) / wall_total, 2),
        "fps_steady": round(steady_fps, 2),
        "map_occupancy_corner": round(occ_corner, 3),
        "map_occupancy_surf": round(occ_surf, 3),
    }

    if not args.no_resume_check:
        # mid-run snapshot: save at half, resume from fresh tensors, run the
        # second half, compare with the uninterrupted run
        half = len(range(1, n, args.chunk)) // 2
        odo_h, map_h, (_, _, _, mt_h), _ = run(n_chunks=half)
        path = os.path.join(ROOT, ".stress_ckpt.npz")
        save_states(path, odo_h, map_h)
        odo_r, map_r = load_states(path, dev)
        _, _, (_, _, _, mt2), _ = run(start_chunk=half, odo_state=odo_r, map_state=map_r)
        resumed = np.concatenate([mt_h, mt2])
        report["resume_bit_exact"] = bool(np.array_equal(resumed[:len(mt)], mt))
        report["resume_max_diff"] = float(np.abs(resumed[:len(mt)] - mt).max())

    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
