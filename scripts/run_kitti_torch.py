#!/usr/bin/env python
"""KITTI odometry sequence runner on the PyTorch port.

The port's counterpart of ``scripts/run_kitti.py``, with the same flags and
``--device`` (default ``cuda``): stream a KITTI sequence through the port's
drivers (the native reader → ``OdometryPipeline`` / ``FullPipeline`` /
``CamLidarPipeline`` [/ ``DirectVOChunked``] ``.run_chunked``), write the
trajectory in KITTI format, and print one JSON report (the same keys:
frames, frames/s, mode, and ATE / t_rel / r_rel against the ground truth
when the sequence has poses). ``--ingest float`` runs the mapping and camera
modes over the uint16 ingest, as the JAX package does (the port's drivers
accept no float ingest there).

Usage:
    python scripts/run_kitti_torch.py --root /data/kitti_odometry --sequence 0
    python scripts/run_kitti_torch.py --root ... --sequence 0 --mapping --max-frames 500
    python scripts/run_kitti_torch.py --root ... --coupled --mapping --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args() -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--sequence", type=int, default=0)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--mapping", action="store_true", help="scan-to-map stage")
    ap.add_argument("--camera", action="store_true",
                    help="camera + lidar (CamLidarPipeline) on image_0 beside the scans; "
                    "reports both trajectories. With --mapping: the full topology")
    ap.add_argument("--coupled", action="store_true",
                    help="the visual relative pose warm-starts the lidar scan-to-scan "
                    "solve; implies --camera, composes with --mapping")
    ap.add_argument("--direct", action="store_true",
                    help="direct photometric VO on image_0 and the camera-frame lidar "
                    "cloud beside the camera run; implies --camera")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--map-skip", type=int, default=1, help="mapping cadence")
    ap.add_argument("--ingest", choices=("float", "uint16", "polar"), default="polar",
                    help="scan upload encoding")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write the pipeline state every N frames (rounded to chunks) to "
                    "--checkpoint-path; a later --resume continues bit for bit")
    ap.add_argument("--checkpoint-path", default=None,
                    help="checkpoint file (default <out>.ckpt.npz; the --direct state goes "
                    "to *_direct.ckpt.npz)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint-path instead of frame 0")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="stop after this many frames, right after a checkpoint")
    ap.add_argument("--plot", default=None, help="write a trajectory PNG here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args()


def write_traj(path: str, quats, positions) -> np.ndarray:
    """KITTI trajectory file: a row-major 3 × 4 pose a line. Returns the
    (N, 4, 4) matrices."""
    from lidar_visual_odometry_tpu_torch.eval.metrics import poses_to_matrices

    mats = poses_to_matrices(quats, positions)
    with open(path, "w") as f:
        for T in mats:
            f.write(" ".join(f"{v:.6e}" for v in T[:3].reshape(-1)) + "\n")
    return mats


def read_scans(seq, n: int) -> list[np.ndarray]:
    """The sequence's first n scans through the native reader, each cut to
    its points."""
    from lidar_visual_odometry_tpu_torch.data.native_loader import NativeScanReader

    pattern = os.path.join(seq.seq_dir, "velodyne", "%06ld.bin")
    with NativeScanReader(pattern, n_files=n) as reader:
        return [xyz[mask] for xyz, mask, _ in reader]


def main() -> None:
    args = parse_args()
    device = "cpu" if args.cpu else args.device

    import torch

    from lidar_visual_odometry_tpu_torch.data.kitti import KittiOdometrySequence
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models.pipeline import (
        FullPipeline, OdometryPipeline, TrajectoryResult,
    )
    from lidar_visual_odometry_tpu_torch.utils.config import ExtrinsicConfig, kitti_config

    seq = KittiOdometrySequence(args.root, args.sequence)
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    cfg = kitti_config(args.sequence)
    scans = read_scans(seq, n)

    visual_result = direct_result = None
    if args.coupled or args.direct:
        args.camera = True
    out_path = args.out or f"trajectory_{args.sequence:02d}.txt"
    ckpt_path = args.checkpoint_path or out_path.replace(".txt", "") + ".ckpt.npz"
    ckpt_kw = dict(checkpoint_path=ckpt_path if (args.checkpoint_every or args.resume) else None,
                   checkpoint_every=args.checkpoint_every, resume=args.resume,
                   stop_after=args.stop_after)
    # the JAX package runs any ingest that is not polar as uint16 in these modes
    ingest = "uint16" if args.ingest == "float" and (args.camera or args.mapping) else args.ingest
    t0 = time.time()
    if args.camera:
        from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import (
            CamLidarPipeline, _map_cam_poses_to_lidar,
        )

        # the extrinsic from the sequence's own calib.txt (Tr: velodyne → cam0)
        cfg = dataclasses.replace(
            cfg, extrinsic=ExtrinsicConfig(matrix=tuple(map(tuple, seq.Tr.astype(float)))))
        H, W = cfg.camera.height, cfg.camera.width
        images = []
        for k in range(n):
            im = seq.image(k)
            # edge-replicated pad to the configured camera shape (the
            # principal point stays valid for bottom / right padding)
            ph, pw = max(0, H - im.shape[0]), max(0, W - im.shape[1])
            images.append(np.pad(im[:H, :W], ((0, ph), (0, pw)), mode="edge"))
        pipe = CamLidarPipeline(cfg, device=device)
        if (args.coupled or args.mapping) and not ingest.startswith("polar"):
            ingest = "polar"   # the coupled and mapping chunks decode polar scans
        res = pipe.run_chunked(scans, images, chunk=args.chunk, progress=True, ingest=ingest,
                               coupled=args.coupled, mapping=args.mapping,
                               map_skip=args.map_skip, **ckpt_kw)
        if args.mapping:
            result = TrajectoryResult(res.mapped_positions, res.mapped_quats)
        else:
            result = TrajectoryResult(res.lidar_positions, res.lidar_quats)
        visual_result = res

        if args.direct:
            from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked

            clouds, cmasks = zip(*(pipe._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
            dvo = DirectVOChunked(pipe.cam, cfg.visual, point_cap=2048, device=device)
            dkw = dict(ckpt_kw)
            if dkw["checkpoint_path"]:
                # the direct-VO state goes beside the cam-lidar one, never over it
                p = dkw["checkpoint_path"]
                p2 = re.sub(r"(\.ckpt\.npz|\.npz)$", r"_direct\1", p)
                dkw["checkpoint_path"] = p2 if p2 != p else p + "_direct.npz"
            ts_d, qs_d, _ = dvo.run_chunked(images, list(clouds), list(cmasks), chunk=args.chunk,
                                            **dkw)
            dq, dt = _map_cam_poses_to_lidar(torch.as_tensor(qs_d, device=pipe.device),
                                             torch.as_tensor(ts_d, device=pipe.device),
                                             pipe.T_lidar_cam, pipe.T_cam_lidar)
            direct_result = TrajectoryResult(dt.cpu().numpy(), dq.cpu().numpy())
    elif args.mapping:
        _, result = FullPipeline(cfg, device=device).run_chunked(
            scans, chunk=args.chunk, progress=True, map_skip=args.map_skip, ingest=ingest,
            **ckpt_kw)
    else:
        result = OdometryPipeline(cfg, device=device).run_chunked(
            scans, chunk=args.chunk, progress=True, ingest=ingest, **ckpt_kw)
    wall = time.time() - t0

    # a --stop-after run returns a truncated trajectory; report on what ran
    n = min(n, len(result.positions))
    mats = write_traj(out_path, result.quaternions, result.positions)
    if visual_result is not None:
        write_traj(out_path.replace(".txt", "_visual.txt"), visual_result.visual_quats,
                   visual_result.visual_positions)
    if direct_result is not None:
        write_traj(out_path.replace(".txt", "_direct.txt"), direct_result.quaternions,
                   direct_result.positions)
    if args.camera and args.mapping:
        # the result holds the mapped trajectory; the odometry one beside it
        write_traj(out_path.replace(".txt", "_odom.txt"), visual_result.lidar_quats,
                   visual_result.lidar_positions)

    # a resumed run computed only the frames after its checkpoint
    processed = n - 1
    if args.resume and os.path.exists(ckpt_path):
        processed = max(n - int(np.load(ckpt_path)["frame_idx"]), 1)
    report = {
        "sequence": args.sequence,
        "frames": n,
        "fps": round(processed / wall, 2),
        "mode": ("coupled" if args.coupled else "camera" if args.camera else
                 "mapping" if args.mapping else "odometry")
                + ("+mapping" if args.camera and args.mapping else "")
                + ("+direct" if args.direct else ""),
    }
    if seq.gt_poses is not None:
        gt = np.stack([seq.gt_pose_velodyne(k) for k in range(n)])
        gt_rel = np.linalg.inv(gt[0])[None] @ gt      # relative to the first velodyne pose
        report["ate_rmse_m"] = round(metrics.ate_rmse(result.positions, gt_rel[:, :3, 3]), 4)
        t_rel, r_rel = metrics.kitti_relative_errors(mats, gt_rel)
        report["t_rel_pct"] = round(t_rel, 3)
        report["r_rel_deg_per_100m"] = round(r_rel, 4)
        if visual_result is not None:
            report["ate_visual_m"] = round(metrics.ate_rmse(visual_result.visual_positions,
                                                            gt_rel[:, :3, 3]), 4)
        if args.camera and args.mapping:
            report["ate_odom_m"] = round(metrics.ate_rmse(visual_result.lidar_positions,
                                                          gt_rel[:, :3, 3]), 4)
        if direct_result is not None:
            report["ate_direct_m"] = round(metrics.ate_rmse(direct_result.positions,
                                                            gt_rel[:, :3, 3]), 4)
        if args.plot:
            from lidar_visual_odometry_tpu_torch.eval.plot import plot_trajectory

            plot_trajectory(result.positions, gt_rel[:, :3, 3], args.plot,
                            title=f"KITTI {args.sequence:02d}")
            report["plot"] = args.plot
    print(json.dumps(report))


if __name__ == "__main__":
    main()
