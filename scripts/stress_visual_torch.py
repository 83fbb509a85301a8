#!/usr/bin/env python
"""Long-horizon stress of the visual modes on the PyTorch port.

The port's counterpart of ``scripts/stress_visual.py``, with the same drive,
the same flags and report keys, and ``--device`` (default ``cuda``) in place
of ``--cpu``. The 500+-frame multi-lap drive of ``stress_long_torch.py`` (two
180-degree U-turns a lap) through the two benchmarked visual paths:

* tightly coupled cam-lidar with mapping
  (``CamLidarPipeline.run_chunked(ingest="polar2", coupled=True,
  mapping=True)``): feature-slot churn and the visual prior's gate through
  U-turns the camera cannot survive,
* direct photometric VO with the per-frame window BA
  (``DirectVOChunked(point_cap=2048).run_chunked``),

each stopped mid-run (``checkpoint_path``, ``stop_after``) and resumed
(``resume=True``), which must reproduce the uninterrupted trajectory bit for
bit. Images render at the bench camera (640 x 192). Scans and images are
rendered in threads with numpy's BLAS held to one thread and cached beside
the repo in the ``.stress_scans_*`` / ``.stress_imgs_*`` files that
``scripts/stress_visual.py`` reads and writes.

Usage:
    python scripts/stress_visual_torch.py [--laps 4] [--leg 50] [--turn 14]
    python scripts/stress_visual_torch.py --skip-direct    # coupled only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Set before numpy is first imported (see above).
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lidar_visual_odometry_tpu_torch.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu_torch.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import (  # noqa: E402
    CamLidarPipeline, _map_cam_poses_to_lidar,
)
from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import camera as cam_ops  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM, camlidar_config  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.device import resolve_device  # noqa: E402
from stress_long_torch import drive, ground_truth, load_scans, render_all  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--leg", type=int, default=50)
    ap.add_argument("--turn", type=int, default=14)
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--skip-direct", action="store_true")
    ap.add_argument("--skip-coupled", action="store_true")
    ap.add_argument("--no-resume-check", action="store_true")
    return ap.parse_args(argv)


def render_camera(seq, k: int) -> np.ndarray:
    Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
    return synthetic.render_image(seq.scene, Rc, tc, **CAM)[0]


def load_images(args, seq) -> list:
    """The drive's camera images, from the cache file shared with
    ``stress_visual.py``."""
    n = seq.n_frames
    tag = f"{args.laps}x{args.leg}_{args.turn}_{args.width}"
    cache = os.path.join(ROOT, f".stress_imgs_{tag}_{CAM['width']}x{CAM['height']}.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        return [data[f"i{k}"] for k in range(n)]
    t0 = time.time()
    images = render_all(lambda k: render_camera(seq, k), n)
    print(f"rendered {n} images in {time.time() - t0:.0f}s", flush=True)
    np.savez_compressed(cache, **{f"i{k}": im for k, im in enumerate(images)})
    return images


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    seq = drive(args)
    n = seq.n_frames
    scans = load_scans(args, seq, ROOT)
    images = load_images(args, seq)
    cfg = camlidar_config()     # the bench envelope: 640 x 192 camera, bench VisualConfig
    gt, gt_q = ground_truth(seq)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def t_rel_of(qs, ts):
        return metrics.kitti_relative_errors(
            metrics.poses_to_matrices(qs, ts), metrics.poses_to_matrices(gt_q, gt), step=4)

    report = {"frames": n, "laps": args.laps}

    if not args.skip_coupled:
        # coupled cam-lidar + mapping: a warm run (kernels built), then timed
        def coupled(pipe, **kw):
            return pipe.run_chunked(scans, images, chunk=args.chunk, ingest="polar2",
                                    coupled=True, mapping=True, **kw)

        pipe = CamLidarPipeline(cfg, device=dev)
        coupled(pipe)
        sync()
        t0 = time.time()
        res = coupled(pipe)
        sync()
        wall = time.time() - t0
        t_rel, r_rel = t_rel_of(res.mapped_quats, res.mapped_positions)
        report.update({
            "coupled_fps_warm": round((n - 1) / wall, 2),
            "coupled_ate_lidar_m": round(metrics.ate_rmse(res.lidar_positions, gt,
                                                          align=False), 4),
            "coupled_ate_mapped_m": round(metrics.ate_rmse(res.mapped_positions, gt,
                                                           align=False), 4),
            "coupled_ate_visual_m": round(metrics.ate_rmse(res.visual_positions, gt,
                                                           align=False), 4),
            "coupled_t_rel_pct": round(float(t_rel), 3),
            "coupled_r_rel_deg_per_100m": round(float(r_rel), 4),
        })
        print(json.dumps({k: v for k, v in report.items()
                          if k.startswith("coupled") or k == "frames"}), flush=True)

        if not args.no_resume_check:
            ck = os.path.join(ROOT, ".stress_visual_coupled.ckpt.npz")
            pipe2 = CamLidarPipeline(cfg, device=dev)
            coupled(pipe2, checkpoint_path=ck, checkpoint_every=n // 2, stop_after=n // 2)
            res_r = coupled(pipe2, checkpoint_path=ck, resume=True)
            exact = (np.array_equal(res_r.mapped_positions, res.mapped_positions)
                     and np.array_equal(res_r.visual_positions, res.visual_positions)
                     and np.array_equal(res_r.lidar_positions, res.lidar_positions))
            report["coupled_resume_bit_exact"] = bool(exact)
            os.remove(ck)
            print(json.dumps({"coupled_resume_bit_exact": bool(exact)}), flush=True)

    if not args.skip_direct:
        # direct VO + the per-frame window BA over the whole drive
        clp = CamLidarPipeline(cfg, device=dev)
        clouds, cmasks = zip(*(clp._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
        cam = cam_ops.Pinhole.from_config(cfg.camera, device=dev)
        dvo = DirectVOChunked(cam, cfg.visual, point_cap=2048, device=dev)
        dvo.run_chunked(images, clouds, cmasks, chunk=args.chunk)   # warm
        ts_d, qs_d, wall_d = dvo.run_chunked(images, clouds, cmasks, chunk=args.chunk)
        dq, vt = _map_cam_poses_to_lidar(torch.from_numpy(qs_d).to(dev),
                                         torch.from_numpy(ts_d).to(dev),
                                         clp.T_lidar_cam, clp.T_cam_lidar)
        dq, vt = dq.cpu().numpy(), vt.cpu().numpy()
        t_rel_d, r_rel_d = t_rel_of(dq, vt)
        report.update({
            "direct_fps_warm": round((n - 1) / wall_d, 2),
            "direct_ate_m": round(metrics.ate_rmse(vt, gt, align=False), 4),
            "direct_t_rel_pct": round(float(t_rel_d), 3),
            "direct_r_rel_deg_per_100m": round(float(r_rel_d), 4),
        })
        print(json.dumps({k: v for k, v in report.items() if k.startswith("direct")}),
              flush=True)

        if not args.no_resume_check:
            ck = os.path.join(ROOT, ".stress_visual_direct.ckpt.npz")
            dvo2 = DirectVOChunked(cam, cfg.visual, point_cap=2048, device=dev)
            dvo2.run_chunked(images, clouds, cmasks, chunk=args.chunk, checkpoint_path=ck,
                             checkpoint_every=n // 2, stop_after=n // 2)
            ts_r, qs_r, _ = dvo2.run_chunked(images, clouds, cmasks, chunk=args.chunk,
                                             checkpoint_path=ck, resume=True)
            exact = np.array_equal(ts_r, ts_d) and np.array_equal(qs_r, qs_d)
            report["direct_resume_bit_exact"] = bool(exact)
            os.remove(ck)
            print(json.dumps({"direct_resume_bit_exact": bool(exact)}), flush=True)

    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
