#!/usr/bin/env python
"""Accuracy across hard regimes on the PyTorch port.

The port's counterpart of ``scripts/eval_regimes.py``, with the same regimes,
the same flags and ``--device`` (default ``cuda``) in place of ``--cpu``: lidar
odometry and odometry + mapping (the device voxel map) over four synthetic
regimes (a gentle long corridor, a rotation-heavy S-curve, an out-and-back
revisit and high sensor noise), one JSON row a regime with the same keys, and
the ``{"table": [...]}`` line last. ``--visual`` adds the plain and coupled
cam-lidar rows on the rotation and revisit regimes (the bench-scale camera,
the ``"polar"`` ingest), ``--direct`` the direct-VO rows on every regime,
``--imu`` the IMU-fusion regimes, ``--sweep-outer`` the mapping schedule
sweep.

Scans and images are rendered in threads with numpy's BLAS held to one thread
(several BLAS threads under several Python threads have corrupted renders),
and cached beside the repo in the ``.eval_scans_*`` / ``.eval_imgs_*`` files
that ``scripts/eval_regimes.py`` reads and writes.

Usage:
    python scripts/eval_regimes_torch.py                    # on the card
    python scripts/eval_regimes_torch.py --device cpu --frames 24 --width 600
    python scripts/eval_regimes_torch.py --visual --direct --imu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

# Set before numpy is first imported (see above).
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from lidar_visual_odometry_tpu_torch.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu_torch.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM, camlidar_config  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig  # noqa: E402

VISUAL_REGIMES = ("rotation_heavy", "revisit_out_and_back")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=200,
                    help="frames for the long corridor regime")
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--sweep-outer", action="store_true",
                    help="also sweep mapping outer_iters on the rotation regime")
    ap.add_argument("--visual", action="store_true",
                    help="add the plain and coupled cam-lidar rows on the rotation and "
                         "revisit regimes (renders camera images, cached)")
    ap.add_argument("--imu", action="store_true",
                    help="add the bumpy-trajectory and constant-speed-turn IMU-fusion "
                         "regimes (synthetic IMU from the true poses)")
    ap.add_argument("--direct", action="store_true",
                    help="add the direct photometric VO rows (tracking only and BA every "
                         "frame) on every regime")
    return ap.parse_args(argv)


def build_regimes(frames: int, width: int) -> dict:
    """``eval_regimes.py``'s four regimes."""
    return {
        f"corridor_{frames}f": synthetic.SyntheticSequence(
            n_frames=frames, width=width, yaw_rate=0.004, noise=0.01),
        "rotation_heavy": synthetic.PiecewiseArcSequence.s_curve(
            leg=20, yaw_rate=0.04, width=width, noise=0.01),
        "revisit_out_and_back": synthetic.PiecewiseArcSequence.out_and_back(
            leg=16, turn=12, width=width, noise=0.01),
        "high_noise": synthetic.SyntheticSequence(
            n_frames=30, width=width, yaw_rate=0.01, noise=0.05),
    }


def _render_all(fn, n: int) -> list:
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, range(n)))


def load_scans(name: str, seq, width: int) -> list:
    """The regime's scans, from its cache file when there is one."""
    n = seq.n_frames
    cache = os.path.join(ROOT, f".eval_scans_{name}_{n}f_{width}w.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        return [data[f"s{k}"] for k in range(n)]
    scans = _render_all(seq.scan, n)
    np.savez_compressed(cache, **{f"s{k}": s for k, s in enumerate(scans)})
    return scans


def render_camera(seq, k: int) -> np.ndarray:
    Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
    return synthetic.render_image(seq.scene, Rc, tc, **CAM)[0]


def load_images(name: str, seq) -> list:
    """The regime's bench-scale camera images, from their cache when there is one."""
    n = seq.n_frames
    cache = os.path.join(ROOT, f".eval_imgs_{name}_{CAM['width']}x{CAM['height']}.npz")
    if os.path.exists(cache):
        data = np.load(cache)
        return [data[f"i{k}"] for k in range(n)]
    images = _render_all(lambda k: render_camera(seq, k), n)
    np.savez_compressed(cache, **{f"i{k}": im for k, im in enumerate(images)})
    return images


def ground_truth(seq) -> np.ndarray:
    """The true positions in the first frame's body frame."""
    R0, t0 = seq.pose(0)
    return np.stack([R0.T @ (seq.pose(k)[1] - t0) for k in range(seq.n_frames)])


def _ate(positions, gt) -> float:
    return round(metrics.ate_rmse(positions, gt, align=False), 4)


def lidar_row(name: str, seq, scans, device: str) -> dict:
    """Odometry and mapped ATE and the mapped trajectory's KITTI relative errors."""
    import torch

    from lidar_visual_odometry_tpu_torch.ops import se3

    n = seq.n_frames
    gt = ground_truth(seq)
    odom, mapped = FullPipeline(SystemConfig(), device=device).run_chunked(scans, chunk=8)
    row = {"regime": name, "frames": n, "ate_odom_m": _ate(odom.positions, gt),
           "ate_mapped_m": _ate(mapped.positions, gt)}
    try:
        R0 = seq.pose(0)[0]
        gt_q = np.stack([
            se3.matrix_to_quat(torch.as_tensor(R0.T @ seq.pose(k)[0], dtype=torch.float32)).numpy()
            for k in range(n)])
        path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        lengths = tuple(L for L in (20.0, 40.0, 80.0, 100.0, 160.0)
                        if L < 0.9 * path_len) or (path_len * 0.5,)
        t_rel, r_rel = metrics.kitti_relative_errors(
            metrics.poses_to_matrices(mapped.quaternions, mapped.positions),
            metrics.poses_to_matrices(gt_q, gt), lengths=lengths, step=4)
        row["t_rel_pct"] = round(float(t_rel), 3)
        row["r_rel_deg_per_100m"] = round(float(r_rel), 4)
    except Exception as e:  # t_rel needs a path long enough
        row["t_rel_err"] = str(e)[:60]
    return row


def visual_row(name: str, seq, scans, images, device: str) -> dict:
    """The plain and the coupled cam-lidar runs at the bench's camera."""
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline

    gt = ground_truth(seq)
    vcfg = camlidar_config()
    plain = CamLidarPipeline(vcfg, device=device).run_chunked(scans, images, chunk=8,
                                                              ingest="polar")
    coupled = CamLidarPipeline(vcfg, device=device).run_chunked(scans, images, chunk=8,
                                                                ingest="polar", coupled=True)
    return {
        "regime": name + "_visual", "frames": seq.n_frames,
        "ate_visual_m": _ate(plain.visual_positions, gt),
        "ate_lidar_plain_m": _ate(plain.lidar_positions, gt),
        "ate_lidar_coupled_m": _ate(coupled.lidar_positions, gt),
        "ate_visual_coupled_m": _ate(coupled.visual_positions, gt),
    }


def direct_row(name: str, seq, scans, images, device: str) -> dict:
    """Direct VO, tracking only and with the window BA every frame, on the
    clouds ``CamLidarPipeline._cam_cloud`` cuts from the scans."""
    import torch

    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import (
        CamLidarPipeline, _map_cam_poses_to_lidar,
    )
    from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked
    from lidar_visual_odometry_tpu_torch.utils.config import VisualConfig

    base = camlidar_config()
    dcfg = SystemConfig(camera=base.camera, visual=VisualConfig(depth_cloud_cap=16384),
                        extrinsic=base.extrinsic)
    gt = ground_truth(seq)
    clp = CamLidarPipeline(dcfg, device=device)
    clouds, cmasks = zip(*(clp._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
    row = {"regime": name + "_direct", "frames": seq.n_frames}
    for label, run_ba in (("plain", False), ("ba", True)):
        dvo = DirectVOChunked(clp.cam, dcfg.visual, point_cap=2048, run_window_ba=run_ba,
                              device=device)
        ts_d, qs_d, _ = dvo.run_chunked(images, list(clouds), list(cmasks), chunk=8)
        _, vt = _map_cam_poses_to_lidar(torch.from_numpy(qs_d).to(clp.device),
                                        torch.from_numpy(ts_d).to(clp.device),
                                        clp.T_lidar_cam, clp.T_cam_lidar)
        row[f"ate_direct_{label}_m"] = _ate(vt.cpu().numpy(), gt)
    return row


def imu_rows(width: int, device: str) -> list:
    """A bumpy drive (window fusion against plain odometry) and a sharp
    constant-speed turn under a fixed budget of 5 re-association rounds (the
    gyro's warm start against none)."""
    from lidar_visual_odometry_tpu_torch.data import sync
    from lidar_visual_odometry_tpu_torch.models.imu_fusion import ImuFusedOdometry
    from lidar_visual_odometry_tpu_torch.utils.config import OdometryConfig

    def run_imu(seq, drv):
        n = seq.n_frames
        stamps, accel, gyro = synthetic.synthesize_imu(
            seq, frame_period=0.1, rate_hz=100.0, accel_noise=0.02, gyro_noise=0.002)
        idxs = sync.bundle_imu(np.arange(n) * 0.1, stamps)
        dts = np.full(stamps.shape, 0.01, np.float32)
        fused_pos, odom_pos = [], []
        for k in range(n):
            fp = drv.process(seq.scan(k), accel[idxs[k]], gyro[idxs[k]], dts[idxs[k]])
            fused_pos.append(fp.t.cpu().numpy())
            odom_pos.append(drv.odom.state.pose_w.t.cpu().numpy())
        gt = ground_truth(seq)
        return (metrics.ate_rmse(np.stack(odom_pos), gt, align=False),
                metrics.ate_rmse(np.stack(fused_pos), gt, align=False))

    rows = []
    bumpy = synthetic.SyntheticSequence(n_frames=40, width=width, yaw_rate=0.01, noise=0.02,
                                        bounce=0.08, roll_amp=0.04)
    ate_o, ate_f = run_imu(bumpy, ImuFusedOdometry(SystemConfig(), window=8, device=device))
    rows.append({"regime": "bumpy_imu", "frames": bumpy.n_frames,
                 "ate_odom_m": round(ate_o, 4), "ate_imu_fused_m": round(ate_f, 4)})

    # velocity-continuous, so that an IMU stream can follow it
    turn = synthetic.PiecewiseArcSequence(
        width=width, noise=0.01, segments=((16, 1.0, 0.0), (12, 1.0, np.pi / 12), (16, 1.0, 0.0)))
    budget = SystemConfig(odometry=OdometryConfig(outer_iters=5, outer_tol=0.0))
    ate_plain, _ = run_imu(turn, ImuFusedOdometry(budget, window=8, imu_warmstart=False,
                                                  device=device))
    ate_warm, ate_wf = run_imu(turn, ImuFusedOdometry(budget, window=8, imu_warmstart=True,
                                                      device=device))
    rows.append({"regime": "const_speed_turn_imu_budget5", "frames": turn.n_frames,
                 "ate_odom_no_imu_m": round(ate_plain, 4),
                 "ate_odom_imu_warmstart_m": round(ate_warm, 4),
                 "ate_imu_fused_m": round(ate_wf, 4)})
    return rows


def sweep_rows(seq, scans, device: str) -> list:
    """Mapped ATE at fixed mapping schedules of 1, 2, 4 and 10 outer rounds."""
    from lidar_visual_odometry_tpu_torch.utils.config import MappingConfig

    gt = ground_truth(seq)
    rows = []
    for outer in (1, 2, 4, 10):
        cfg = SystemConfig(mapping=MappingConfig(outer_iters=outer, outer_tol=0.0))
        _, mapped = FullPipeline(cfg, device=device).run_chunked(scans, chunk=8)
        rows.append({"sweep": "mapping_outer_iters", "outer_iters": outer,
                     "ate_mapped_m": _ate(mapped.positions, gt)})
    return rows


def main(argv=None) -> None:
    args = parse_args(argv)
    regimes = build_regimes(args.frames, args.width)
    rows = []

    def emit(new):
        for row in new:
            rows.append(row)
            print(json.dumps(row), flush=True)

    for name, seq in regimes.items():
        emit([lidar_row(name, seq, load_scans(name, seq, args.width), args.device)])
    if args.visual:
        for name in VISUAL_REGIMES:
            seq = regimes[name]
            emit([visual_row(name, seq, load_scans(name, seq, args.width),
                             load_images(name, seq), args.device)])
    if args.direct:
        for name, seq in regimes.items():
            emit([direct_row(name, seq, load_scans(name, seq, args.width),
                             load_images(name, seq), args.device)])
    if args.imu:
        emit(imu_rows(args.width, args.device))
    if args.sweep_outer:
        seq = regimes["rotation_heavy"]
        emit(sweep_rows(seq, load_scans("rotation_heavy", seq, args.width), args.device))
    print(json.dumps({"table": rows}))


if __name__ == "__main__":
    main()
