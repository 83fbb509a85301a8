#!/usr/bin/env python
"""Diagnose the feature-VO drift on the bench corridor, on the PyTorch port.

The port's counterpart of ``scripts/diag_visual.py``: the visual frontend
frame by frame with instrumentation, in four passes that swap estimated
quantities for ground truth (the synthetic scene gives exact depth maps and
poses):

  base     — the shipping pipeline (LK flow + lidar depth association)
  gt_depth — feature depths replaced by the rendered GT depth map
  gt_flow  — LK tracks replaced by exact GT reprojections
  gt_both  — both

Whichever substitution collapses the ATE names the dominant error source;
``gt_depth`` − ``base`` says how much of the drift comes from the lidar depths
(``visual_frontend.associate_depth``). Each step is the port's counterpart of
the JAX call the script makes: ``ops/lk.track_pyramid_reverse_checked``
(kernel K6 on the card), ``CamLidarPipeline._cam_cloud``,
``visual_frontend.build_depth_cloud``, ``associate_depth``, ``triangulate``,
``solve_pose`` and ``_replenish``; the host-side instrumentation is the
script's numpy. Per-frame stats have the JAX script's keys.

The corridor's scans, images and GT depth maps are rendered in threads with
numpy's BLAS held to one thread (ROADMAP C.5) and cached beside the repo in
``.bench_diag_<frames>.npz``. Their sha256 is checked against
``tools/jax_reference_diag.json`` when the frame counts agree, and each
pass's summary line gives the JAX run's ATE from that file beside the
port's.

Usage:
    python scripts/diag_visual_torch.py                     # on the card
    python scripts/diag_visual_torch.py --device cpu --frames 5
    python scripts/diag_visual_torch.py --passes base,gt_depth --quiet
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# Set before numpy is first imported (see above).
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from lidar_visual_odometry_tpu_torch.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu_torch.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf  # noqa: E402
from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import camera as cam_ops  # noqa: E402
from lidar_visual_odometry_tpu_torch.ops import image, lk, se3  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM, camlidar_config  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils.device import resolve_device  # noqa: E402

N_FRAMES = 49
PASSES = ("base", "gt_depth", "gt_flow", "gt_both")
REFERENCE = os.path.join(ROOT, "tools", "jax_reference_diag.json")


def corridor():
    """The bench's corridor (``bench.py``'s sequence)."""
    return synthetic.SyntheticSequence(n_frames=N_FRAMES, width=1800, speed=1.0,
                                       yaw_rate=0.004, noise=0.01)


def _render_frame(seq, k):
    Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
    return synthetic.render_image(seq.scene, Rc, tc, **CAM)


def load_or_render(seq, n):
    """The first ``n`` scans, images and GT depth maps, cached in
    ``ROOT/.bench_diag_<n>.npz``."""
    path = os.path.join(ROOT, f".bench_diag_{n}.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            return ([d[f"s{k}"] for k in range(n)], [d[f"i{k}"] for k in range(n)],
                    [d[f"d{k}"] for k in range(n)])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        rendered = list(ex.map(partial(_render_frame, seq), range(n)))
    images, depths = [r[0] for r in rendered], [r[1] for r in rendered]
    np.savez_compressed(path, **{f"s{k}": s for k, s in enumerate(scans)},
                        **{f"i{k}": i for k, i in enumerate(images)},
                        **{f"d{k}": d for k, d in enumerate(depths)})
    return scans, images, depths


def inputs_sha256(scans, images, depths) -> str:
    """sha256 over the arrays' bytes: the scans, the images, the depth maps."""
    digest = hashlib.sha256()
    for arr in (*scans, *images, *depths):
        digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def gt_camera_poses(seq, n):
    """R_wc, t_wc per frame (camera→world)."""
    Rs, ts = [], []
    for k in range(n):
        Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        Rs.append(Rc)
        ts.append(tc)
    return Rs, ts


def sample_depth(depth_map, uv):
    """Nearest-neighbor GT depth at pixel coords uv (N, 2); <=0 invalid."""
    H, W = depth_map.shape
    x = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    y = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    d = depth_map[y, x]
    return np.where(np.isfinite(d) & (d > 0), d, -1.0)


def run_pass(mode, scans, images, depths, seq, cfg, cam, n, device, verbose=True):
    """One pass of ``scripts/diag_visual.py``'s ``run_pass`` on ``device``:
    (ATE of the camera trajectory, per-frame stats)."""
    dev = resolve_device(device)
    vcfg = cfg.visual
    clp = CamLidarPipeline(cfg, device=dev)
    Rs, ts = gt_camera_poses(seq, n)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    table = vf.empty_table(vcfg.max_tracked, dev)
    pose_w = se3.identity_pose(dev)
    warm_rel = se3.identity_pose(dev)
    prev_pyr = None
    prev_dc = None
    traj_t = [np.zeros(3)]
    stats = []

    for k in range(n):
        img = t(np.asarray(images[k], np.float32))
        pyr = tuple(image.build_pyramid(img, vcfg.lk_levels))
        cxyz, cmask = clp._cam_cloud(np.asarray(scans[k])[:, :3])
        dc = vf.build_depth_cloud(t(cxyz), t(cmask, torch.bool))
        if prev_pyr is None:
            table = vf._replenish(table, pyr[0], cam, pose_w, vcfg)
            prev_pyr, prev_dc = pyr, dc
            continue

        # GT relative camera pose prev->cur: T_cur_prev
        R_rel = Rs[k].T @ Rs[k - 1]
        t_rel = Rs[k].T @ (ts[k - 1] - ts[k])

        uv1, ok = lk.track_pyramid_reverse_checked(
            prev_pyr, pyr, table.uv, table.active, table.flow,
            win=vcfg.lk_window, iters=vcfg.lk_iters, levels=vcfg.lk_levels,
            max_reverse_err=vcfg.reverse_check_px,
            reverse_levels=vcfg.lk_reverse_levels or None,
            iters_coarse=vcfg.lk_iters_coarse or None,
            eps=vcfg.lk_eps,
            affine=vcfg.lk_affine,
        )
        uv1 = uv1.cpu().numpy()
        ok = ok.cpu().numpy()
        uv0 = table.uv.cpu().numpy()
        table_active = table.active.cpu().numpy()
        active = table_active & ok

        # GT depth at prev-frame feature pixels + exact reprojection
        d_gt = sample_depth(depths[k - 1], uv0)
        un0_np = np.stack(
            [(uv0[:, 0] - float(cam.cx)) / float(cam.fx),
             (uv0[:, 1] - float(cam.cy)) / float(cam.fy)], -1
        )
        p0_gt = np.concatenate(
            [un0_np, np.ones_like(un0_np[:, :1])], -1
        ) * d_gt[:, None]
        p1_gt = p0_gt @ R_rel.T + t_rel
        z1 = np.maximum(p1_gt[:, 2], 1e-6)
        uv1_gt = np.stack(
            [p1_gt[:, 0] / z1 * float(cam.fx) + float(cam.cx),
             p1_gt[:, 1] / z1 * float(cam.fy) + float(cam.cy)], -1
        )
        gt_ok = (d_gt > 0) & (p1_gt[:, 2] > 0.3)

        if mode in ("gt_flow", "gt_both"):
            use = gt_ok & table_active
            uv1 = np.where(use[:, None], uv1_gt, uv1)
            ok = ok | use
            active = table_active & ok

        # flow error among survivors with GT depth (diagnostic)
        fe_vec = uv1 - uv1_gt
        fe = np.linalg.norm(fe_vec, axis=-1)
        fe_valid = active & gt_ok
        # radial decomposition about the FOE (≈ principal point under
        # forward motion): positive = feature tracked OUTWARD past GT
        rad_dir = uv0 - np.array([float(cam.cx), float(cam.cy)])
        rad_n = rad_dir / np.maximum(
            np.linalg.norm(rad_dir, axis=-1, keepdims=True), 1e-6
        )
        fe_rad = np.sum(fe_vec * rad_n, axis=-1)

        # ---- replicate solve_and_update with instrumentation ----
        un0 = cam_ops.normalized(cam, t(uv0))
        un1 = cam_ops.normalized(cam, t(uv1))
        d_lidar, ok_lidar = vf.associate_depth(un0, t(active, torch.bool), prev_dc)
        T_first = se3.Pose(table.start_q, table.start_t)
        T_prev_first = se3.se3_compose(
            se3.se3_inverse(se3.Pose(pose_w.q.expand_as(table.start_q),
                                     pose_w.t.expand_as(table.start_t))),
            T_first,
        )
        d_tri, ok_tri = vf.triangulate(un0, table.start_un, T_prev_first)
        d_lidar = d_lidar.cpu().numpy()
        ok_lidar = ok_lidar.cpu().numpy()
        d_tri = d_tri.cpu().numpy()
        ok_tri = ok_tri.cpu().numpy()
        prev_d = table.depth.cpu().numpy()
        has_prev = prev_d > 0

        d_tri_fused = np.where(has_prev, 0.4 * prev_d + 0.6 * d_tri, d_tri)
        depth = np.where(
            ok_lidar, d_lidar,
            np.where(ok_tri, d_tri_fused, np.where(has_prev, prev_d, 0.0)),
        )
        v1 = ok_lidar
        v2 = ~ok_lidar & (ok_tri | has_prev)
        has_depth = (v1 | v2) & active & (depth > 0)
        epi_ok = (~v1) & active

        if mode in ("gt_depth", "gt_both"):
            take = gt_ok & active
            depth = np.where(take, d_gt, depth)
            has_depth = take | (has_depth & ~take)

        # depth error stats (lidar-associated rows with GT available)
        de_mask = ok_lidar & gt_ok & active
        de = np.abs(d_lidar - d_gt)[de_mask] if de_mask.any() else np.array([0.0])

        rel = vf.solve_pose(
            warm_rel, un0, un1, t(depth),
            t(has_depth, torch.bool), t(epi_ok, torch.bool), vcfg,
        )

        # relative-pose error vs GT
        t_est = rel.t.cpu().numpy()
        # rotation error angle
        R_est = se3.quat_to_matrix(rel.q).cpu().numpy()
        dR = R_est.T @ R_rel
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        dt = t_est - t_rel
        # camera frame: z forward, x right, y down
        stats.append(dict(
            k=k, n_trk=int(active.sum()), n_lidar=int(ok_lidar.sum()),
            n_tri=int((ok_tri & active & ~ok_lidar).sum()),
            n_depth=int(has_depth.sum()), n_epi=int(epi_ok.sum()),
            de_med=float(np.median(de)),
            fe_med=float(np.median(fe[fe_valid])) if fe_valid.any() else -1,
            fe_mean_x=float(fe_vec[fe_valid, 0].mean()) if fe_valid.any() else 0,
            fe_mean_y=float(fe_vec[fe_valid, 1].mean()) if fe_valid.any() else 0,
            fe_rad_mean=float(fe_rad[fe_valid].mean()) if fe_valid.any() else 0,
            # flow error vs GT depth: near features zoom more under forward
            # motion — a positive correlation fingers scale-change bias
            fe_depth_corr=float(np.corrcoef(
                fe[fe_valid], d_gt[fe_valid]
            )[0, 1]) if fe_valid.sum() > 3 else 0,
            dt_fwd=float(dt[2]), dt_lat=float(dt[0]), dt_vert=float(dt[1]),
            rot_err_deg=float(ang),
            scale=float(np.linalg.norm(t_est) / max(np.linalg.norm(t_rel), 1e-9)),
        ))

        # propagate
        new_pose_w = se3.se3_compose(pose_w, se3.se3_inverse(rel))
        p0 = torch.cat([un0, torch.ones_like(un0[:, :1])], dim=-1) * t(depth)[:, None]
        p1 = se3.quat_rotate(rel.q[None], p0) + rel.t
        t_active = t(active, torch.bool)
        t_uv1 = t(uv1)
        table = vf.FeatureTable(
            uv=t_uv1, active=t_active,
            depth=torch.where(t(has_depth, torch.bool), p1[:, 2], torch.full_like(p1[:, 2], -1.0)),
            start_un=table.start_un, start_q=table.start_q,
            start_t=table.start_t, age=table.age + 1,
            flow=torch.where(t_active[:, None], t_uv1 - table.uv, torch.zeros_like(t_uv1)),
        )
        pose_w = new_pose_w
        warm_rel = rel
        table = vf._replenish(table, pyr[0], cam, pose_w, vcfg)
        prev_pyr, prev_dc = pyr, dc
        traj_t.append(pose_w.t.cpu().numpy())

        if verbose:
            s = stats[-1]
            print(f"[{mode}] k={k:2d} trk={s['n_trk']:4d} lidar={s['n_lidar']:4d} "
                  f"tri={s['n_tri']:3d} depth={s['n_depth']:4d} epi={s['n_epi']:4d} "
                  f"de_med={s['de_med']:.3f} fe_med={s['fe_med']:.3f}px "
                  f"fe_bias=({s['fe_mean_x']:+.3f},{s['fe_mean_y']:+.3f}) "
                  f"fe_rad={s['fe_rad_mean']:+.3f} dcorr={s['fe_depth_corr']:+.2f} "
                  f"dt=({s['dt_fwd']:+.4f},{s['dt_lat']:+.4f},{s['dt_vert']:+.4f}) "
                  f"rot={s['rot_err_deg']:.4f}deg scale={s['scale']:.4f}")

    # ATE of the camera trajectory vs GT (camera-0 frame, unaligned —
    # same protocol as bench.py's ate_visual)
    est = np.stack(traj_t)
    R0, t0 = Rs[0], ts[0]
    gt_cam = np.stack([R0.T @ (ts[k] - t0) for k in range(n)])
    ate = metrics.ate_rmse(est, gt_cam, align=False)
    print(f"== pass {mode}: ATE (camera frame, unaligned) = {ate:.4f} m ==")
    return ate, stats


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--passes", default=",".join(PASSES))
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--no-affine", action="store_true",
                    help="translation-only LK (the pre-fix tracker)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The four passes; prints a line a frame (unless ``--quiet``), the
    summary and the report as JSON last, and returns the report."""
    args = parse_args(argv)
    n = args.frames
    dev = resolve_device(args.device)
    seq = corridor()
    scans, images, depths = load_or_render(seq, n)
    digest = inputs_sha256(scans, images, depths)
    cfg = camlidar_config()
    if args.no_affine:
        cfg = cfg.replace(visual=dataclasses.replace(cfg.visual, lk_affine=False))
    cam = cam_ops.Pinhole.from_config(cfg.camera, dev)

    ref = None
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            ref = json.load(f)
        if ref["frames"] != n or args.no_affine:
            ref = None
    if ref is not None and digest != ref["inputs_sha256"]:
        raise SystemExit(f"the inputs hash to {digest[:16]}, the JAX reference's to "
                         f"{ref['inputs_sha256'][:16]}: they are not the reference's")

    report = {"frames": n, "device": str(dev), "inputs_sha256": digest, "passes": {}}
    for mode in args.passes.split(","):
        ate, stats = run_pass(mode, scans, images, depths, seq, cfg, cam, n, dev,
                              verbose=not args.quiet)
        report["passes"][mode] = {"ate_m": float(ate), "stats": stats}

    def jax_ate(mode):
        return ref["passes"][mode]["ate_m"] if ref and mode in ref["passes"] else None

    def text(x):
        return "not recorded" if x is None else f"{x:.4f} m"

    print("\n==== summary (port; JAX CPU from tools/jax_reference_diag.json) ====")
    for mode, rec in report["passes"].items():
        print(f"  {mode:10s} ATE = {rec['ate_m']:.4f} m (JAX {text(jax_ate(mode))})")
    if {"base", "gt_depth"} <= report["passes"].keys():
        port = report["passes"]["gt_depth"]["ate_m"] - report["passes"]["base"]["ate_m"]
        jax = (None if jax_ate("base") is None or jax_ate("gt_depth") is None
               else jax_ate("gt_depth") - jax_ate("base"))
        report["gt_depth_minus_base_m"] = {"port": port, "jax": jax}
        print(f"  gt_depth - base ATE = {port:+.4f} m (JAX "
              f"{'not recorded' if jax is None else f'{jax:+.4f} m'})")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
