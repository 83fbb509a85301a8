"""Where the time goes in the PyTorch port's paths, on one GPU.

Renders the bench corridor (64 rings x 2048 bins, ``SystemConfig()``), then
for the odometry path (``OdometryPipeline.run_chunked``), the fused SLAM
path (``FullPipeline.run_chunked``, map_skip 1) and the camera path
(``CamLidarPipeline.run_chunked`` with the bench's cam-lidar configuration,
``utils/bench_config.py``, and rendered 640 x 192 camera images) warms the
pipeline up and measures:

* per-stage wall time with a device synchronisation after each stage
  (host packing, upload, polar decode, feature extraction, scan-to-scan
  odometry; for SLAM also the mapping voxel filters, the scan-to-map solve
  and the map merge; for cam-lidar the lidar half as one stage, then image
  upload and pyramid, camera depth clouds, LK (kernel K6), depth
  association, ``solve_pose`` and replenishment) and re-association rounds
  per frame;
* a ``torch.profiler`` trace of one un-instrumented ``run_chunked``: device
  busy time, the device's idle share, kernel launches per frame and the
  operators that take the most device time, and the device time per call of
  each of the port's own CUDA kernels on the path. ``slam_dense`` traces the
  SLAM path with ``MappingConfig(windowed_nn=False)`` (kernel K5), no stage
  times.

Writes ``<out>/profile_port.json`` and prints a summary. Needs a CUDA device.

    python tools/profile_port.py [--frames 17] [--paths odometry,slam,slam_dense,camlidar]
                                 [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# the port's kernels by their CUDA names: K1's batched and flat forms, K2's
# two stages, K3, K4/K5 and K6
PORT_KERNELS = ("segsum_rows_kernel", "segsum_flat_kernel", "ring_top2_kernel",
                "resolve_kernel", "gn_kernel", "topk_kernel", "lk_level_kernel")


def _trace(run, frames):
    """Device busy time, idle share, launches and top operators of one
    un-instrumented ``run()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        positions = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_events = [e for e in prof.events()
                     if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernel_events)
    ops = sorted(prof.key_averages(), key=_device_us, reverse=True)
    return {
        "profiled_wall_ms_per_frame": 1e3 * wall / frames,
        "profiled_positions_finite": bool(np.isfinite(positions).all()),
        "device_busy_ms_per_frame": busy_us / 1e3 / frames,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events_per_frame": len(kernel_events) / frames,
        "port_kernels_on_path": {
            name: {"calls_per_frame": e.count / frames,
                   "device_ms_per_call": _device_us(e) / 1e3 / max(e.count, 1)}
            for e in ops for name in PORT_KERNELS if name + "(" in e.key or name + "<" in e.key
        },
        "top_ops_by_device_time": [
            {"op": e.key, "device_ms": _device_us(e) / 1e3, "calls": e.count} for e in ops[:25]
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--paths", default="odometry,slam,slam_dense,camlidar")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    paths = args.paths.split(",")

    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.models import device_mapping as dm
    from lidar_visual_odometry_tpu_torch.models import lidar_mapping as lm
    from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
    from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
    from lidar_visual_odometry_tpu_torch.ops import features as F
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.ops import se3
    from lidar_visual_odometry_tpu_torch.ops.voxel_map import voxel_merge
    from lidar_visual_odometry_tpu_torch.models import cam_lidar_pipeline as cl
    from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
    from lidar_visual_odometry_tpu_torch.ops import image, lk
    from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM, camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import MappingConfig, SystemConfig

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = SystemConfig()
    lcfg, mcfg = cfg.lidar, cfg.mapping
    seq = synthetic.SyntheticSequence(
        n_frames=args.frames, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    def render_image(k):
        Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        return synthetic.render_image(seq.scene, Rc, tc, **CAM)[0]

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(args.frames)))
        images = list(ex.map(render_image, range(args.frames))) if "camlidar" in paths else []
    n = len(scans) - 1
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
                min_range=lcfg.min_range, max_range=lcfg.max_range)
    smi = os.popen(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    result = {"card": smi, "frames": n}

    def stage_times(slam: bool):
        """Per-stage ms/frame, synchronised after each stage, and the
        re-association rounds per frame of each solve."""
        stages = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out

        xyz0, mask0 = pc.pad_points(scans[0], 131072)
        state = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device=dev).features)
        mp = dm.init_state(mcfg, dev)
        kernels.reset_launch_counts()
        for s in range(1, len(scans), 8):
            imgs = timed("pack", lambda: pc.pack_polar_chunk(scans[s:s + 8], channels=1, **geom))
            timgs = timed("upload", lambda: pc.polar_image_to_tensor(imgs, dev))
            for k in range(timgs.shape[0]):
                cs = timed("decode", lambda: pc.polar_to_compact(timgs[k], **geom))
                feats = timed("features", lambda: sr._extract(cs, lcfg))
                state, pose_w = timed("odometry",
                                      lambda: lo.odometry_step(state, feats, cfg.odometry))
                if not slam:
                    continue
                ls, lf_ = feats.less_sharp, feats.less_flat
                cds, sds = timed("map_voxel_filters", lambda: (
                    pc.voxel_downsample(ls.xyz, ls.mask, leaf=mcfg.corner_leaf,
                                        max_out=mcfg.corner_slot),
                    pc.voxel_downsample(lf_.xyz, lf_.mask, leaf=mcfg.surf_leaf,
                                        max_out=mcfg.surf_slot)))
                refined = timed("map_solve", lambda: lm.solve_map_pose(
                    cds, sds, pc.PointBatch(mp.corner, mp.corner_mask),
                    pc.PointBatch(mp.surf, mp.surf_mask),
                    se3.se3_compose(mp.correction, pose_w), mcfg))

                def merge():
                    kw = dict(drop_radius=mcfg.map_drop_radius)
                    c = voxel_merge(mp.corner, mp.corner_mask, se3.se3_apply(refined, cds.xyz),
                                    cds.mask, refined.t, leaf=mcfg.corner_leaf,
                                    cap=mcfg.map_corner_cap, **kw)
                    f = voxel_merge(mp.surf, mp.surf_mask, se3.se3_apply(refined, sds.xyz),
                                    sds.mask, refined.t, leaf=mcfg.surf_leaf,
                                    cap=mcfg.map_surf_cap, **kw)
                    return dm.DeviceMapState(c.xyz, c.mask, f.xyz, f.mask, se3.se3_compose(
                        refined, se3.se3_inverse(pose_w)))

                mp = timed("map_merge", merge)
        counts = kernels.launch_counts()
        out = {"stage_ms_per_frame_synchronised": {k: 1e3 * v / n for k, v in stages.items()},
               "odometry_rounds_per_frame": counts["gn_inner_loop"] / n}
        if slam:
            out["mapping_rounds_per_frame"] = counts["block_topk_windowed"] / 2 / n
        return out

    def camlidar_stage_times():
        """``CamLidarPipeline.run_chunked``'s work per frame, stage by stage,
        synchronised after each; the visual frame step split as
        ``visual_frontend.chunk_frame_step`` runs it."""
        ccfg = camlidar_config()
        vcfg = ccfg.visual
        pipe = cl.CamLidarPipeline(ccfg, device=dev)
        stages = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out

        raw0 = np.asarray(scans[0])[:, :3]
        xyz0, mask0 = pc.pad_points(raw0, 131072)
        odo = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device=dev).features)
        cxyz0, cmask0 = cl.camera_cloud_select(raw0, pipe.R_cl, pipe.t_cl, vcfg.depth_cloud_cap)
        st = vf.init_chunk_state(torch.from_numpy(images[0]).to(dev),
                                 torch.from_numpy(cxyz0).to(dev),
                                 torch.from_numpy(cmask0).to(dev), pipe.cam, vcfg)
        R_cl = torch.from_numpy(pipe.R_cl).to(dev)
        t_cl = torch.from_numpy(pipe.t_cl.copy()).to(dev)
        kernels.reset_launch_counts()
        vf.reset_stats()
        for s in range(1, len(scans), 8):
            batch = range(s, min(s + 8, len(scans)))
            pimgs = timed("pack + upload scans", lambda: pc.polar_image_to_tensor(
                pc.pack_polar_chunk([scans[k] for k in batch], channels=1, **geom), dev))
            dimgs = timed("upload images", lambda: torch.from_numpy(
                np.stack([cl._to_uint8(images[k]) for k in batch])).to(dev))
            dcx, dcm = timed("camera depth clouds", lambda: cl.cam_clouds_from_polar(
                pimgs, R_cl, t_cl, lcfg, vcfg.depth_cloud_cap))
            odo, _ = timed("lidar odometry (features + scan-to-scan)",
                           lambda: lo.odometry_chunk_polar(odo, pimgs, lcfg, cfg.odometry,
                                                           device=dev))
            for k in range(dimgs.shape[0]):
                pyr = timed("pyramid", lambda: tuple(image.build_pyramid(
                    dimgs[k].to(torch.float32) * (1.0 / 255.0), vcfg.lk_levels)))
                dc = timed("camera depth clouds",
                           lambda: vf.build_depth_cloud(dcx[k], dcm[k]))
                table = st.table
                uv1, ok = timed("LK (forward + reverse)", lambda: lk.track_pyramid_reverse_checked(
                    st.prev_pyr, pyr, table.uv, table.active, table.flow,
                    win=vcfg.lk_window, iters=vcfg.lk_iters, levels=vcfg.lk_levels,
                    max_reverse_err=vcfg.reverse_check_px,
                    reverse_levels=vcfg.lk_reverse_levels or None,
                    iters_coarse=vcfg.lk_iters_coarse or None, eps=vcfg.lk_eps,
                    affine=vcfg.lk_affine, reverse_affine=vcfg.lk_reverse_affine))
                gates = timed("depth association + triangulation", lambda: vf.depth_gates(
                    uv1, ok, st.prev_dc, table, st.pose_w, pipe.cam))
                rel = timed("solve_pose", lambda: vf.solve_pose(st.warm_rel, *gates[1:], vcfg))
                table, pose_w = timed("propagate", lambda: vf.apply_solution(
                    uv1, table, gates[0], gates[1], gates[3], gates[4], rel, st.pose_w))
                table = timed("replenish",
                              lambda: vf._replenish(table, pyr[0], pipe.cam, pose_w, vcfg))
                st = vf.VisualChunkState(table, pose_w, rel, pyr, dc)
        counts = kernels.launch_counts()
        return {"stage_ms_per_frame_synchronised": {k: 1e3 * v / n for k, v in stages.items()},
                "odometry_rounds_per_frame": counts["gn_inner_loop"] / n,
                "lk_level_launches_per_frame": counts["lk_level"] / n,
                "solve_pose_iterations_per_frame": int(vf.stats["solve_iterations"]) / n}

    if "odometry" in paths:
        OdometryPipeline(cfg, device=dev).run_chunked(scans, chunk=8)   # warm
        torch.cuda.synchronize()
        r = stage_times(slam=False)
        # the less-flat voxel filter's share of feature extraction
        cs = pc.polar_to_compact(pc.polar_image_to_tensor(
            pc.pack_polar_chunk(scans[1:2], channels=1, **geom), dev)[0], **geom)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            F.voxel_downsample_batched(cs.xyz, cs.valid, leaf=lcfg.surf_leaf_size,
                                       max_out=lcfg.max_less_flat // lcfg.n_scans)
        torch.cuda.synchronize()
        r["voxel_filter_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / 5
        r.update(_trace(lambda: OdometryPipeline(cfg, device=dev).run_chunked(
            scans, chunk=8).positions, n))
        result["odometry"] = r

    if "slam" in paths:
        FullPipeline(cfg, device=dev).run_chunked(scans, chunk=8, map_skip=1)   # warm
        torch.cuda.synchronize()
        r = stage_times(slam=True)
        torch.cuda.reset_peak_memory_stats()
        r.update(_trace(lambda: FullPipeline(cfg, device=dev).run_chunked(
            scans, chunk=8, map_skip=1)[1].positions, n))
        r["peak_device_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        result["slam"] = r

    if "slam_dense" in paths:
        cfg_dense = SystemConfig(mapping=MappingConfig(windowed_nn=False))
        FullPipeline(cfg_dense, device=dev).run_chunked(scans, chunk=8, map_skip=1)   # warm
        result["slam_dense"] = _trace(lambda: FullPipeline(cfg_dense, device=dev).run_chunked(
            scans, chunk=8, map_skip=1)[1].positions, n)

    if "camlidar" in paths:
        ccfg = camlidar_config()
        cl.CamLidarPipeline(ccfg, device=dev).run_chunked(scans, images, chunk=8)   # warm
        torch.cuda.synchronize()
        r = camlidar_stage_times()
        torch.cuda.reset_peak_memory_stats()
        r.update(_trace(lambda: cl.CamLidarPipeline(ccfg, device=dev).run_chunked(
            scans, images, chunk=8).visual_positions, n))
        r["peak_device_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        result["camlidar"] = r

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_port.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    for path in paths:
        r = result[path]
        print(path, json.dumps({k: v for k, v in r.items() if k != "top_ops_by_device_time"}))
        for row in r["top_ops_by_device_time"][:15]:
            print(f"  {row['device_ms']:10.3f} ms  {row['calls']:7d} calls  {row['op'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
