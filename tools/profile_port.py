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
  times, and records its mapped positions. ``knn`` traces ``chip_smoke.py``'s
  phase 5 (the k-NN entry points off the product path, on every frame, at
  the poses of one SLAM run) and gives the device time per call of K7 (index
  and coordinate forms, edge and plane calls apart) and of K5, K8 and K5p
  (corner and surf calls apart). ``direct`` times the direct-VO path
  (``DirectVOChunked.run_chunked`` at the bench's call, clouds from
  ``CamLidarPipeline._cam_cloud``) split into upload, decode and pyramid,
  tracking, point selection, the keyframe decision and the window shift with
  its BA, with the tracker's iterations and the BA's rounds per frame.
  ``drivers`` traces the per-frame drivers and the default ingests, each
  after a warm run: ``OdometryPipeline.run_chunked`` with the ``"float"``
  and the ``"uint16"`` ingest, ``OdometryPipeline.run``,
  ``FullPipeline.run_chunked`` (``"uint16"``), ``FullPipeline.run`` with the
  device map and with the host cube map, and ``CamLidarPipeline.run_chunked``
  (``"uint16"``) and ``.run``.

Scans and images are rendered in threads with numpy's BLAS held to one
thread (several BLAS threads under several Python threads have corrupted
renders).

Writes ``<out>/profile_port.json`` and prints a summary. Needs a CUDA device.

    python tools/profile_port.py [--frames 17]
        [--paths odometry,slam,slam_dense,camlidar,knn,direct,drivers] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# one BLAS thread: numpy's OpenBLAS has corrupted renders made while other
# threads called it. Set before numpy is first imported.
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# the port's kernels by their CUDA names: K1's batched and flat forms, K2, K3,
# K4's range pre-pass and search, K5 (with K8 and K5p), K6 and K7
PORT_KERNELS = ("segsum_rows_kernel", "segsum_flat_kernel", "assoc_kernel", "gn_kernel",
                "topk_window_ranges_kernel", "topk_windowed_kernel", "topk_kernel",
                "lk_level_kernel", "ring_top2_kernel")


def _kernel_name(key: str, name: str) -> str:
    """A port kernel's name with its template arguments (``assoc_kernel<12>``),
    so that the instantiations of one kernel stay apart."""
    return key[key.index(name):].split("(")[0]


def _k2_by_call(kernel_events, frames):
    """K2's device time per call, its edge and plane calls apart: every
    re-association round calls it on the edges, then on the planes
    (``models/lidar_odometry.py``), so in time order the calls alternate."""
    k2 = sorted((e for e in kernel_events if "assoc_kernel" in e.name),
                key=lambda e: e.time_range.start)
    if not k2 or len(k2) % 2:
        return {}
    return {kind: {"calls_per_frame": len(k2) / 2 / frames,
                   "device_ms_per_call": sum(e.time_range.elapsed_us() for e in k2[j::2])
                   / 1e3 / (len(k2) / 2)}
            for j, kind in enumerate(("edges", "planes"))}


def _by_call(kernel_events, name, kinds, instances=True):
    """Device ms per call of each instance of kernel ``name`` (of all its
    instances together, ``instances=False``), its calls taken in time order
    as ``kinds`` in turn (the order in which a path calls it), so that calls
    of one instance at other shapes stay apart."""
    by_instance = {}
    for e in kernel_events:
        if name + "<" in e.name or name + "(" in e.name:
            key = _kernel_name(e.name, name) if instances else name
            by_instance.setdefault(key, []).append(e)
    out = {}
    for inst, evs in by_instance.items():
        evs.sort(key=lambda e: e.time_range.start)
        n = len(evs) // len(kinds)
        out[inst] = {kind: {"calls": len(evs[j::len(kinds)]),
                            "device_ms_per_call": sum(e.time_range.elapsed_us()
                                                      for e in evs[j::len(kinds)])
                            / 1e3 / max(n, 1)}
                     for j, kind in enumerate(kinds)}
    return out


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
        "associate_kernel_by_call": _k2_by_call(kernel_events, frames),
        "port_kernels_on_path": {
            _kernel_name(e.key, name): {"calls_per_frame": e.count / frames,
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
    ap.add_argument("--paths", default="odometry,slam,slam_dense,camlidar,knn,direct,drivers")
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
        images = (list(ex.map(render_image, range(args.frames)))
                  if {"camlidar", "direct", "drivers"} & set(paths) else [])
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

    def direct_stage_times(dvo, clouds, masks):
        """``DirectVOChunked.run_chunked``'s stages per frame, through its
        ``stage_timer``, with a device synchronisation around each."""
        from lidar_visual_odometry_tpu_torch.models import tracker_direct, window_ba

        stages = {}

        @contextlib.contextmanager
        def timed(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0

        tracker_direct.reset_stats()
        window_ba.reset_stats()
        plain, dvo.stage_timer = dvo.stage_timer, timed
        dvo.run_chunked(images, clouds, masks, chunk=8)
        dvo.stage_timer = plain
        return {"stage_ms_per_frame_synchronised": {k: 1e3 * v / n for k, v in stages.items()},
                "track_iterations_per_frame": tracker_direct.stats["iterations"] / n,
                "ba_calls_per_frame": window_ba.stats["calls"] / n,
                "ba_rounds_per_frame": window_ba.stats["rounds"] / n}

    if "odometry" in paths:
        OdometryPipeline(cfg, device=dev).run_chunked(scans, chunk=8, ingest="polar2")   # warm
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
            scans, chunk=8, ingest="polar2").positions, n))
        result["odometry"] = r

    if "slam" in paths:
        FullPipeline(cfg, device=dev).run_chunked(scans, chunk=8, map_skip=1,
                                                  ingest="polar2")   # warm
        torch.cuda.synchronize()
        r = stage_times(slam=True)
        torch.cuda.reset_peak_memory_stats()
        r.update(_trace(lambda: FullPipeline(cfg, device=dev).run_chunked(
            scans, chunk=8, map_skip=1, ingest="polar2")[1].positions, n))
        r["peak_device_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        result["slam"] = r

    if "slam_dense" in paths:
        cfg_dense = SystemConfig(mapping=MappingConfig(windowed_nn=False))
        FullPipeline(cfg_dense, device=dev).run_chunked(scans, chunk=8, map_skip=1,
                                                        ingest="polar2")   # warm
        mapped = {}

        def run_dense():
            mapped["positions"] = FullPipeline(cfg_dense, device=dev).run_chunked(
                scans, chunk=8, map_skip=1, ingest="polar2")[1].positions
            return mapped["positions"]

        result["slam_dense"] = _trace(run_dense, n)
        result["slam_dense"]["mapped_positions"] = np.asarray(mapped["positions"]).tolist()

    if "knn" in paths:
        from chip_smoke import phase5_knn
        from torch.profiler import ProfilerActivity, profile

        odo, mapped = FullPipeline(cfg, device=dev).run_chunked(scans, chunk=8, map_skip=1,
                                                                ingest="polar2")
        phase5_knn(scans, odo, mapped, dev)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            counts, stats, _ = phase5_knn(scans, odo, mapped, dev)
            torch.cuda.synchronize()
        kernel_events = [e for e in prof.events()
                         if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        result["knn"] = {
            "launches_per_frame": {k: v / n for k, v in counts.items() if v},
            "stats": stats,
            # per frame: K7's index form, then its coordinate form, on the
            # edges, then both on the planes (an instance a launch
            # configuration, so all instances together); K5, K8 and K5p on
            # the corner queries, then on the surf queries
            "ring_top2_by_call": _by_call(kernel_events, "ring_top2_kernel",
                                          ("index edges", "coords edges", "index planes",
                                           "coords planes"), instances=False),
            "topk_by_call": _by_call(kernel_events, "topk_kernel", ("corner", "surf")),
        }

    if "camlidar" in paths:
        ccfg = camlidar_config()
        cl.CamLidarPipeline(ccfg, device=dev).run_chunked(scans, images, chunk=8,
                                                          ingest="polar2")   # warm
        torch.cuda.synchronize()
        r = camlidar_stage_times()
        torch.cuda.reset_peak_memory_stats()
        r.update(_trace(lambda: cl.CamLidarPipeline(ccfg, device=dev).run_chunked(
            scans, images, chunk=8, ingest="polar2").visual_positions, n))
        r["peak_device_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        result["camlidar"] = r

    if "direct" in paths:
        from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked

        ccfg = camlidar_config()
        pipe = cl.CamLidarPipeline(ccfg, device=dev)
        clouds, masks = zip(*(pipe._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
        dvo = DirectVOChunked(pipe.cam, ccfg.visual, point_cap=2048, device=dev)
        dvo.run_chunked(images, clouds, masks, chunk=8)   # warm
        torch.cuda.synchronize()
        r = direct_stage_times(dvo, clouds, masks)
        torch.cuda.reset_peak_memory_stats()
        r.update(_trace(lambda: dvo.run_chunked(images, clouds, masks, chunk=8)[0], n))
        r["peak_device_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        result["direct"] = r

    if "drivers" in paths:
        ccfg = camlidar_config()
        runs = {
            "odometry_float": lambda: OdometryPipeline(cfg, device=dev).run_chunked(
                scans, chunk=8).positions,
            "odometry_uint16": lambda: OdometryPipeline(cfg, device=dev).run_chunked(
                scans, chunk=8, quantize=True).positions,
            "odometry_per_frame": lambda: OdometryPipeline(cfg, device=dev).run(
                scans).positions,
            "slam_uint16": lambda: FullPipeline(cfg, device=dev).run_chunked(
                scans, chunk=8, map_skip=1)[1].positions,
            "slam_per_frame_device_map": lambda: FullPipeline(cfg, device=dev).run(
                scans)[1].positions,
            "slam_per_frame_host_map": lambda: FullPipeline(
                cfg, device_map=False, device=dev).run(scans)[1].positions,
            "camlidar_uint16": lambda: cl.CamLidarPipeline(ccfg, device=dev).run_chunked(
                scans, images, chunk=8).visual_positions,
            "camlidar_per_frame": lambda: cl.CamLidarPipeline(ccfg, device=dev).run(
                scans, images).visual_positions,
        }
        result["drivers"] = {}
        for name, run in runs.items():
            run()   # warm
            # the per-frame drivers also compute frame 0
            frames = n + 1 if name.endswith(("per_frame", "device_map", "host_map")) else n
            r = _trace(run, frames)
            r["top_ops_by_device_time"] = r["top_ops_by_device_time"][:10]
            result["drivers"][name] = r

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_port.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    for path in paths:
        if path == "drivers":
            for name, r in result[path].items():
                print(f"drivers {name}: " + ", ".join(
                    f"{k} {r[k]:.4f}" for k in ("profiled_wall_ms_per_frame",
                                                 "device_busy_ms_per_frame",
                                                 "device_idle_share",
                                                 "device_events_per_frame")))
            continue
        r = result[path]
        print(path, json.dumps({k: v for k, v in r.items()
                                if k not in ("top_ops_by_device_time", "mapped_positions")}))
        for row in r.get("top_ops_by_device_time", [])[:15]:
            print(f"  {row['device_ms']:10.3f} ms  {row['calls']:7d} calls  {row['op'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
