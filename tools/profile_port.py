"""Where the time goes in the PyTorch port's lidar odometry path, on one GPU.

Renders the bench corridor (64 rings x 2048 bins, ``SystemConfig()``), warms
the pipeline up, then measures:

* per-stage wall time with a device synchronisation after each stage
  (host packing, upload, polar decode, feature extraction, scan-to-scan
  odometry) and re-association rounds per frame;
* a ``torch.profiler`` trace of one un-instrumented ``run_chunked``: device
  busy time, the device's idle share, kernel launches per frame and the
  operators that take the most device time, and the device time per call of
  each of the port's own CUDA kernels on the path.

Writes ``<out>/profile_port.json`` and prints a summary. Needs a CUDA device.

    python tools/profile_port.py [--frames 17] [--out profile_out]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()

    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
    from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
    from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline
    from lidar_visual_odometry_tpu_torch.ops import features as F
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = SystemConfig()
    lcfg = cfg.lidar
    seq = synthetic.SyntheticSequence(
        n_frames=args.frames, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(args.frames)))

    OdometryPipeline(cfg, device=dev).run_chunked(scans, chunk=8)   # warm
    torch.cuda.synchronize()

    # ---- per-stage times, synchronised after each stage ----
    stages = {"pack": 0.0, "upload": 0.0, "decode": 0.0, "features": 0.0, "odometry": 0.0}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] += time.perf_counter() - t0
        return out

    xyz0, mask0 = pc.pad_points(scans[0], 131072)
    state = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device=dev).features)
    kernels.reset_launch_counts()
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
                min_range=lcfg.min_range, max_range=lcfg.max_range)
    for s in range(1, len(scans), 8):
        imgs = timed("pack", lambda: pc.pack_polar_chunk(scans[s:s + 8], channels=1, **geom))
        timgs = timed("upload", lambda: pc.polar_image_to_tensor(imgs, dev))
        for k in range(timgs.shape[0]):
            cs = timed("decode", lambda: pc.polar_to_compact(timgs[k], **geom))
            feats = timed("features", lambda: sr._extract(cs, lcfg))
            state, _ = timed("odometry", lambda: lo.odometry_step(state, feats, cfg.odometry))
    n = len(scans) - 1
    rounds = kernels.launch_counts()["gn_inner_loop"] / n
    per_frame_ms = {k: 1e3 * v / n for k, v in stages.items()}

    # the voxel filter's share of feature extraction
    cs = pc.polar_to_compact(timgs[0], **geom)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        F.voxel_downsample_batched(cs.xyz, cs.valid, leaf=lcfg.surf_leaf_size,
                                   max_out=lcfg.max_less_flat // lcfg.n_scans)
    torch.cuda.synchronize()
    voxel_ms = 1e3 * (time.perf_counter() - t0) / 5

    # ---- profiler trace of one un-instrumented run ----
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = OdometryPipeline(cfg, device=dev).run_chunked(scans, chunk=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_events = [e for e in prof.events()
                     if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernel_events)
    ops = sorted(prof.key_averages(), key=_device_us, reverse=True)
    top = [{"op": e.key, "device_ms": _device_us(e) / 1e3, "calls": e.count} for e in ops[:25]]
    port_kernels = {
        name: {"calls": e.count, "device_ms_per_call": _device_us(e) / 1e3 / max(e.count, 1)}
        for e in ops
        for name in ("segsum_kernel", "ring_top2_kernel", "resolve_kernel", "gn_kernel")
        if name + "(" in e.key
    }

    smi = os.popen(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    result = {
        "card": smi,
        "frames": n,
        "stage_ms_per_frame_synchronised": per_frame_ms,
        "voxel_filter_ms_per_frame": voxel_ms,
        "rounds_per_frame": rounds,
        "profiled_wall_ms_per_frame": 1e3 * wall / n,
        "profiled_positions_finite": bool(np.isfinite(res.positions).all()),
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events_per_frame": len(kernel_events) / n,
        "port_kernels_on_path": port_kernels,
        "top_ops_by_device_time": top,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_port.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in result.items() if k != "top_ops_by_device_time"}))
    for row in top[:15]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:7d} calls  {row['op'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
