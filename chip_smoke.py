#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card (name and power limit from nvidia-smi), the torch and
         CUDA versions, and builds every CUDA kernel of the port from
         ``lidar_visual_odometry_tpu_torch/csrc`` (one nvcc per source, in
         parallel).
Phase 1  holds each kernel against its plain PyTorch version on the card, at
         the shapes the lidar odometry path gives it, and times kernel, plain
         version and (where one exists) the one PyTorch call that computes the
         same function.
Phase 2  drives the main path at full width: ``OdometryPipeline(SystemConfig(),
         device="cuda").run_chunked(scans, chunk=8, ingest="polar2")`` on the
         48-frame synthetic HDL-64 corridor (64 rings x 2048 azimuth bins), one
         warm run and one timed run; it checks that every kernel was launched in
         the timed run and that the trajectory's ATE is within 0.01 m of the JAX
         package's ATE on the same sequence (``tools/jax_reference_corridor.json``,
         written by ``tools/jax_reference_ate.py``).

Prints one JSON line with every kernel's numbers, the nvidia-smi line, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The JAX package's lidar odometry on this script's sequence and
# configuration, run on the CPU by tools/jax_reference_ate.py: its ATE gates
# the port's (plus ATE_MARGIN), its positions are compared for information.
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "jax_reference_corridor.json")
ATE_MARGIN = 0.01

N_FRAMES = 49
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase1_segsum(rng, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import segsum

    R, C, W, S = 64, 4, 2048, 513          # less-flat voxel filter, per frame
    # as the voxel filter produces them: sorted runs of a few points per
    # voxel, then every masked point of the ring in the overflow bucket S-1
    seg = np.full((R, W), S - 1, np.int32)
    for r in range(R):
        n_valid = int(rng.integers(800, 1800))
        seg[r, :n_valid] = np.sort(rng.integers(0, S - 1, n_valid))
    vals = rng.normal(scale=30.0, size=(R, C, W)).astype(np.float32)
    seg_t = torch.from_numpy(seg).to(dev)
    vals_t = torch.from_numpy(vals).to(dev)
    out = segsum.segment_sum_batched(seg_t, vals_t, n_segments=S)
    ref = segsum.segment_sum_batched_plain(seg_t, vals_t, n_segments=S)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    # float32 sums of the same values in another order (the plain version
    # adds with atomics on the card): |diff| <= 1e-3 + 1e-5 |ref|
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"segment_sum_batched disagrees with its plain version: {err}")

    # rows in no order take the kernel's general path
    seg_u = torch.from_numpy(rng.integers(0, S, (R, W)).astype(np.int32)).to(dev)
    out_u = segsum.segment_sum_batched(seg_u, vals_t, n_segments=S)
    ref_u = segsum.segment_sum_batched_plain(seg_u, vals_t, n_segments=S)
    err = max(err, float((out_u - ref_u).abs().max()))
    if not torch.allclose(out_u, ref_u, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"segment_sum_batched (unsorted ids) disagrees: {err}")

    flat_ids = (seg_t.to(torch.int64) + S * torch.arange(R, device=dev)[:, None]).reshape(-1)
    vals_rows = vals_t.permute(0, 2, 1).reshape(R * W, C).contiguous()

    def library():
        return torch.zeros((R * S, C), device=dev).index_add_(0, flat_ids, vals_rows)

    lib_out = library().reshape(R, S, C).permute(0, 2, 1)
    if not torch.allclose(lib_out, ref, rtol=1e-5, atol=1e-3):
        raise AssertionError("index_add_ yardstick disagrees with the plain version")
    ms = _time_ms(lambda: segsum.segment_sum_batched(seg_t, vals_t, n_segments=S), 200)
    plain_ms = _time_ms(lambda: segsum.segment_sum_batched_plain(seg_t, vals_t, n_segments=S), 200)
    library_ms = _time_ms(library, 200)
    bound, by = _bound_ms(4 * (R * W + R * C * W + R * C * S), R * C * W)
    return dict(
        name="segment_sum_batched", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/segsum.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_segsum.py:41",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
        shapes=f"seg ({R},{W}) i32, vals ({R},{C},{W}) f32, S={S}",
        tolerance="rtol 1e-5, atol 1e-3",
    )


def _assoc_inputs(rng, Q, R, B, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import nn

    c = rng.normal(scale=15.0, size=(R, B, 3)).astype(np.float32)
    m = rng.uniform(size=(R, B)) > 0.3
    pick = rng.integers(0, R * B, Q)
    q = (c.reshape(-1, 3)[pick] + rng.normal(scale=0.5, size=(Q, 3))).astype(np.float32)
    baked = nn.bake_mask(torch.from_numpy(c).to(dev), torch.from_numpy(m).to(dev))
    return torch.from_numpy(q).to(dev), baked.contiguous()


def phase1_assoc(rng, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import nn

    ms = plain_ms = bound = 0.0
    err = 0.0
    n_bytes = n_ops = 0
    shapes = []
    for Q, R, B in ((768, 64, 120), (1536, 64, 512)):   # edges, planes
        q, c = _assoc_inputs(rng, Q, R, B, dev)
        out = nn.associate_kernel(q, c, nearby_scan=2.5)
        ref = nn.associate_kernel_plain(q, c, nearby_scan=2.5)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        # same distances bit for bit (no FMA contraction in the kernel) and
        # the same tie rules, so the same winners: tolerance 1e-6
        if not torch.allclose(out, ref, rtol=0.0, atol=1e-6):
            raise AssertionError(f"associate_kernel disagrees at Q={Q}, B={B}: {e}")
        err = max(err, e)
        ms += _time_ms(lambda: nn.associate_kernel(q, c, nearby_scan=2.5), 100)
        plain_ms += _time_ms(lambda: nn.associate_kernel_plain(q, c, nearby_scan=2.5), 10)
        n_bytes += 4 * (Q * 3 + R * B * 3 + Q * 16)
        n_ops += 8 * Q * R * B        # 3 sub, 3 mul, 2 add per distance
        shapes.append(f"Q={Q} vs ({R},{B},3)")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="associate_kernel", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/nn.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_nn.py:220",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None,
        shapes="edges + planes (one re-association round): " + ", ".join(shapes),
        tolerance="atol 1e-6",
    )


def _gn_problem(rng, Ne, Np, dev):
    """Correspondences consistent with a known pose (tests' make_problem)."""
    import torch

    from lidar_visual_odometry_tpu_torch.ops import se3

    true = se3.se3_exp(torch.tensor([0.3, -0.15, 0.1, 0.02, -0.03, 0.04]))
    inv = se3.se3_inverse(true)
    a = rng.uniform(-10, 10, (Ne, 3)).astype(np.float32)
    d = rng.normal(size=(Ne, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    b = a + d
    lam = rng.uniform(-0.5, 1.5, (Ne, 1)).astype(np.float32)
    p_e = se3.se3_apply(inv, torch.from_numpy(a + lam * d)).numpy()
    j = rng.uniform(-10, 10, (Np, 3)).astype(np.float32)
    n = rng.normal(size=(Np, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1 = np.cross(n, [0.3, 0.7, 0.64])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    l, m = j + t1.astype(np.float32), j + t2.astype(np.float32)
    p_p = se3.se3_apply(inv, torch.from_numpy((j + 0.3 * t1 + 0.2 * t2).astype(np.float32))).numpy()
    w_e = (rng.uniform(size=(1, Ne)) > 0.2).astype(np.float32)
    w_p = (rng.uniform(size=(1, Np)) > 0.2).astype(np.float32)

    def rows(x):
        return torch.from_numpy(np.ascontiguousarray(x.T, dtype=np.float32)).to(dev)

    args = (
        torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev), torch.zeros(3, device=dev),
        rows(p_e), rows(a), rows(b), torch.from_numpy(w_e).to(dev),
        rows(p_p), rows(j), rows(l), rows(m), torch.from_numpy(w_p).to(dev),
    )
    return true, args


def phase1_gn(rng, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import gn

    Ne, Np, iters = 768, 1536, 4
    true, args = _gn_problem(rng, Ne, Np, dev)
    q, t = gn.gn_inner_loop(*args, n_iters=iters)
    qr, tr = gn.gn_inner_loop_plain(*args, n_iters=iters)
    torch.cuda.synchronize()
    sign = torch.sign(torch.sum(q * qr))
    err = float(torch.max(torch.cat([(q - sign * qr).abs(), (t - tr).abs()])))
    # float32 sums in another order, fused multiply-adds in the kernel: 1e-4
    if not err <= 1e-4:
        raise AssertionError(f"gn_inner_loop disagrees with its plain version: {err}")
    if not float((t.cpu() - true.t).abs().max()) < 2e-3:
        raise AssertionError(f"gn_inner_loop did not recover the pose: {t} vs {true.t}")
    ms = _time_ms(lambda: gn.gn_inner_loop(*args, n_iters=iters), 200)
    plain_ms = _time_ms(lambda: gn.gn_inner_loop_plain(*args, n_iters=iters), 10)
    # per iteration about 260 float32 operations per edge (residual, weight,
    # three Jacobian rows, 3 x 27 products and sums) and 120 per plane
    n_ops = iters * (260 * Ne + 120 * Np)
    n_bytes = 4 * (10 * Ne + 13 * Np + 7 + 8)
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="gn_inner_loop", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/gn.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_gn.py:202",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None,
        shapes=f"edges (3,{Ne}), planes (3,{Np}), {iters} iterations",
        tolerance="atol 1e-4 on q and t",
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.kernels import _build
    from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    dev = torch.device("cuda")

    # ---- phase 0: the card, the toolchain, the build ----
    smi = _smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc seconds per source: {per_source})", flush=True)

    # ---- phase 1: each kernel against its plain version ----
    results = []
    rng = np.random.default_rng(SEED)
    for fn in (phase1_segsum, phase1_assoc, phase1_gn):
        r = fn(rng, dev)
        results.append(r)
        print(f"phase 1: {r['name']} [{r['shapes']}] max_abs_err {r['max_abs_err']:.3g} "
              f"({r['tolerance']}); kernel_ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, "
              f"library_ms {r['library_ms']}, bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']})", flush=True)

    # ---- phase 2: the main path at full width ----
    seq = synthetic.SyntheticSequence(
        n_frames=N_FRAMES, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    # threads, not processes: rendering is numpy, which releases the GIL, and
    # the script must leave no process behind
    with ThreadPoolExecutor(workers) as ex:
        scans = list(ex.map(seq.scan, range(N_FRAMES)))
    gt = np.stack([seq.pose(k)[1] for k in range(N_FRAMES)])
    print(f"phase 2: rendered {N_FRAMES} scans in {time.perf_counter() - t0:.1f} s "
          f"({workers} threads)", flush=True)

    with open(REFERENCE) as f:
        reference = json.load(f)
    jax_ate = reference["ate_m"]
    cfg = SystemConfig()
    OdometryPipeline(cfg, device="cuda").run_chunked(scans, chunk=8, ingest="polar2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = OdometryPipeline(cfg, device="cuda").run_chunked(scans, chunk=8, ingest="polar2")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = sum(res.per_frame_s[1:])
    ate = metrics.ate_rmse(res.positions, gt)
    peak = torch.cuda.max_memory_allocated()
    frames = N_FRAMES - 1
    dev_jax = float(np.abs(res.positions - np.asarray(reference["positions"])).max())
    print(f"phase 2: {frames} frames, {frames / wall:.2f} frames/s, "
          f"{1e3 * wall / frames:.3f} ms/frame, ATE {ate:.5f} m "
          f"(JAX CPU reference {jax_ate:.5f} m + {ATE_MARGIN}), largest position "
          f"difference from the JAX trajectory {dev_jax:.5f} m, peak device memory "
          f"{peak / 2**20:.1f} MiB, launches {counts}", flush=True)
    if res.positions.shape != (N_FRAMES, 3) or not np.isfinite(res.positions).all():
        raise AssertionError(f"bad trajectory: shape {res.positions.shape}")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {counts}")
    if not ate <= jax_ate + ATE_MARGIN:
        raise AssertionError(f"ATE {ate} m exceeds the JAX reference {jax_ate} + {ATE_MARGIN}")
    for r in results:
        r["launches"] = counts[r["name"]]

    line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}
        for r in results
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
