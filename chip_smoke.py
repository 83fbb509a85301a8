#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card (name and power limit from nvidia-smi), the torch and
         CUDA versions, and builds every CUDA kernel of the port from
         ``lidar_visual_odometry_tpu_torch/csrc`` (one nvcc per source, in
         parallel).
Phase 1  holds each kernel against its plain PyTorch version on the card, at
         the shapes the lidar odometry path (K1-K3), the mapping path (the
         flat K1, K4, K5) and the camera path (K6) give it, and the k-NN
         entry points off the product path (K7 in both output forms at the
         odometry association's shapes, K8 and K5p at the mapping shapes), and
         times kernel, plain version and (where one exists) the one PyTorch
         call that computes the same function. The mapping k-NN kernels search
         a world map built from the corridor's first nine frames with the
         frame-9 features as queries, so the windowed kernel's skip share is
         the path's own; K7 associates frame 9's features with frame 8's; K6
         tracks the features the path seeds on frame 0's image into frame
         1's, level by level as the path does. K1's two forms must also give
         ``segment_sum_run_order``'s sums bit for bit on sorted ids (the
         path's, a row all in the overflow bucket, runs of up to 1000
         points); they are timed before these checks, each in alternating
         rounds with ``index_add_`` (the median round of each), so that both
         sides are timed in one state of the host. K2 (edge and plane calls),
         K4 and K5 (corner and surf calls each) are timed so too, each call
         against the other, before their checks; all three must give their
         plain versions' outputs bit for bit, and so must K7, whose edge and
         plane calls are timed so too, each form beside its yardstick. K3 (1 and 4 iterations, so that an
         iteration's cost is on record) and K6 (its four calls) are timed so
         too; K6 must give its plain version's outputs bit for bit, K3 its
         plain version's pose within 1e-4 and the same bits on a second call.
         K9 (the feature selection, which replaces no TPU kernel) runs on
         frame 9's compacted scan, timed in alternating rounds with its plain
         version, whose outputs it must give bit for bit.
Phase 2  drives the odometry path at full width: ``OdometryPipeline(SystemConfig(),
         device="cuda").run_chunked(scans, chunk=8, ingest="polar2")`` on the
         48-frame synthetic HDL-64 corridor (64 rings x 2048 azimuth bins), one
         warm run and one timed run; it checks that every kernel of the path was
         launched in the timed run and that the trajectory's ATE is within
         0.01 m of the JAX package's ATE on the same sequence
         (``tools/jax_reference_corridor.json``, from ``tools/jax_reference_ate.py``).
Phase 3  drives the fused SLAM path at full width: ``FullPipeline(SystemConfig(),
         device="cuda").run_chunked(scans, chunk=8, map_skip=1,
         ingest="polar2")`` on the same 48 frames, one warm run and one timed
         run; it checks that the timed run launched every kernel of the path,
         that the mapped ATE is within 0.01 m of the JAX package's on the CPU
         (``tools/jax_reference_slam.json``, from ``tools/jax_reference_slam.py``)
         and that its odometry positions equal phase 2's.
Phase 3b runs the first 17 frames with ``MappingConfig(windowed_nn=False)``
         (the dense search, kernel K5) and checks that its mapped positions
         match phase 3's within 1e-4 m.
Phase 4  drives the camera path at full width: ``CamLidarPipeline(cfg,
         device="cuda").run_chunked(scans, images, chunk=8, ingest="polar2")``
         with the bench's cam-lidar configuration (640 x 192 camera, 768
         feature slots, ``utils/bench_config.py``) on the same 48 frames and
         their rendered camera images, one warm run and one timed run; it
         checks that the timed run launched every kernel of the path (K6 four
         times a frame), that ``ate_visual`` is within 0.01 m of the largest
         of the JAX package's on the CPU with its tracker on the Pallas
         kernel in interpret mode and of its four one-ulp members (the same
         run with ``fx`` or ``fy`` moved one float32 ulp up or down;
         ``tools/jax_reference_camlidar.json``, from
         ``tools/jax_reference_camlidar.py``), that its lidar positions
         equal phase 2's, and, from each JAX state of
         ``tools/jax_reference_corridor_steps.npz`` (frames 4, 8, ..., 48),
         that one port step lies within 2e-3 m and 1e-4 rad of JAX's plus
         JAX's own one-ulp spread there (phase 11's rule; the steps run on
         the natively packed scans, whose sha256 it prints beside the JAX
         packer's).
Phase 5  drives the k-NN entry points off the product path on every frame:
         ``associate_{edges,planes}_ringblocked`` (K7, index form) and
         ``associate_*_coords_top2`` (K7, coordinate form) at phase 2's
         relative poses must match the path's K2 association (valid masks,
         coordinates); each frame's mapping queries at phase 3's poses against
         the map of the frames before: K8 must match K5 (distances bit for
         bit, coordinates of K5's candidates), K5p must give K5's distances cut
         to 2^-8 and K5's indices except at ties of the cut distance (counted).
Phase 6  drives direct photometric VO at full width, the bench's fourth mode:
         ``DirectVOChunked(cam, cfg.visual, point_cap=2048,
         device="cuda").run_chunked(images, clouds, masks, chunk=8)`` with the
         cam-lidar configuration (640 x 192 camera, 4 pyramid levels, a
         5-keyframe window, BA at level 0 on 1024 points a keyframe over the
         14 pairs with |h - t| <= 2) on phase 4's images and the clouds
         ``CamLidarPipeline._cam_cloud`` makes of the 48 frames' scans, one
         warm run and one timed run. It prints frames/s, ms/frame, peak device
         memory, the tracker's iterations and the BA's rounds a frame, and
         checks that the trajectory is finite, that the two runs give the
         same bits (the BA sums its blocks in a fixed order), and that
         ``ate_direct`` (the poses mapped to the lidar frame, no alignment) is
         within 0.01 m of the JAX package's on the CPU
         (``tools/jax_reference_direct.json``, from
         ``tools/jax_reference_direct.py``); it prints the largest position
         and quaternion difference from that trajectory, and from the JAX
         package's per-frame host loop, and fails when the positions lie
         more than 5e-3 m from the host loop's (the port measured 1.2e-3 m
         on the H100; the JAX chunk's jitted BA keeps other lowest-chi^2
         iterates, up to 0.17 m away at frames 18-19). No kernel of the port
         lies on this path (the JAX package runs no Pallas kernel there
         either).
Phase 7  runs the per-frame drivers, the default ingests and checkpoint /
         resume at full width against ``tools/jax_reference_drivers.json``.
Phase 8  runs the cam-lidar coupled and mapping modes and the IMU-fused
         odometry at full width against ``tools/jax_reference_modes.json``
         (from ``tools/jax_reference_modes.py``; the JAX runs' inputs, IMU
         stream included, must hash alike): 8a
         ``CamLidarPipeline(cfg).run_chunked(scans[:17], images[:17], chunk=8,
         ingest="polar2", coupled=True)``, its lidar ATE within 0.01 m of
         the JAX run's and its ``ate_visual`` within 0.01 m of the largest
         of the JAX run's and its four one-ulp members' (every visual gate
         of 8a-8d so), K1-K3 and K6 launched, K6 four
         times a tracked frame; 8b ``mapping=True``, its mapped ATE within
         0.01 m of the JAX run's, its lidar and visual positions phase 4's
         and its mapped positions phase 3's, bit for bit (the same
         operations); 8c both, its mapped ATE gated alike, its lidar and
         visual positions 8a's bit for bit (mapping does not feed back); 8d
         8c stopped after frame 8 and resumed from its checkpoint, 8c's bit
         for bit; 8e ``ImuFusedOdometry(SystemConfig()).process`` frame by
         frame with the bundles of ``synthesize_imu(seq, frame_period=0.1,
         rate_hz=100.0)`` over the first 17 frames, its fused ATE within
         0.01 m of the JAX run's over the same frames, its positions within
         1e-3 m of the JAX run's and nearer to them than the same run's
         odometry alone, K1-K3 launched, the window solve's and the
         odometry's ms a frame printed.
Phase 9  runs the distributed layer (``parallel/``) at full width over the
         first 17 frames against ``tools/jax_reference_parallel.json`` (from
         ``tools/jax_reference_parallel.py``: the JAX package on the CPU over 8
         virtual devices; the inputs must hash alike):
         ``DistributedSlamPipeline(SystemConfig()).run``, the coupled
         ``DistributedCamLidarPipeline(camlidar_config()).run`` and
         ``sharded_refine`` on a 5-keyframe direct-VO window (1024 points,
         level 0, pairs within 2). 9a on one NCCL rank in this process: each
         ATE (odometry, mapped, ``ate_visual``) within 0.01 m of the JAX
         run's (``ate_visual``: of the largest of the JAX run's and its four
         one-ulp members'), the SLAM's positions within 5e-4 m (odometry) and 5e-3 m
         (mapped) of 7d's ``FullPipeline(device_map=False).run``, K1, the
         flat K1, K2 and K6 (four a tracked frame) launched, K3 not (it is
         left under a reduction). 9b on two gloo ranks on the one card with
         CUDA tensors (NCCL refuses two ranks on one GPU), started by
         ``parallel.launch``: the same runs and gates in each rank, the ranks
         agreeing within 1e-6 on every pose, their odometry positions within
         2e-3 m of 9a's and their mapped ones within 5e-3 m, and
         ``sharded_refine``'s positions within 1e-3 m of JAX's.
Phase 10 writes the first 17 scans as a KITTI sequence (``.bin``,
         ``times.txt``, ``calib.txt``, poses), runs
         ``scripts/run_kitti_torch.py --mapping --device cuda`` on it and
         demands its trajectory file equal, bit for bit, the same
         ``FullPipeline.run_chunked`` on the scans in memory, and
         ``NativeScanReader`` return the scans bit for bit.
Phase 11 renders three of ``scripts/eval_regimes_torch.py``'s regimes at full
         width (``rotation_heavy``, 41 frames; ``revisit_out_and_back``, 45;
         ``high_noise``, 30; images for the first two) and holds them against
         ``tools/jax_reference_regimes.json`` (from
         ``tools/jax_reference_regimes.py``; the inputs must hash alike). It
         prints each regime's native-packed images' sha256 beside the JAX
         packer's (not gated: ``-march=native`` may round otherwise on
         another CPU); on the corridor's frames 1-8 it counts the cells
         where the native and the numpy packer differ (failing above 0.05%
         of the range cells) and times both in alternating rounds. On each
         regime ``FullPipeline(SystemConfig()).run_chunked(scans, chunk=8,
         map_skip=1, ingest="polar2")``: odometry and mapped ATE (no
         alignment, as the eval script) each within 0.01 m of the JAX
         run's; on the first two ``CamLidarPipeline(camlidar_config())
         .run_chunked(scans, images, chunk=8, ingest="polar")``, whose
         ``ate_visual`` is printed beside JAX's and not gated (the camera
         drifts metres on these regimes, and one track's rounding moves
         that by centimetres). K1-K4 and K6 launched, K6 four times a
         tracked frame. The camera gate: from each JAX visual state of
         ``tools/jax_reference_regime_steps.npz`` (every fourth frame of the
         two regimes, from ``tools/camera_step_diff.py --write-steps``) one
         port step (``visual_frontend.chunk_frame_step``) on the frame's
         image and natively packed scan lies within 2e-3 m and 1e-4 rad of
         the step JAX took from it, plus how far JAX's own step moved when
         the state was nudged by one ulp.
Phase 12 runs one lap of the long-horizon stress drives (``--laps 1 --leg
         6 --turn 14``: 41 frames at 1800 samples, a leg, a 180-degree
         U-turn, the leg back, a second U-turn) through the ``main`` of
         ``scripts/stress_long_torch.py`` (fused SLAM on the polar2 ingest,
         a mid-run snapshot of its states resumed) and
         ``scripts/stress_visual_torch.py`` (coupled cam-lidar with mapping
         and direct VO, each stopped mid-run and resumed) at their default
         configurations, caches in a temporary directory, against
         ``tools/jax_reference_stress.json`` (the inputs must hash alike):
         every resumed run bit for bit the uninterrupted one, the SLAM's
         odometry and mapped ATEs and the coupled run's lidar and mapped
         ATEs each within 0.01 m of the JAX run's; the visual and direct
         ATEs printed beside JAX's (the U-turn blinds the camera). K1-K4
         launched, K6 too in the visual script.

Phase 13 runs ``scripts/diag_visual_torch.py``'s four passes (``base``,
         ``gt_depth``, ``gt_flow``, ``gt_both``: the visual frontend frame
         by frame with ground-truth depth, flow or both swapped in) on the
         corridor's 48 frames and images with phase 0's ground-truth depth
         maps, through its ``main``, against ``tools/jax_reference_diag.json``
         (from ``tools/jax_reference_diag.py``; the inputs, depth maps
         included, must hash alike): ``gt_both``'s ATE within 0.01 m of the
         JAX run's, each other pass's within 0.01 m of the largest of the
         JAX run's and its four one-ulp members'; K6 launched four times a
         tracked frame of every pass. It prints ``gt_depth`` − ``base`` on
         both sides: how much of each one's camera drift comes from the
         lidar depths.
Phase 14 runs ``scripts/bench_scaling_torch.py`` (the distributed odometry,
         mapping and BA stages of ``scripts/bench_scaling.py``'s fixtures on
         ``parallel.launch`` fleets: one NCCL rank, two gloo ranks on the
         one card) through its ``main`` and prints its rows: the ranks of a
         fleet agreeing within 1e-6, the two ranks' poses within 2e-3 m
         (odometry, mapping) and 1e-3 m (BA) of the one rank's, K2 launched
         in each fleet.

Prints one JSON line with all eleven kernels' numbers, K7's two output forms
in two rows (launches counted on the
path that runs the kernel: phase 2 for K1-K3 and K9, phase 3 for the flat K1 and K4,
phase 3b for K5, phase 4 for K6, phase 5 for K7, K8 and K5p), the nvidia-smi
line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result line,
when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import tempfile
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# Scans and images are rendered in threads. numpy's OpenBLAS, called from
# several Python threads with several BLAS threads each, has corrupted renders
# (points metres off, an image pixel off by 0.67; ROADMAP C.5); with one BLAS
# thread every threaded render equals the serial one. Set before numpy is
# first imported.
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402

# The JAX package's lidar odometry on this script's sequence and
# configuration, run on the CPU by tools/jax_reference_ate.py: its ATE gates
# the port's (plus ATE_MARGIN), its positions are compared for information.
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "jax_reference_corridor.json")
# The JAX package's fused SLAM on the same sequence, run on the CPU by
# tools/jax_reference_slam.py: its mapped ATE gates the port's.
SLAM_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "jax_reference_slam.json")
# The JAX package's cam-lidar pipeline on the same sequence and images, run on
# the CPU by tools/jax_reference_camlidar.py: its ate_visual gates the port's.
CAMLIDAR_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tools", "jax_reference_camlidar.json")
# The JAX package's direct VO on the same sequence, images and clouds, run on
# the CPU by tools/jax_reference_direct.py: its ate_direct gates the port's.
DIRECT_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools", "jax_reference_direct.json")
# The JAX package's per-frame drivers and default ingests on the same sequence
# and images, run on the CPU by tools/jax_reference_drivers.py: phase 7's gates.
DRIVERS_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tools", "jax_reference_drivers.json")
# The JAX package's coupled and mapping cam-lidar modes and its IMU-fused
# odometry on the same sequence, images and IMU stream, run on the CPU by
# tools/jax_reference_modes.py: phase 8's gates.
MODES_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tools", "jax_reference_modes.json")
# The JAX package's distributed drivers and sharded BA on the same sequence's
# first 17 frames, run on the CPU over 8 virtual devices by
# tools/jax_reference_parallel.py: phase 9's gates.
PARALLEL_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tools", "jax_reference_parallel.json")
# The JAX package on three of scripts/eval_regimes.py's regimes (the bench's
# SLAM call on each, the eval script's plain visual call on the first two),
# run on the CPU by tools/jax_reference_regimes.py: phase 11's gates.
REGIMES_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tools", "jax_reference_regimes.json")
# The JAX visual frontend's carried state at every fourth frame of phase 11's
# two camera regimes and the step it takes from each, written on the CPU by
# tools/camera_step_diff.py --write-steps: phase 11's camera gate.
REGIME_STEPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tools", "jax_reference_regime_steps.npz")
# The same on phase 4's corridor (every fourth frame from 4, the polar2
# ingest), written by tools/camera_step_diff.py --write-steps corridor:
# phase 4's camera step gate.
CORRIDOR_STEPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "jax_reference_corridor_steps.npz")
# The JAX package on one lap of the stress drives (scripts/stress_long.py's
# and scripts/stress_visual.py's calls), run on the CPU by
# tools/jax_reference_stress.py: phase 12's gates.
STRESS_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools", "jax_reference_stress.json")
# The JAX package's scripts/diag_visual.py on the corridor's 48 frames, each
# pass's ATE and its one-ulp members (tools/jax_reference_diag.py): phase 13.
DIAG_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "jax_reference_diag.json")
ROOT = os.path.dirname(os.path.abspath(__file__))
ATE_MARGIN = 0.01
SHORT_FRAMES = 17     # phase 7: the per-frame SLAM and the camera runs
CHECKPOINT_EVERY, STOP_AFTER = 8, 24   # phase 7f
MODES_STOP_AFTER = 8    # phase 8d
# phase 8e: the reference's first 17 frames (its fusion is causal). Over all
# 49 the window solves took 33 s on an H100 (0.72 s a solve), above the 15 s
# the phase may take.
IMU_FRAMES = 17
HOST_LOOP_TOL_M = 5e-3   # phase 6: positions against the JAX per-frame host loop
# phase 8e: fused positions against the JAX fuser's (3.5e-4 m measured on an
# H100). The ATE margin alone cannot tell fusion from none, nor can this
# limit alone: the fuser's own odometry lies 6.8e-4 m from the JAX fuser's
# positions on an H100, so the fused ones must also lie nearer than it.
IMU_TOL_M = 1e-3
DENSE_FRAMES = 17     # phase 3b
DENSE_TOL_M = 1e-4
MAP_FRAMES = 9        # phase 1: frames merged into the k-NN kernels' world map
# phase 9: the kernels of the distributed path (K1, the flat K1, K2; K6 too on
# the cam-lidar driver); ranks agree within RANKS_AGREE on every pose
# (tests/test_multiprocess.py's bound); the gloo fleet's odometry positions
# and mapped positions lie within 2e-3 m of the NCCL rank's (a missing
# reduction would solve from half the features); the sharded BA's
# positions within BA_TOL_M of JAX's; the NCCL rank's SLAM within
# HOST_MAP_TOL_M (odometry, mapped) of FullPipeline(device_map=False).run
# (tests/test_parallel.py's bounds)
PARALLEL_PATH = ("segment_sum_batched", "segment_sum", "associate_kernel")
RANKS_AGREE = 1e-6
GLOO_VS_NCCL_M = {"slam_odometry": 2e-3, "camlidar_lidar": 2e-3, "slam_mapped": 2e-3,
                  "camlidar_mapped": 2e-3}
BA_TOL_M = 1e-3
HOST_MAP_TOL_M = (5e-4, 5e-3)
# phase 14: scripts/bench_scaling_torch.py's two-rank stages against its one
# rank (phase 9b's bound for the lidar stages, BA_TOL_M for the BA's)
SCALING_REPS = 10
SCALING_VS_1_RANK_M = {"odometry": 2e-3, "mapping": 2e-3, "ba": BA_TOL_M}

# phase 11: the native and the numpy packer on the corridor's frames 1-8 may
# differ in at most this share of range cells (0.0065% measured, ROADMAP A.13)
PACKER_DIFF_SHARE = 5e-4
PACKER_FRAMES = slice(1, 9)
# phase 11's camera gate: from each JAX state of REGIME_STEPS the port's step
# lies within STEP_TOL_M (translation, largest axis) and STEP_TOL_RAD
# (rotation) of the JAX step, plus how far JAX's own step moved when the
# state was nudged by one ulp (5 cm at the revisit's frame 18, where the step
# has two answers). The port's CPU steps lie within 3.7e-4 m and 1.6e-5 rad
# elsewhere (tools/camera_step_diff.py). A trajectory cannot be gated: one
# track's rounding parts two runs by centimetres within a few frames
# (PERF.md §6, PR 14), and the camera drifts metres on these regimes.
STEP_TOL_M = 2e-3
STEP_TOL_RAD = 1e-4

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


def _sha256(arrays) -> str:
    """sha256 over the arrays' bytes in order, as the reference tools digest
    their inputs."""
    digest = hashlib.sha256()
    for arr in arrays:
        digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def _check_inputs(phase: str, ref: dict, digest: str) -> None:
    """A phase gates on a reference only for the inputs the reference ran."""
    if digest != ref["inputs_sha256"]:
        raise AssertionError(f"phase {phase}: the inputs hash to {digest[:16]}, the reference's "
                             f"to {ref['inputs_sha256'][:16]}: they are not the reference's")


def _ensemble(want_ate: float, members: list) -> tuple[float, str]:
    """A camera trajectory gate's base: the largest ``ate_visual`` of the JAX
    run and its one-ulp members (the run with one camera intrinsic moved by
    one float32 ulp, ``tools/jax_reference_camlidar.ulp_members``), and a
    text giving the members' range."""
    ates = [mem["ate_visual_m"] for mem in members]
    if len(ates) != 4:
        raise AssertionError(f"the reference holds {len(ates)} one-ulp members, not 4")
    names = ", ".join(f"{mem['intrinsic']} {mem['direction']}" for mem in members)
    return max(want_ate, *ates), (f"JAX one-ulp members ({names}) {min(ates):.5f}-"
                                  f"{max(ates):.5f} m")


def _packed_sha256(scans) -> str:
    """sha256 of the port's native packer's polar2 images of every frame,
    then its polar images, at the pipelines' lidar geometry: the reference
    tools' ``packed_sha256`` of the JAX packer."""
    from lidar_visual_odometry_tpu_torch.data import native_pack
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    lcfg = SystemConfig().lidar
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range)
    return _sha256((native_pack.pack_polar_chunk(scans, channels=1, **geom),
                    native_pack.pack_polar_chunk(scans, channels=2, **geom)))


def _packed_text(scans, ref: dict) -> str:
    """The native packer's images' sha256 beside the JAX packer's for the
    same scans: reported, not gated (``-march=native`` may round otherwise
    on another CPU)."""
    got, want = _packed_sha256(scans), ref["packed_sha256"]
    return (f"natively packed images sha256 {got[:16]} ({'the same as' if got == want else 'not'}"
            f" the JAX packer's {want[:16]})")


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


def _time_alternating_ms(fns, iters, rounds: int = 5) -> list[float]:
    """``_time_ms`` of each of ``fns`` in ``rounds`` alternating rounds: the
    median round of each. Calls whose time is mostly host time move with the
    host's state; alternating gives each the same states. ``iters``: one
    count for all, or one a function."""
    counts = iters if isinstance(iters, (list, tuple)) else [iters] * len(fns)
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn, n in zip(times, fns, counts):
            t.append(_time_ms(fn, n))
    return [float(np.median(t)) for t in times]


def _segsum_checks(form, seg_t, vals_t, S, rng, dev):
    """Hold one K1 form on the path-like ids (``seg_t``, sorted), on a row
    all in the overflow bucket and on long runs to ``segment_sum_run_order``
    bit for bit, and on the path-like ids and on ids in no order to the plain
    version within rtol 1e-5, atol 1e-3 (the same values summed in another
    order: the plain version adds with atomics on the card; the long sums of
    the extra cases are held to the ordered sums alone, since an atomic
    order's rounding over thousands of terms exceeds that tolerance).
    Returns the largest difference from the plain version."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import segsum

    kernel = segsum.segment_sum_batched if form == "batched" else segsum.segment_sum
    plain = segsum.segment_sum_batched_plain if form == "batched" else segsum.segment_sum_plain
    W = seg_t.shape[-1]
    lengths = np.tile([3, 33, 1, 300, 7, 1000, 2], -(-W // 1346))
    long_runs = np.minimum(np.repeat(np.arange(len(lengths)), lengths)[:W], S - 1)
    sorted_cases = {
        "path": seg_t,
        "all bucket": torch.full_like(seg_t, S - 1),
        "long runs": torch.from_numpy(long_runs.astype(np.int32)).to(dev).expand_as(seg_t).contiguous(),
    }
    for case, ids in sorted_cases.items():
        out = kernel(ids, vals_t, n_segments=S)
        want = segsum.segment_sum_run_order(ids, vals_t, n_segments=S)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{form} segment sum ({case}) differs from the ordered sums "
                                 f"by {float((out - want).abs().max())}")
    out = kernel(seg_t, vals_t, n_segments=S)
    ref = plain(seg_t, vals_t, n_segments=S)
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"{form} segment sum disagrees with its plain version: {err}")
    ids = torch.from_numpy(rng.integers(-1, S + 1, tuple(seg_t.shape)).astype(np.int32)).to(dev)
    out = kernel(ids, vals_t, n_segments=S)
    ref = plain(ids, vals_t, n_segments=S)
    err = max(err, float((out - ref).abs().max()))
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"{form} segment sum (unsorted ids) disagrees: {err}")
    return err


def phase1_segsum(rng, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import segsum

    R, C, W, S = 64, 4, 2048, 513          # less-flat voxel filter, per frame
    # as the voxel filter produces them: sorted runs of a few points per
    # voxel, then every masked point of the ring in the overflow bucket S-1,
    # whose values are zero
    seg = np.full((R, W), S - 1, np.int32)
    vals = rng.normal(scale=30.0, size=(R, C, W)).astype(np.float32)
    for r in range(R):
        n_valid = int(rng.integers(800, 1800))
        seg[r, :n_valid] = np.sort(rng.integers(0, S - 1, n_valid))
        vals[r, :, n_valid:] = 0.0
    seg_t = torch.from_numpy(seg).to(dev)
    vals_t = torch.from_numpy(vals).to(dev)
    flat_ids = (seg_t.to(torch.int64) + S * torch.arange(R, device=dev)[:, None]).reshape(-1)
    vals_rows = vals_t.permute(0, 2, 1).reshape(R * W, C).contiguous()

    def library():
        return torch.zeros((R * S, C), device=dev).index_add_(0, flat_ids, vals_rows)

    ms, library_ms = _time_alternating_ms(
        (lambda: segsum.segment_sum_batched(seg_t, vals_t, n_segments=S), library), 200)
    plain_ms = _time_ms(lambda: segsum.segment_sum_batched_plain(seg_t, vals_t, n_segments=S), 200)
    err = _segsum_checks("batched", seg_t, vals_t, S, rng, dev)
    ref = segsum.segment_sum_batched_plain(seg_t, vals_t, n_segments=S)
    lib_out = library().reshape(R, S, C).permute(0, 2, 1)
    if not torch.allclose(lib_out, ref, rtol=1e-5, atol=1e-3):
        raise AssertionError("index_add_ yardstick disagrees with the plain version")
    bound, by = _bound_ms(4 * (R * W + R * C * W + R * C * S), R * C * W)
    return dict(
        name="segment_sum_batched", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/segsum.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_segsum.py:41",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
        shapes=f"seg ({R},{W}) i32, vals ({R},{C},{W}) f32, S={S}",
        tolerance="sorted ids: the ordered sums bit for bit; all: rtol 1e-5, atol 1e-3",
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

    calls = {"edges": (768, 64, 120), "planes": (1536, 64, 512)}
    inputs = {kind: _assoc_inputs(rng, Q, R, B, dev) for kind, (Q, R, B) in calls.items()}
    # timed before the checks, the two calls in alternating rounds (median of five)
    per_call = dict(zip(calls, _time_alternating_ms(
        [partial(nn.associate_kernel, q, c, nearby_scan=2.5) for q, c in inputs.values()], 100)))
    plain_ms = err = 0.0
    n_bytes = n_ops = 0
    shapes = []
    for kind, (Q, R, B) in calls.items():
        q, c = inputs[kind]
        out = nn.associate_kernel(q, c, nearby_scan=2.5)
        ref = nn.associate_kernel_plain(q, c, nearby_scan=2.5)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        # the same distances without contraction and the same tie rules: the
        # plain version's rows bit for bit
        if not torch.equal(out, ref):
            raise AssertionError(f"associate_kernel differs from its plain version at Q={Q}, "
                                 f"B={B}: {e}")
        err = max(err, e)
        plain_ms += _time_ms(lambda: nn.associate_kernel_plain(q, c, nearby_scan=2.5), 10)
        n_bytes += 4 * (Q * 3 + R * B * 3 + Q * 16)
        n_ops += 8 * Q * R * B        # 3 sub, 3 mul, 2 add per distance
        shapes.append(f"{kind} Q={Q} vs ({R},{B},3) {per_call[kind]:.4f} ms")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="associate_kernel", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/nn.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_nn.py:220",
        max_abs_err=err, ms=sum(per_call.values()), plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None,
        shapes="edges + planes (one re-association round): " + ", ".join(shapes),
        tolerance="exact (atol 0)",
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
    # timed before the checks: 1 and 4 iterations in alternating rounds
    # (median of five), so that the cost of an iteration is on record
    ms_1, ms = _time_alternating_ms(
        [partial(gn.gn_inner_loop, *args, n_iters=n) for n in (1, iters)], 200)
    q, t = gn.gn_inner_loop(*args, n_iters=iters)
    q2, t2 = gn.gn_inner_loop(*args, n_iters=iters)
    qr, tr = gn.gn_inner_loop_plain(*args, n_iters=iters)
    torch.cuda.synchronize()
    sign = torch.sign(torch.sum(q * qr))
    err = float(torch.max(torch.cat([(q - sign * qr).abs(), (t - tr).abs()])))
    # float32 sums in another order, fused multiply-adds in the kernel: 1e-4
    if not err <= 1e-4:
        raise AssertionError(f"gn_inner_loop disagrees with its plain version: {err}")
    # the kernel's sums run in a fixed order: the same bits on every call
    if not (torch.equal(q, q2) and torch.equal(t, t2)):
        raise AssertionError("gn_inner_loop gave two poses for the same inputs")
    if not float((t.cpu() - true.t).abs().max()) < 2e-3:
        raise AssertionError(f"gn_inner_loop did not recover the pose: {t} vs {true.t}")
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
        library_ms=None, ms_1_iteration=ms_1,
        shapes=f"edges (3,{Ne}), planes (3,{Np}), {iters} iterations",
        tolerance="atol 1e-4 on q and t; repeated calls bit for bit",
    )


def phase1_flat_segsum(rng, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import segsum

    C, S = 4, 4097                         # mapping voxel filters, max_out 4096
    ms = plain_ms = library_ms = 0.0
    err = 0.0
    n_bytes = n_ops = 0
    shapes = []
    # (W, valid points, share of points that start a new voxel): less-flat
    # at 0.8 m, less-sharp at 0.4 m
    for W, n_valid, p_new in ((32768, 16000, 0.15), (7680, 5000, 0.6)):
        # as the voxel filter produces them: non-decreasing run ids, the
        # masked points (zero values) in the overflow bucket S - 1
        seg = np.full(W, S - 1, np.int32)
        seg[:n_valid] = np.minimum(np.cumsum(rng.uniform(size=n_valid) < p_new), S - 1)
        vals = rng.normal(scale=30.0, size=(C, W)).astype(np.float32)
        vals[:, n_valid:] = 0.0
        seg_t = torch.from_numpy(seg).to(dev)
        vals_t = torch.from_numpy(vals).to(dev)
        ids = seg_t.to(torch.int64)
        vals_rows = vals_t.T.contiguous()

        def library():
            return torch.zeros((S, C), device=dev).index_add_(0, ids, vals_rows)

        k_ms, lib_ms = _time_alternating_ms(
            (lambda: segsum.segment_sum(seg_t, vals_t, n_segments=S), library), 200)
        ms += k_ms
        library_ms += lib_ms
        plain_ms += _time_ms(lambda: segsum.segment_sum_plain(seg_t, vals_t, n_segments=S), 200)
        err = max(err, _segsum_checks("flat", seg_t, vals_t, S, rng, dev))
        ref = segsum.segment_sum_plain(seg_t, vals_t, n_segments=S)
        if not torch.allclose(library().T, ref, rtol=1e-5, atol=1e-3):
            raise AssertionError("index_add_ yardstick disagrees with the plain version")
        n_bytes += 4 * (W + C * W + C * S)
        n_ops += C * W
        shapes.append(f"W={W}")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="segment_sum", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/segsum.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_segsum.py:72",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms,
        shapes="seg (W,) i32, vals (4, W), S=4097, both mapping filters: " + ", ".join(shapes),
        tolerance="sorted ids: the ordered sums bit for bit; all: rtol 1e-5, atol 1e-3",
    )


def _map_frames(imgs, poses, dev):
    """For each frame k of the packed polar images: its features, its
    downsampled corner and surf features placed in the world by poses[k] (with
    their masks), and the bounded voxel maps of frames 0..k-1, merged as the
    mapping path merges them (the maps grow after each yield)."""
    from lidar_visual_odometry_tpu_torch.models import device_mapping as dm
    from lidar_visual_odometry_tpu_torch.models import scan_registration as sr
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.ops import se3
    from lidar_visual_odometry_tpu_torch.ops.voxel_map import voxel_merge
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    lcfg, mcfg = cfg.lidar, cfg.mapping
    state = dm.init_state(mcfg, dev)
    maps = {"corner": (state.corner, state.corner_mask), "surf": (state.surf, state.surf_mask)}
    classes = (("corner", "less_sharp", mcfg.corner_leaf, mcfg.corner_slot, mcfg.map_corner_cap),
               ("surf", "less_flat", mcfg.surf_leaf, mcfg.surf_slot, mcfg.map_surf_cap))
    for k in range(imgs.shape[0]):
        feats = sr.register_polar_impl(imgs[k], lcfg).features
        queries = {}
        for name, field, leaf, slot, cap in classes:
            fc = getattr(feats, field)
            ds = pc.voxel_downsample(fc.xyz, fc.mask, leaf=leaf, max_out=slot)
            queries[name] = (se3.se3_apply(poses[k], ds.xyz), ds.mask)
        yield k, feats, queries, maps
        for name, field, leaf, slot, cap in classes:
            merged = voxel_merge(*maps[name], *queries[name], poses[k].t, leaf=leaf, cap=cap,
                                 drop_radius=mcfg.map_drop_radius)
            maps[name] = (merged.xyz, merged.mask)


def _pack(scans, dev):
    """The scans as the polar2 ingest packs them (the native packer)."""
    from lidar_visual_odometry_tpu_torch.data import native_pack
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    lcfg = SystemConfig().lidar
    return pc.polar_image_to_tensor(native_pack.pack_polar_chunk(
        scans, n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
        max_range=lcfg.max_range, channels=1), dev)


def _pose(q, t, dev):
    import torch

    from lidar_visual_odometry_tpu_torch.ops import se3

    return se3.Pose(torch.tensor(q, dtype=torch.float32, device=dev),
                    torch.tensor(t, dtype=torch.float32, device=dev))


def _world_map(scans, seq, dev):
    """The corridor's first MAP_FRAMES frames merged into the bounded voxel
    maps at their true poses, and the next frame's downsampled features in the
    world frame, as the mapping path searches them. Also the odometry
    association's inputs between the last two of these frames: that frame's
    sharp (flat) features moved by the true relative pose, against the frame
    before's less-sharp (less-flat) cloud in its ring-major blocks, baked."""
    from lidar_visual_odometry_tpu_torch.kernels import nn
    from lidar_visual_odometry_tpu_torch.ops import se3
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    poses = []
    for k in range(MAP_FRAMES + 1):
        yaw = seq.yaw_rate * k
        poses.append(_pose([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                           seq.pose(k)[1] - seq.pose(0)[1], dev))
    R = cfg.odometry.n_rings
    prev = None
    for k, feats, queries, maps in _map_frames(_pack(scans[:MAP_FRAMES + 1], dev), poses, dev):
        if k < MAP_FRAMES:
            prev = feats
            continue
        rel = se3.se3_compose(se3.se3_inverse(poses[k - 1]), poses[k])
        assoc = {
            kind: (se3.se3_apply(rel, cur.xyz).contiguous(),
                   nn.bake_mask(old.xyz.reshape(R, -1, 3), old.mask.reshape(R, -1)).contiguous())
            for kind, cur, old in (("edges", feats.sharp, prev.less_sharp),
                                   ("planes", feats.flat, prev.less_flat))
        }
        return (dict(maps), {name: (queries[name][0], poses[k]) for name in queries},
                cfg.mapping, assoc)


def _knn_inputs(maps, queries, mcfg, name):
    """K4's inputs as ``lidar_mapping.solve_map_pose`` builds them: the map
    baked and sorted by cell key, the queries sorted by cell key."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import topk

    q, pose = queries[name]
    origin = pose.t[:2] - (mcfg.nn_grid_w // 2) * mcfg.nn_cell
    ckw = dict(cell=mcfg.nn_cell, grid_w=mcfg.nn_grid_w)
    c_sorted, c_keys = topk.sort_by_cell(*maps[name], origin, **ckw)
    keys = topk.cell_keys(q, origin, **ckw)
    order = torch.sort(keys, stable=True).indices
    return q[order].contiguous(), keys[order].contiguous(), c_sorted, c_keys


def phase1_topk_windowed(maps, queries, mcfg):
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import topk

    kw = dict(k=mcfg.knn, q_tile=mcfg.nn_q_tile, c_tile=512, grid_w=mcfg.nn_grid_w)
    names = ("corner", "surf")
    inputs = {name: _knn_inputs(maps, queries, mcfg, name) for name in names}
    # timed before the checks, the two calls in alternating rounds (median of five)
    per_call = dict(zip(names, _time_alternating_ms(
        [partial(topk.block_topk_windowed, *inputs[name], **kw) for name in names], 100)))
    plain_ms = 0.0
    n_bytes = n_ops = 0
    pairs = total = 0
    shapes = []
    for name in names:
        q, q_keys, c_sorted, c_keys = inputs[name]
        d, i = topk.block_topk_windowed(q, q_keys, c_sorted, c_keys, **kw)
        dp, ip = topk.block_topk_windowed_plain(q, q_keys, c_sorted, c_keys, **kw)
        torch.cuda.synchronize()
        # the same chunks, the same float32 expression without contraction and
        # the same tie rule: identical distances and indices
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"block_topk_windowed disagrees with its plain version ({name}): "
                                 f"{float((d - dp).abs().max())}")
        plain_ms += _time_ms(
            lambda: topk.block_topk_windowed_plain(q, q_keys, c_sorted, c_keys, **kw), 5)
        hits = topk.chunk_hits(q_keys, c_keys, q_tile=kw["q_tile"], c_tile=512,
                               grid_w=mcfg.nn_grid_w)
        hit_pairs = int(hits.sum()) * kw["q_tile"] * 512
        pairs += hit_pairs
        total += q.shape[0] * c_sorted.shape[0]
        Q, C = q.shape[0], c_sorted.shape[0]
        n_bytes += 4 * (4 * Q + 4 * C + 2 * mcfg.knn * Q)
        n_ops += 8 * hit_pairs        # 3 sub, 3 mul, 2 add per considered pair
        shapes.append(f"Q={Q} x C={C} ({name}, {float(hits.float().mean()):.3f} of "
                      f"(tile, chunk) pairs read, {per_call[name]:.4f} ms)")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="block_topk_windowed", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/topk.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_nn.py:488",
        max_abs_err=0.0, ms=sum(per_call.values()), plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, skip_share=1.0 - pairs / total,
        shapes="one mapping round, k 5, q_tile 256, c_tile 512: " + ", ".join(shapes),
        tolerance="exact (atol 0), identical indices",
    )


def phase1_topk_dense(maps, queries, mcfg):
    """K5 on the frame-9 corner and surf queries against the world map: both
    calls timed in alternating rounds (median of five) before the checks,
    which demand the plain version's distances and indices bit for bit."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import nn, topk

    k = mcfg.knn
    names = ("corner", "surf")
    inputs = {name: (queries[name][0].contiguous(), nn.bake_mask(*maps[name]).contiguous())
              for name in names}
    per_call = dict(zip(names, _time_alternating_ms(
        [partial(topk.block_topk, q, c, k=k) for q, c in inputs.values()], 50)))
    plain_ms = two_calls_ms = 0.0
    n_bytes = n_ops = 0
    shapes = []
    for name in names:
        q, c = inputs[name]
        Q, C = q.shape[0], c.shape[0]
        d, i = topk.block_topk(q, c, k=k)
        dp, ip = topk.block_topk_plain(q, c, k=k)
        torch.cuda.synchronize()
        # as block_topk_windowed: identical distances and indices
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"block_topk disagrees with its plain version ({name}): "
                                 f"{float((d - dp).abs().max())}")
        plain_ms += _time_ms(lambda: topk.block_topk_plain(q, c, k=k), 3)
        # for information only: torch.cdist + torch.topk, two calls (cdist's
        # matrix-product distances round otherwise, and topk's ties are unordered)
        two_calls_ms += _time_ms(lambda: torch.topk(torch.cdist(q, c), k, largest=False), 20)
        n_bytes += 4 * (3 * Q + 3 * C + 2 * k * Q)
        n_ops += 8 * Q * C
        shapes.append(f"Q={Q} x C={C} ({name}, {per_call[name]:.4f} ms)")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="block_topk", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/topk.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_nn.py:590",
        max_abs_err=0.0, ms=sum(per_call.values()), plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, cdist_topk_two_calls_ms=two_calls_ms,
        shapes=f"one mapping round, k {k}: " + ", ".join(shapes),
        tolerance="exact (atol 0), identical indices",
    )


def phase1_ring_top2(assoc, coords):
    """K7 at the odometry association's shapes, in one output form: the edge
    and plane calls and their yardsticks timed in alternating rounds (median
    of five) before the checks, which demand the plain version's outputs bit
    for bit."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import nn

    fn = nn.ring_top2_coords if coords else nn.ring_top2_pallas
    plain = nn.ring_top2_coords_plain if coords else nn.ring_top2_pallas_plain
    kinds = ("edges", "planes")

    def yardstick(q, c):
        # for information only: cdist + topk (+ the coordinate gather);
        # cdist's matrix-product distances round otherwise
        Q, (R, B, _) = q.shape[0], c.shape
        top = torch.topk(torch.cdist(q, c.reshape(-1, 3)).reshape(Q, R, B), 2, dim=2,
                         largest=False)
        return c[torch.arange(R, device=q.device)[None, :, None], top.indices] if coords else top

    times = _time_alternating_ms([partial(fn, *assoc[kind]) for kind in kinds]
                                 + [partial(yardstick, *assoc[kind]) for kind in kinds],
                                 [100, 100, 20, 20])
    per_call = dict(zip(kinds, times[:2]))
    plain_ms = err = 0.0
    n_bytes = n_ops = 0
    shapes = []
    for kind in kinds:
        q, c = assoc[kind]
        Q, (R, B, _) = q.shape[0], c.shape
        out, ref = fn(q, c), plain(q, c)
        torch.cuda.synchronize()
        err = max(err, float((out[0] - ref[0]).abs().max()))
        # the same float32 expression without contraction and the same tie
        # rules: identical distances, indices and coordinates
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{fn.__name__} disagrees with its plain version ({kind}): {err}")
        plain_ms += _time_ms(lambda: plain(q, c), 5)
        n_bytes += 4 * (3 * Q + 3 * R * B + (8 if coords else 4) * Q * R)
        n_ops += 8 * Q * R * B        # 3 sub, 3 mul, 2 add per distance
        shapes.append(f"{kind} Q={Q} vs ({R},{B},3) {per_call[kind]:.4f} ms")
    bound, by = _bound_ms(n_bytes, n_ops)
    yard_key = "cdist_topk_gather_three_calls_ms" if coords else "cdist_topk_two_calls_ms"
    return {
        "name": fn.__name__, "route": "cuda",
        "source": "lidar_visual_odometry_tpu_torch/csrc/nn.cu",
        "replaces": ("lidar_visual_odometry_tpu/ops/pallas_nn.py:696" if coords
                     else "lidar_visual_odometry_tpu/ops/pallas_nn.py:85"),
        "max_abs_err": err, "ms": sum(per_call.values()), "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None, yard_key: sum(times[2:]),
        "shapes": f"frame {MAP_FRAMES} against frame {MAP_FRAMES - 1}, true relative pose: "
                  + ", ".join(shapes),
        "tolerance": "exact (atol 0), identical indices" + (" and coordinates" if coords else ""),
    }


def phase1_topk_coords_packed(maps, queries, mcfg, packed):
    """K8 (``block_topk_coords``) or K5p (``block_topk(packed=True)``) at the
    mapping shapes: the frame-9 corner and surf queries against the world map."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import nn, topk

    k = mcfg.knn
    if packed:
        fn = partial(topk.block_topk, k=k, packed=True)
        plain = partial(topk.block_topk_packed_plain, k=k)
    else:
        fn = partial(topk.block_topk_coords, k=k)
        plain = partial(topk.block_topk_coords_plain, k=k)
    ms = plain_ms = yard_ms = 0.0
    n_bytes = n_ops = 0
    shapes = []
    for name in ("corner", "surf"):
        q = queries[name][0].contiguous()
        c = nn.bake_mask(*maps[name]).contiguous()
        Q, C = q.shape[0], c.shape[0]
        out, ref = fn(q, c), plain(q, c)
        torch.cuda.synchronize()
        # K5's loop, another key or epilogue: identical distances, indices
        # and coordinates
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{'block_topk(packed)' if packed else 'block_topk_coords'} "
                                 f"disagrees with its plain version ({name})")
        call_ms = _time_ms(lambda: fn(q, c), 50)
        ms += call_ms
        plain_ms += _time_ms(lambda: plain(q, c), 3)

        def yardstick():
            # for information only: cdist + topk (+ the coordinate gather)
            top = torch.topk(torch.cdist(q, c), k, largest=False)
            return top if packed else c[top.indices]

        yard_ms += _time_ms(yardstick, 20)
        n_bytes += 4 * (3 * Q + 3 * C + (2 if packed else 4) * k * Q)
        n_ops += 8 * Q * C
        shapes.append(f"Q={Q} x C={C} ({name}, {call_ms:.4f} ms)")
    bound, by = _bound_ms(n_bytes, n_ops)
    return {
        "name": "block_topk_packed" if packed else "block_topk_coords", "route": "cuda",
        "source": "lidar_visual_odometry_tpu_torch/csrc/topk.cu",
        "replaces": ("lidar_visual_odometry_tpu/ops/pallas_nn.py:317" if packed
                     else "lidar_visual_odometry_tpu/ops/pallas_nn.py:643"),
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        ("cdist_topk_two_calls_ms" if packed else "cdist_topk_gather_three_calls_ms"): yard_ms,
        "shapes": f"one mapping round, k {k}: " + ", ".join(shapes),
        "tolerance": "exact (atol 0), identical indices" + ("" if packed else " and coordinates"),
    }


def phase1_feature_select(scans, dev):
    """K9 on the corridor's frame 9 at the odometry path's shapes (64 rings x
    2048 bins, ``LidarConfig()``'s selection), timed against its plain
    version in alternating rounds, then held to it bit for bit."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import features as kfeat
    from lidar_visual_odometry_tpu_torch.ops import features as F
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.config import LidarConfig

    L = LidarConfig()
    pts = torch.from_numpy(np.asarray(scans[MAP_FRAMES], np.float32)).to(dev)
    cs = pc.build_compact_scan(pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
                               n_scans=L.n_scans, width=L.azimuth_bins,
                               min_range=L.min_range, max_range=L.max_range)
    curv, eligible = F.curvature(cs)
    reach_l, reach_r = F._suppression_reach(cs)
    args = (curv, eligible & cs.valid, reach_l, reach_r, cs.count)
    R, W = curv.shape
    S, K, Fl = L.n_sectors, L.max_less_sharp_per_sector, L.max_flat_per_sector
    kw = dict(n_sectors=S, max_less_sharp=K, max_flat=Fl, edge_gate=L.curvature_edge_min,
              surf_gate=L.curvature_surf_max)
    ms, plain_ms = _time_alternating_ms(
        (lambda: kfeat.select_features(*args, **kw),
         lambda: kfeat.select_features_plain(*args, **kw)), (200, 5))
    got = kfeat.select_features(*args, **kw)
    want = kfeat.select_features_plain(*args, **kw)
    torch.cuda.synchronize()
    mismatches = sum(int((g != w).sum()) for g, w in zip(got, want))
    if mismatches:
        raise AssertionError(f"feature_select differs from its plain version in {mismatches} "
                             "outputs")
    # each input read once (curvature, availability, two reaches, counts),
    # each output written once (picks int64 and gates, the corner labels)
    n_bytes = R * W * (4 + 1 + 4 + 4) + 4 * R + R * S * (K + Fl) * 9 + R * W
    bound, by = _bound_ms(n_bytes, 0)
    return dict(
        name="feature_select", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/features.cu",
        replaces="none: lidar_visual_odometry_tpu/ops/features.py:142-189, a lax.scan XLA "
                 "compiled",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, output_mismatches=mismatches,
        accepted_picks=int(got[1].sum()) + int(got[3].sum()),
        shapes=f"({R},{W}), {S} sectors x ({K} corners + {Fl} flats): "
               f"{S * (K + Fl)} dependent picks a ring",
        tolerance="bit for bit",
    )


def _lk_ops(win: int, affine: bool, fixed: bool, iters_run):
    """float32 operations of one K6 level, summed over the active features.
    An n×n bilinear sample mixes the rows of its n + 1 columns once and then
    the columns, 3 a value: 3·n·(2n + 1). The setup samples the (win+2)²
    patch, takes both gradients (4 a pixel) and the Gram sums (a product and
    a sum each): 3 (2×2), or 21 over the six columns after forming the four
    affine ones (4 a pixel), and a 6×6 Cholesky; with fixed_affine it also
    forms the constant deformation of the residual (9 a pixel). An iteration
    samples win² pixels, forms the residual (1 a pixel; + 10 for the affine
    deformation, or + 1 to add the fixed one), projects it on 2 or 6 columns
    and solves."""
    m = win * win
    setup = 3 * (win + 2) * (2 * win + 5) + m * 4
    per_iter = 3 * win * (2 * win + 1) + m
    if affine:
        setup += m * (4 + 42) + 100
        per_iter += m * (10 + 12) + 80
    else:
        setup += m * (6 + (9 if fixed else 0)) + 10
        per_iter += m * (4 + (1 if fixed else 0)) + 20
    n_active = int((iters_run >= 0).sum())
    return n_active * setup + int(iters_run.sum()) * per_iter


def phase1_lk(images, dev):
    """K6 at the camera path's shapes: frame 0's pyramid (as the path
    bootstraps it) against frame 1's (uint8, as the path uploads it), the
    768 slots the path seeds on frame 0 with every seventh turned off, the
    three forward levels coarse to fine (2×2 at levels 2 and 1, affine with
    its parameters at level 0) and a level-0 call with the fitted
    deformation as fixed_affine. Each call's inputs come from the plain
    version's chain; the four kernel calls are timed in alternating rounds
    (median of five) before the checks, which demand every output bit for
    bit."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import lk as klk
    from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
    from lidar_visual_odometry_tpu_torch.ops import camera as cam_ops
    from lidar_visual_odometry_tpu_torch.ops import image, se3
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config

    cfg = camlidar_config()
    vcfg = cfg.visual
    win, eps = vcfg.lk_window, vcfg.lk_eps
    img0 = torch.from_numpy(np.asarray(images[0], np.float32)).to(dev)
    img1 = torch.from_numpy(np.clip(images[1] * 255.0 + 0.5, 0, 255).astype(np.uint8)).to(dev)
    pyr0 = image.build_pyramid(img0, vcfg.lk_levels)
    pyr1 = image.build_pyramid(img1.to(torch.float32) * (1.0 / 255.0), vcfg.lk_levels)
    table = vf._replenish(vf.empty_table(vcfg.max_tracked, dev), pyr0[0],
                          cam_ops.Pinhole.from_config(cfg.camera, dev), se3.identity_pose(dev),
                          vcfg)
    active = table.active.clone()
    active[::7] = False
    uv0 = table.uv
    N = uv0.shape[0]
    calls = []
    guess = torch.zeros_like(uv0)
    fixed = None
    for level, affine, iters in ((2, False, vcfg.lk_iters_coarse),
                                 (1, False, vcfg.lk_iters_coarse),
                                 (0, True, vcfg.lk_iters), (0, False, vcfg.lk_iters)):
        args = (pyr0[level], pyr1[level], (uv0 / 2.0 ** level).contiguous(), guess.contiguous(),
                active, fixed)
        kw = dict(win=win, iters=iters, eps=eps, affine=affine, return_affine=affine,
                  return_iters=True)
        want = klk.lk_level_plain(*args, **kw)
        calls.append((level, affine, iters, args, kw, want))
        if level > 0:
            guess = want[0] * 2.0
        elif affine:
            fixed = (-want[2]).contiguous()     # the forward fit, negated: the "fixed" gate
    per_call = _time_alternating_ms(
        [partial(klk.lk_level, *args, **kw) for _, _, _, args, kw, _ in calls], 100)
    plain_ms = err = 0.0
    mismatches = 0
    shapes = []
    n_bytes = n_ops = 0
    for (level, affine, iters, args, kw, want), ms in zip(calls, per_call):
        got = klk.lk_level(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, float((got[0] - want[0]).abs().max()))
        mismatches += sum(int((g != w).sum()) for g, w in zip(got, want))
        plain_ms += _time_ms(lambda: klk.lk_level_plain(*args, **kw), 3)
        H, W = args[0].shape
        fixed_in = args[-1] is not None
        # both images, q (uv0, guess, active, fixed_affine) and the (N, 8) rows written
        n_bytes += 4 * 2 * H * W + N * (4 * 4 + 1 + (16 if fixed_in else 0)) + 32 * N
        its = torch.where(active, want[-1], torch.full_like(want[-1], -1)).cpu()
        n_ops += _lk_ops(win, affine, fixed_in, its[its >= 0])
        shapes.append(f"level {level} ({H}x{W}) {'affine' if affine else '2x2'}"
                      f"{' fixed_affine' if fixed_in else ''} {iters} it, "
                      f"{float(want[-1][active].float().mean()):.2f} run, {ms:.4f} ms")
    # kernel and plain version sample, multiply and sum in the same order,
    # each operation rounded alone: every output bit for bit
    if mismatches:
        raise AssertionError(f"lk_level differs from its plain version in {mismatches} "
                             f"outputs (largest |Δd| {err})")
    bound, by = _bound_ms(n_bytes, n_ops)
    return dict(
        name="lk_level", route="cuda",
        source="lidar_visual_odometry_tpu_torch/csrc/lk.cu",
        replaces="lidar_visual_odometry_tpu/ops/pallas_lk.py:543",
        max_abs_err=err, ms=sum(per_call), plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, output_mismatches=mismatches,
        shapes=f"N {N} ({int(active.sum())} active), win {win}: " + "; ".join(shapes),
        tolerance="exact (atol 0): displacements, flags, iterations and affine",
    )


def phase5_knn(scans, odo, mapped, dev):
    """The k-NN entry points off the product path, on every frame.

    Odometry association: each frame's sharp (flat) features, moved by the
    relative pose phase 2 converged to, against the frame before's less-sharp
    (less-flat) cloud; ``associate_*_ringblocked`` (K7's index form),
    ``associate_*_coords_top2`` (K7's coordinate form inside the reference's
    off-TPU cross-ring selection) and the path's ``associate_*_coords`` (K2)
    must give equal valid masks and, where valid, equal coordinates.
    Mapping query: each frame's downsampled features at phase 3's mapped pose
    against the map of the frames before it (rebuilt at those poses): K8's
    distances equal K5's bit for bit and its coordinates are K5's candidates';
    K5p's distances are K5's cut to 2^-8, and where its index differs the two
    candidates' cut distances tie (counted, each pair within 2^-8 relative)."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.kernels import nn, topk
    from lidar_visual_odometry_tpu_torch.ops import knn, se3
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    ocfg, k_nn = cfg.odometry, cfg.mapping.knn
    R = ocfg.n_rings
    gate = dict(dist_sq_threshold=ocfg.dist_sq_threshold, nearby_scan=ocfg.nearby_scan)
    n = len(scans)
    poses_map = [_pose(mapped.quaternions[k], mapped.positions[k], dev) for k in range(n)]
    stats = {"edges valid": 0, "planes valid": 0, "map slots": 0, "K5p ties": 0}
    tie_rel = 0.0
    cut = ~0x7FFF
    prev = None
    kernels.reset_launch_counts()
    for k, feats, queries, maps in _map_frames(_pack(scans, dev), poses_map, dev):
        if k == 0:
            prev = feats
            continue
        rel = se3.se3_compose(se3.se3_inverse(_pose(odo.quaternions[k - 1], odo.positions[k - 1], dev)),
                              _pose(odo.quaternions[k], odo.positions[k], dev))
        for kind, cur, old in (("edges", feats.sharp, prev.less_sharp),
                               ("planes", feats.flat, prev.less_flat)):
            blocks, mblocks = old.xyz.reshape(R, -1, 3), old.mask.reshape(R, -1)
            args = (se3.se3_apply(rel, cur.xyz).contiguous(), cur.mask, blocks, mblocks)
            if kind == "edges":
                by_idx = knn.associate_edges_ringblocked(*args, **gate)
                top2 = knn.associate_edges_coords_top2(*args, **gate)
                k2 = knn.associate_edges_coords(*args, **gate)
                pairs = ((by_idx.j0, top2.a, k2.a), (by_idx.j2, top2.b, k2.b))
            else:
                by_idx = knn.associate_planes_ringblocked(*args, **gate)
                top2 = knn.associate_planes_coords_top2(*args, **gate)
                k2 = knn.associate_planes_coords(*args, **gate)
                pairs = ((by_idx.j0, top2.j, k2.j), (by_idx.j2, top2.l, k2.l),
                         (by_idx.j3, top2.m, k2.m))
            v = k2.valid
            flat = blocks.reshape(-1, 3)
            same = (torch.equal(by_idx.valid, v) and torch.equal(top2.valid, v)
                    and all(torch.equal(flat[j.long()][v], c[v]) and torch.equal(t[v], c[v])
                            for j, t, c in pairs))
            if not same:
                raise AssertionError(f"phase 5, frame {k} ({kind}): K7's associations disagree "
                                     "with K2's")
            stats[f"{kind} valid"] += int(v.sum())
        for name in ("corner", "surf"):
            q = queries[name][0].contiguous()
            c = nn.bake_mask(*maps[name]).contiguous()
            d5, i5 = topk.block_topk(q, c, k=k_nn)
            d8, c8 = topk.block_topk_coords(q, c, k=k_nn)
            dp, ip = topk.block_topk(q, c, k=k_nn, packed=True)
            if not (torch.equal(d8, d5) and torch.equal(c8, c[i5.long()])):
                raise AssertionError(f"phase 5, frame {k} ({name}): K8 disagrees with K5")
            if not torch.equal(dp.view(torch.int32), d5.view(torch.int32) & cut):
                raise AssertionError(f"phase 5, frame {k} ({name}): K5p's distances are not "
                                     "K5's cut to 2^-8")
            tie = ip != i5
            if bool(tie.any()):
                # the exact distance of K5p's candidate, rounded as the kernels round it
                diff = q[tie.nonzero()[:, 0]] - c[ip[tie].long()]
                sq = diff * diff
                alt = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
                if not torch.equal(alt.view(torch.int32) & cut, dp[tie].view(torch.int32)):
                    raise AssertionError(f"phase 5, frame {k} ({name}): a K5p index differs "
                                         "from K5's without a tie of the cut distance")
                rel_diff = float(((alt - d5[tie]).abs() / torch.maximum(alt, d5[tie])).max())
                if not rel_diff <= 2.0 ** -8:
                    raise AssertionError(f"phase 5: tied distances {rel_diff} apart (relative)")
                tie_rel = max(tie_rel, rel_diff)
                stats["K5p ties"] += int(tie.sum())
            stats["map slots"] += i5.numel()
        prev = feats
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    return counts, stats, tie_rel


def phase6_direct(scans, images, gt_rel, dev):
    """Direct VO at the bench's call: one warm and one timed run. Returns the
    printed line's numbers; raises on a non-finite trajectory or above the
    gate."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models import tracker_direct, window_ba
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import (
        CamLidarPipeline, _map_cam_poses_to_lidar,
    )
    from lidar_visual_odometry_tpu_torch.models.direct_vo import DirectVOChunked
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config

    with open(DIRECT_REFERENCE) as f:
        ref = json.load(f)
    cfg = camlidar_config()
    pipe = CamLidarPipeline(cfg, device=dev)
    clouds, masks = zip(*(pipe._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
    _check_inputs("6", ref, _sha256((*images, *clouds, *masks)))
    dvo = DirectVOChunked(pipe.cam, cfg.visual, point_cap=2048, device=dev)
    warm_t, warm_q, _ = dvo.run_chunked(images, clouds, masks, chunk=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tracker_direct.reset_stats()
    window_ba.reset_stats()
    ts, qs, wall = dvo.run_chunked(images, clouds, masks, chunk=8)
    torch.cuda.synchronize()
    frames = len(images) - 1
    vq, vt = _map_cam_poses_to_lidar(torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev),
                                     pipe.T_lidar_cam, pipe.T_cam_lidar)
    positions, quats = vt.cpu().numpy(), vq.cpu().numpy()
    out = {
        "frames_per_s": frames / wall,
        "ms_per_frame": 1e3 * wall / frames,
        "ate_direct_m": metrics.ate_rmse(positions, gt_rel, align=False),
        "jax_ate_direct_m": ref["ate_direct_m"],
        "largest_position_difference_m": float(
            np.abs(positions - np.asarray(ref["positions"])).max()),
        "largest_quaternion_difference": float(np.abs(quats - np.asarray(ref["quats"])).max()),
        "largest_position_difference_from_the_host_loop_m": float(
            np.abs(positions - np.asarray(ref["host_loop_positions"])).max()),
        "track_iterations_per_frame": tracker_direct.stats["iterations"] / frames,
        "ba_rounds_per_frame": window_ba.stats["rounds"] / frames,
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
        "runs_bit_for_bit": bool(np.array_equal(ts, warm_t) and np.array_equal(qs, warm_q)),
    }
    if positions.shape != (len(images), 3) or not np.isfinite(positions).all() \
            or not np.isfinite(quats).all():
        raise AssertionError(f"bad direct-VO trajectory: shape {positions.shape}")
    if not out["runs_bit_for_bit"]:
        raise AssertionError("the warm and the timed direct-VO runs differ: "
                             f"{float(np.abs(ts - warm_t).max())} m")
    if not out["ate_direct_m"] <= ref["ate_direct_m"] + ATE_MARGIN:
        raise AssertionError(f"ate_direct {out['ate_direct_m']} m exceeds the JAX reference "
                             f"{ref['ate_direct_m']} + {ATE_MARGIN}")
    if not out["largest_position_difference_from_the_host_loop_m"] <= HOST_LOOP_TOL_M:
        raise AssertionError(
            "direct-VO positions lie "
            f"{out['largest_position_difference_from_the_host_loop_m']} m from the JAX host "
            f"loop's (limit {HOST_LOOP_TOL_M})")
    return out


def phase7_drivers(scans, images, gt, gt_rel, digest, phase2, phase3, dev):
    """The per-frame drivers, the default ingests and checkpoint / resume at
    full width (7a-7f). Raises on a failed gate; prints a line a sub-phase.
    Returns 7d's ``FullPipeline(device_map=False).run`` (odometry, mapped)
    results, phase 9's single-device yardstick."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    with open(DRIVERS_REFERENCE) as f:
        ref = json.load(f)
    _check_inputs("7", ref, digest)
    cfg = SystemConfig()
    m = SHORT_FRAMES

    def run(fn):
        """fn() with the launch counts set to 0 just before; returns (its
        result, the counts, seconds)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launch_counts(), time.perf_counter() - t0

    def gate(sub, name, positions, truth, align=True):
        """The ATE against the JAX run of the same call + ATE_MARGIN; returns
        the line's text."""
        ate = metrics.ate_rmse(positions, truth, align=align)
        want = ref[f"{name}_ate_m"]
        diff = float(np.abs(positions - np.asarray(ref[f"{name}_positions"])).max())
        if positions.shape != truth.shape or not np.isfinite(positions).all():
            raise AssertionError(f"phase {sub}: bad trajectory of shape {positions.shape}")
        if not ate <= want + ATE_MARGIN:
            raise AssertionError(f"phase {sub}: {name} ATE {ate} m exceeds the JAX reference "
                                 f"{want} + {ATE_MARGIN}")
        return (f"{name} ATE {ate:.5f} m (JAX CPU {want:.5f} m + {ATE_MARGIN}), largest "
                f"position difference from the JAX trajectory {diff:.5f} m")

    def launched(sub, counts, names):
        if min(counts[k] for k in names) == 0:
            raise AssertionError(f"phase {sub}: a kernel of the path was never launched: {counts}")

    def same(sub, what, a, b):
        if not np.array_equal(a, b):
            raise AssertionError(f"phase {sub}: {what} differ, by up to "
                                 f"{float(np.abs(a - b).max())} m")

    odometry_path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop")
    frames = len(scans) - 1

    # 7a: the default ingests of OdometryPipeline.run_chunked
    chunked = {}
    for name, kw in (("odometry_float", {}), ("odometry_uint16", {"quantize": True})):
        chunked[name], counts, wall = run(lambda: OdometryPipeline(cfg, device=dev).run_chunked(
            scans, chunk=8, **kw))
        launched("7a", counts, odometry_path)
        print(f"phase 7a: {gate('7a', name, chunked[name].positions, gt)}, "
              f"{frames / wall:.2f} frames/s, launches {counts}", flush=True)
    fl, u16 = chunked["odometry_float"], chunked["odometry_uint16"]

    # 7b: the per-frame driver runs the float chunk's operations
    per, counts, wall = run(lambda: OdometryPipeline(cfg, device=dev).run(scans))
    launched("7b", counts, odometry_path)
    same("7b", "OdometryPipeline.run's positions and the float run_chunked's",
         per.positions, fl.positions)
    print(f"phase 7b: {gate('7b', 'odometry_per_frame', per.positions, gt)}, positions equal "
          f"7a's float run bit for bit, {len(scans) / wall:.2f} frames/s, launches {counts}",
          flush=True)

    # 7c: fused SLAM over the default uint16 ingest
    (odo, mapped), counts, wall = run(lambda: FullPipeline(cfg, device=dev).run_chunked(
        scans, chunk=8, map_skip=1))
    launched("7c", counts, odometry_path + ("segment_sum", "block_topk_windowed"))
    same("7c", "the uint16 SLAM run's odometry positions and 7a's uint16 run's",
         odo.positions, u16.positions)
    print(f"phase 7c: {gate('7c', 'slam_uint16_mapped', mapped.positions, gt)}, odometry "
          f"equal to 7a's uint16 run bit for bit, {frames / wall:.2f} frames/s, launches "
          f"{counts}", flush=True)

    # 7d: FullPipeline.run on the device map and on the host cube map
    per_frame_slam = {}
    for device_map in (True, False):
        (odo, mapped), counts, wall = run(lambda: FullPipeline(
            cfg, device_map=device_map, device=dev).run(scans[:m]))
        per_frame_slam[device_map] = (odo, mapped)
        launched("7d", counts, ("segment_sum", "block_topk_windowed"))
        same("7d", "FullPipeline.run's odometry positions and 7b's",
             odo.positions, per.positions[:m])
        name = f"slam_per_frame_device_map_{str(device_map).lower()}_mapped"
        print(f"phase 7d: device_map={device_map}, {gate('7d', name, mapped.positions, gt[:m])}, "
              f"odometry equal to 7b's bit for bit, {m / wall:.2f} frames/s, launches {counts}",
              flush=True)

    # 7e: CamLidarPipeline over the default uint16 ingest, and per frame
    cl_cfg = camlidar_config()
    for name, call, lidar in (
            ("camlidar_uint16_visual",
             lambda: CamLidarPipeline(cl_cfg, device=dev).run_chunked(scans[:m], images[:m],
                                                                        chunk=8),
             u16.positions[:m]),
            ("camlidar_per_frame_visual",
             lambda: CamLidarPipeline(cl_cfg, device=dev).run(scans[:m], images[:m]),
             per.positions[:m])):
        cl, counts, wall = run(call)
        launched("7e", counts, odometry_path + ("lk_level",))
        if counts["lk_level"] != 4 * (m - 1):
            raise AssertionError(f"phase 7e: expected 4 lk_level launches a tracked frame: "
                                 f"{counts['lk_level']} over {m - 1} frames")
        same("7e", f"{name}'s lidar positions and those of the lidar run with its ingest",
             cl.lidar_positions, lidar)
        print(f"phase 7e: {gate('7e', name, cl.visual_positions, gt_rel[:m], align=False)}, "
              f"lidar positions equal the lidar run's bit for bit, {m / wall:.2f} frames/s, "
              f"launches {counts}", flush=True)

    # 7f: stop after frame STOP_AFTER, resume, and compare with phases 2 and 3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "odometry.npz")
        kw = dict(chunk=8, ingest="polar2", checkpoint_path=path)
        t0 = time.perf_counter()
        cut = OdometryPipeline(cfg, device=dev).run_chunked(
            scans, checkpoint_every=CHECKPOINT_EVERY, stop_after=STOP_AFTER, **kw)
        joined = OdometryPipeline(cfg, device=dev).run_chunked(scans, resume=True, **kw)
        wall = time.perf_counter() - t0
        same("7f", "the stopped odometry run's positions and phase 2's",
             cut.positions, phase2.positions[:len(cut.positions)])
        same("7f", "the resumed odometry run's positions and phase 2's",
             joined.positions, phase2.positions)
        n_cut = len(cut.positions)

        path = os.path.join(tmp, "slam.npz")
        kw = dict(chunk=8, map_skip=1, ingest="polar2", checkpoint_path=path)
        t0 = time.perf_counter()
        FullPipeline(cfg, device=dev).run_chunked(
            scans, checkpoint_every=CHECKPOINT_EVERY, stop_after=STOP_AFTER, **kw)
        odo, mapped = FullPipeline(cfg, device=dev).run_chunked(scans, resume=True, **kw)
        wall_slam = time.perf_counter() - t0
        same("7f", "the resumed SLAM run's odometry positions and phase 3's",
             odo.positions, phase3[0].positions)
        same("7f", "the resumed SLAM run's mapped positions and phase 3's",
             mapped.positions, phase3[1].positions)
        left = os.listdir(tmp)
    print(f"phase 7f: odometry (polar2) stopped after frame {n_cut - 1} and resumed: positions "
          f"equal phase 2's bit for bit, {frames / wall:.2f} frames/s over both calls; "
          f"SLAM likewise equal to phase 3's, {frames / wall_slam:.2f} frames/s; the "
          f"checkpoints {left} removed with their directory", flush=True)
    return per_frame_slam[False]


def phase8_modes(scans, images, seq, gt, gt_rel, phase3_mapped, phase4, dev):
    """The cam-lidar coupled and mapping modes and the IMU-fused odometry at
    full width (8a-8e). Raises on a failed gate; prints a line a sub-phase."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import sync, synthetic
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models import imu_fusion
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    with open(MODES_REFERENCE) as f:
        ref = json.load(f)
    stamps, accel, gyro = synthetic.synthesize_imu(seq, frame_period=0.1, rate_hz=100.0)
    _check_inputs("8", ref, _sha256((*scans, *images, stamps, accel, gyro)))
    m = ref["short_frames"]
    cl_cfg = camlidar_config()
    odometry_path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop")
    mapping_path = ("segment_sum", "block_topk_windowed")

    def run(fn):
        """fn() with the launch counts set to 0 just before; returns (its
        result, the counts, seconds)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in kernels.launch_counts().items() if v}, \
            time.perf_counter() - t0

    def gate(sub, what, positions, want_ate, want_positions, truth, align=True, members=None):
        """The ATE against the JAX run's + ATE_MARGIN (the camera's: the
        largest of the JAX run's and its one-ulp members'); returns the
        line's text."""
        if positions.shape != truth.shape or not np.isfinite(positions).all():
            raise AssertionError(f"phase {sub}: bad {what} trajectory of shape {positions.shape}")
        ate = metrics.ate_rmse(positions, truth, align=align)
        diff = float(np.abs(positions - np.asarray(want_positions)).max())
        base, spread = (want_ate, "") if members is None else _ensemble(want_ate, members)
        if not ate <= base + ATE_MARGIN:
            raise AssertionError(f"phase {sub}: {what} ATE {ate} m exceeds the JAX reference "
                                 f"{base} + {ATE_MARGIN}")
        return (f"{what} ATE {ate:.5f} m (JAX CPU {want_ate:.5f} m"
                f"{', ' + spread + ', limit the largest' if spread else ''} + {ATE_MARGIN}), "
                f"largest position difference from the JAX run {diff:.5f} m")

    def launched(sub, counts, names):
        if min(counts.get(k, 0) for k in names) == 0:
            raise AssertionError(f"phase {sub}: a kernel of the path was never launched: {counts}")

    def same(sub, what, a, b):
        if not np.array_equal(a, b):
            raise AssertionError(f"phase {sub}: {what} differ, by up to "
                                 f"{float(np.abs(a - b).max())} m")

    def camlidar(**kw):
        pipe = CamLidarPipeline(cl_cfg, device=dev)
        res = pipe.run_chunked(scans[:m], images[:m], chunk=8, ingest="polar2", **kw)
        return res, pipe.last_wall

    def lines(sub, name, res):
        text = [gate(sub, "lidar", res.lidar_positions, ref[f"{name}_lidar_ate_m"],
                     ref[f"{name}_lidar_positions"], gt[:m]),
                gate(sub, "visual", res.visual_positions, ref[f"{name}_ate_visual_m"],
                     ref[f"{name}_visual_positions"], gt_rel[:m], align=False,
                     members=ref["coupled_ulp_members"])]
        if res.mapped_positions is not None:
            text.append(gate(sub, "mapped", res.mapped_positions, ref[f"{name}_mapped_ate_m"],
                             ref[f"{name}_mapped_positions"], gt[:m]))
        return "; ".join(text)

    # 8a: the visual pose warm-starts the lidar odometry
    (coupled, wall), counts, _ = run(lambda: camlidar(coupled=True))
    launched("8a", counts, odometry_path + ("lk_level",))
    if counts["lk_level"] != 4 * (m - 1):
        raise AssertionError(f"phase 8a: expected 4 lk_level launches a tracked frame: "
                             f"{counts['lk_level']} over {m - 1} frames")
    spread = ref.get("coupled_eager_against_jitted_largest_lidar_position_difference_m")
    print(f"phase 8a: coupled, {m} frames: {lines('8a', 'coupled', coupled)}; "
          f"{(m - 1) / wall:.2f} frames/s, launches {counts}; the JAX run's own rounding "
          f"spread (eager against jitted, lidar positions): {spread} m", flush=True)

    # 8b: the scan-to-map refinement behind the uncoupled pair
    (mapping, wall), counts, _ = run(lambda: camlidar(mapping=True))
    launched("8b", counts, odometry_path + mapping_path + ("lk_level",))
    for what, a, b in (("lidar positions and phase 4's", mapping.lidar_positions,
                        phase4.lidar_positions[:m]),
                       ("visual positions and phase 4's", mapping.visual_positions,
                        phase4.visual_positions[:m]),
                       ("mapped positions and phase 3's", mapping.mapped_positions,
                        phase3_mapped.positions[:m])):
        same("8b", what, a, b)
    print(f"phase 8b: mapping, {m} frames: {lines('8b', 'mapping', mapping)}; lidar and visual "
          f"positions equal phase 4's and mapped positions phase 3's bit for bit, "
          f"{(m - 1) / wall:.2f} frames/s, launches {counts}", flush=True)

    # 8c: coupled and mapping; the mapping does not feed back into odometry
    (both, wall), counts, _ = run(lambda: camlidar(coupled=True, mapping=True))
    launched("8c", counts, odometry_path + mapping_path + ("lk_level",))
    same("8c", "lidar positions and 8a's", both.lidar_positions, coupled.lidar_positions)
    same("8c", "visual positions and 8a's", both.visual_positions, coupled.visual_positions)
    print(f"phase 8c: coupled + mapping, {m} frames: {lines('8c', 'coupled_mapping', both)}; "
          f"lidar and visual positions equal 8a's bit for bit, {(m - 1) / wall:.2f} frames/s, "
          f"launches {counts}", flush=True)

    # 8d: 8c stopped after frame MODES_STOP_AFTER and resumed
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "camlidar_mapping.npz")
        kw = dict(coupled=True, mapping=True, checkpoint_path=path)

        def stop_and_resume():
            cut, _ = camlidar(checkpoint_every=MODES_STOP_AFTER, stop_after=MODES_STOP_AFTER,
                              **kw)
            keys = sorted(k for k in np.load(path).files if k.startswith(("mapst", "traj_m")))
            return cut, keys, camlidar(resume=True, **kw)[0]

        (cut, keys, joined), counts, wall = run(stop_and_resume)
    n_cut = len(cut.lidar_positions)
    for name in ("lidar_positions", "visual_positions", "mapped_positions", "lidar_quats",
                 "visual_quats", "mapped_quats"):
        same("8d", f"the stopped run's {name} and 8c's", getattr(cut, name),
             getattr(both, name)[:n_cut])
        same("8d", f"the resumed run's {name} and 8c's", getattr(joined, name),
             getattr(both, name))
    print(f"phase 8d: coupled + mapping stopped after frame {n_cut - 1} and resumed from a "
          f"checkpoint with {keys}: {lines('8d', 'coupled_mapping', joined)}; every trajectory "
          f"equals 8c's bit for bit, {(m - 1) / wall:.2f} frames/s over both calls, launches "
          f"{counts}", flush=True)

    # 8e: the IMU-fused odometry, frame by frame, its window solve timed apart
    n = IMU_FRAMES
    dts = np.full(stamps.shape, 0.01, np.float32)
    bundles = sync.bundle_imu(np.arange(n) * 0.1, stamps)
    solve_s = []
    solve = imu_fusion.solve_window

    def timed_solve(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*args, **kwargs)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
        return out

    def fuse():
        fuser = imu_fusion.ImuFusedOdometry(SystemConfig(), device=dev)
        fused = np.stack([fuser.process(scans[k], accel[i], gyro[i], dts[i]).t.cpu().numpy()
                          for k, i in enumerate(bundles)])
        # the same run's odometry alone, as the window solves saw it
        return fused, torch.stack([p.t for p in fuser._poses]).cpu().numpy()

    imu_fusion.solve_window = timed_solve
    try:
        (fused, odometry), counts, wall = run(fuse)
    finally:
        imu_fusion.solve_window = solve
    launched("8e", counts, odometry_path)
    want = np.asarray(ref["imu_fused_positions"])[:n]
    want_ate = (ref["imu_fused_ate_m"] if n == ref["frames"]
                else metrics.ate_rmse(want, gt[:n]))
    text = gate("8e", "fused", fused, want_ate, want, gt[:n])
    diff = float(np.abs(fused - want).max())
    diff_odometry = float(np.abs(odometry - want).max())
    if not diff <= IMU_TOL_M:
        raise AssertionError(f"phase 8e: fused positions lie {diff} m from the JAX fuser's "
                             f"(limit {IMU_TOL_M})")
    # a window solve that returned its start or took a zero step would leave
    # the fused trajectory on the odometry's
    if not diff < diff_odometry:
        raise AssertionError(f"phase 8e: the window solves did not bring the trajectory nearer "
                             f"to the JAX fuser's: fused {diff} m, odometry alone "
                             f"{diff_odometry} m")
    print(f"phase 8e: IMU-fused odometry, {n} frames: {text} (limit {IMU_TOL_M}; the same "
          f"run's odometry alone lies {diff_odometry:.5f} m from it); {n / wall:.2f} frames/s, "
          f"{1e3 * sum(solve_s) / n:.1f} ms/frame in {len(solve_s)} window solves "
          f"({1e3 * sum(solve_s) / max(len(solve_s), 1):.1f} ms a solve: the first "
          f"{1e3 * solve_s[0]:.1f} ms, the others {1e3 * np.mean(solve_s[1:]):.1f} ms each), "
          f"{1e3 * (wall - sum(solve_s)) / n:.1f} ms/frame for the rest (odometry, "
          f"preintegration), launches {counts} "
          f"({ {k: round(v / n, 2) for k, v in counts.items()} } a frame)", flush=True)


def _ba_window(scans, images, cfg, ref):
    """The direct-VO window of ``tools/jax_reference_parallel.py``: level-0
    images, camera-frame points and masks of the keyframes ``ba_frames``
    (``camera_cloud_select``, every ``ba_stride``-th point)."""
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import camera_cloud_select

    E = np.asarray(cfg.extrinsic.matrix, np.float32)
    imgs, pts, masks = [], [], []
    for k in ref["ba_frames"]:
        xyz, m = camera_cloud_select(np.asarray(scans[k])[:, :3], E[:, :3], E[:, 3],
                                     ref["ba_cloud_cap"])
        pts.append(xyz[::ref["ba_stride"]])
        masks.append(m[::ref["ba_stride"]])
        imgs.append(np.asarray(images[k], np.float32))
    return np.stack(imgs), np.stack(pts), np.stack(masks)


def phase9_rank(mesh, inputs):
    """Phase 9 on one rank of ``mesh``: ``DistributedSlamPipeline(SystemConfig()).run``
    and the coupled ``DistributedCamLidarPipeline(camlidar_config()).run`` on
    the scans (and images) ``scan0`` …, and ``sharded_refine`` on the BA
    window ``ba_*``. Each run's launch counts start at 0 just before it.
    Returns numpy arrays: positions, poses, seconds, counts, peak memory.
    ``parallel.launch`` calls it in each rank process; one NCCL rank calls it
    in the script's own."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.ops import camera, se3
    from lidar_visual_odometry_tpu_torch.parallel import sharded_ba
    from lidar_visual_odometry_tpu_torch.parallel.distributed_camlidar import (
        DistributedCamLidarPipeline,
    )
    from lidar_visual_odometry_tpu_torch.parallel.distributed_pipeline import (
        DistributedSlamPipeline,
    )
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    n = int(inputs["n"])
    scans = [inputs[f"scan{k}"] for k in range(n)]
    images = [inputs[f"image{k}"] for k in range(n)]
    dev = mesh.device
    out = {}

    def counted(name, fn):
        torch.cuda.synchronize(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        out[f"{name}_s"] = np.float64(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        out[f"{name}_launch_names"] = np.array(list(counts))
        out[f"{name}_launches"] = np.array(list(counts.values()), np.int64)
        return res

    torch.cuda.reset_peak_memory_stats(dev)
    odom, mapped, _ = counted("slam", lambda: DistributedSlamPipeline(
        SystemConfig(), n_devices=mesh.size, device="cuda").run(scans))
    out.update(slam_odometry=odom, slam_mapped=mapped)
    cl_cfg = camlidar_config()
    odom, mapped, vis, _ = counted("camlidar", lambda: DistributedCamLidarPipeline(
        cl_cfg, n_devices=mesh.size, device="cuda").run(scans, images))
    out.update(camlidar_lidar=odom, camlidar_mapped=mapped, camlidar_visual=vis)
    t = {k: torch.from_numpy(inputs[k]).to(dev) for k in ("ba_imgs", "ba_pts", "ba_masks",
                                                           "ba_init_q", "ba_init_t")}
    poses = counted("ba", lambda: sharded_ba.sharded_refine(
        mesh, (t["ba_imgs"],), t["ba_pts"], t["ba_masks"], se3.Pose(t["ba_init_q"], t["ba_init_t"]),
        camera.Pinhole.from_config(cl_cfg.camera, dev), n_iters=int(inputs["ba_n_iters"]),
        level=0, pair_radius=int(inputs["ba_pair_radius"])))
    out.update(ba_q=poses.q, ba_t=poses.t, peak_mib=np.float64(
        torch.cuda.max_memory_allocated(dev) / 2**20))
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def phase9_distributed(scans, images, gt, gt_rel, host_map):
    """The distributed layer at full width over the corridor's first 17
    frames (9a one NCCL rank in this process, 9b two gloo ranks on the one
    card with CUDA tensors), against ``tools/jax_reference_parallel.json``.
    Raises on a failed gate; prints a line a run."""
    import torch

    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.parallel import launch, multihost
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config

    with open(PARALLEL_REFERENCE) as f:
        ref = json.load(f)
    m = ref["frames"]
    _check_inputs("9", ref, _sha256((*scans[:m], *images[:m])))
    print(f"phase 9: {_packed_text(scans[:m], ref)}", flush=True)
    imgs, pts, masks = _ba_window(scans, images, camlidar_config(), ref)
    if _sha256((imgs, pts, masks)) != ref["ba_inputs_sha256"]:
        raise AssertionError("phase 9: the BA window is not the reference's")
    inputs = {"n": np.int64(m), **{f"scan{k}": scans[k] for k in range(m)},
              **{f"image{k}": images[k] for k in range(m)},
              "ba_imgs": imgs, "ba_pts": pts, "ba_masks": masks,
              "ba_init_q": np.asarray(ref["ba_init_q"], np.float32),
              "ba_init_t": np.asarray(ref["ba_init_t"], np.float32),
              "ba_n_iters": np.int64(ref["ba_n_iters"]),
              "ba_pair_radius": np.int64(ref["ba_pair_radius"])}
    ba_true = np.asarray(ref["ba_true_t"])

    def diff(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def gates(sub, r, rank=""):
        """The ATE gates, the launches, and the line of one rank's runs."""
        text = []
        for name, key, truth, align in (
                ("slam_odometry", "slam_odometry", gt[:m], True),
                ("slam_mapped", "slam_mapped", gt[:m], True),
                ("camlidar_lidar", "camlidar_lidar", gt[:m], True),
                ("camlidar_mapped", "camlidar_mapped", gt[:m], True),
                ("camlidar_ate_visual", "camlidar_visual", gt_rel[:m], False)):
            pos = r[key]
            if pos.shape != (m, 3) or not np.isfinite(pos).all():
                raise AssertionError(f"phase {sub}{rank}: bad {name} trajectory {pos.shape}")
            ate = metrics.ate_rmse(pos, truth, align=align)
            want = ref[f"{name}_m" if name.endswith("visual") else f"{name}_ate_m"]
            jax_pos = ref[f"{key}_positions"]
            # the camera's gate: the largest of the JAX run's and its one-ulp members'
            base, spread = ((want, "") if not name.endswith("visual")
                            else _ensemble(want, ref["camlidar_ulp_members"]))
            if not ate <= base + ATE_MARGIN:
                raise AssertionError(f"phase {sub}{rank}: {name} ATE {ate} m exceeds the JAX "
                                     f"reference {base} + {ATE_MARGIN}")
            text.append(f"{name} ATE {ate:.5f} m (JAX CPU {want:.5f} m"
                        f"{', ' + spread if spread else ''}), largest position "
                        f"difference from JAX {diff(pos, jax_pos):.5f} m")
        counts = {}
        for run in ("slam", "camlidar", "ba"):
            counts[run] = {str(k): int(v) for k, v in zip(r[f"{run}_launch_names"],
                                                          r[f"{run}_launches"]) if v}
        for run, names in (("slam", PARALLEL_PATH), ("camlidar", PARALLEL_PATH + ("lk_level",))):
            if min(counts[run].get(k, 0) for k in names) == 0:
                raise AssertionError(f"phase {sub}{rank}: a kernel of the {run} path was never "
                                     f"launched: {counts[run]}")
        if counts["camlidar"]["lk_level"] != 4 * (m - 1):
            raise AssertionError(f"phase {sub}{rank}: expected 4 lk_level launches a tracked "
                                 f"frame: {counts['camlidar']['lk_level']} over {m - 1}")
        if "gn_inner_loop" in counts["slam"] or "gn_inner_loop" in counts["camlidar"]:
            raise AssertionError(f"phase {sub}{rank}: the fused GN ran under a reduction")
        ba_err = np.linalg.norm(r["ba_t"] - ba_true, axis=1).max()
        text.append(f"sharded_refine largest position error {ba_err:.5f} m (from "
                    f"{np.linalg.norm(np.asarray(ref['ba_init_t']) - ba_true, axis=1).max():.5f}"
                    f"), {diff(r['ba_t'], ref['ba_t']):.3g} m from JAX's")
        speed = (f"SLAM {(m - 1) / r['slam_s']:.2f} frames/s ({1e3 * r['slam_s'] / (m - 1):.1f} "
                 f"ms/frame), cam-lidar {(m - 1) / r['camlidar_s']:.2f} frames/s "
                 f"({1e3 * r['camlidar_s'] / (m - 1):.1f} ms/frame), BA {1e3 * r['ba_s']:.1f} ms, "
                 f"peak device memory {float(r['peak_mib']):.1f} MiB")
        return "; ".join(text), speed, counts

    # ---- 9a: one NCCL rank in this process ----
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, device="cuda")
        try:
            nccl = phase9_rank(multihost.global_mesh(), inputs)
        finally:
            multihost.shutdown()
    text, speed, counts = gates("9a", nccl)
    odo_s, map_s = host_map
    d_odo = diff(nccl["slam_odometry"], odo_s.positions)
    d_map = diff(nccl["slam_mapped"], map_s.positions)
    if not (d_odo <= HOST_MAP_TOL_M[0] and d_map <= HOST_MAP_TOL_M[1]):
        raise AssertionError(f"phase 9a: the distributed SLAM lies {d_odo} m (odometry) and "
                             f"{d_map} m (mapped) from FullPipeline(device_map=False).run; limits "
                             f"{HOST_MAP_TOL_M}")
    print(f"phase 9a: one NCCL rank, {m} frames: {text}; the distributed SLAM lies {d_odo:.3g} m "
          f"(odometry) and {d_map:.3g} m (mapped) from FullPipeline(device_map=False).run "
          f"(limits {HOST_MAP_TOL_M[0]}, {HOST_MAP_TOL_M[1]}); {speed}; launches {counts}",
          flush=True)

    # ---- 9b: two gloo ranks on the one card, CUDA tensors ----
    t0 = time.perf_counter()
    ranks = launch.launch("chip_smoke:phase9_rank", 2, inputs, backend="gloo", device="cuda",
                          timeout=600)
    fleet_s = time.perf_counter() - t0
    for key in ("slam_odometry", "slam_mapped", "camlidar_lidar", "camlidar_mapped",
                "camlidar_visual", "ba_q", "ba_t"):
        d = diff(ranks[0][key], ranks[1][key])
        if not d <= RANKS_AGREE:
            raise AssertionError(f"phase 9b: the two ranks' {key} differ by {d}")
    vs_9a = {key: diff(ranks[0][key], nccl[key]) for key in GLOO_VS_NCCL_M}
    print(f"phase 9b: the ranks' positions lie {vs_9a} m from 9a's (limits {GLOO_VS_NCCL_M})",
          flush=True)
    for key, d in vs_9a.items():
        if not d <= GLOO_VS_NCCL_M[key]:
            raise AssertionError(f"phase 9b: {key} lies {d} m from 9a's (limit "
                                 f"{GLOO_VS_NCCL_M[key]})")
    d_ba = diff(ranks[0]["ba_t"], ref["ba_t"])
    if not d_ba <= BA_TOL_M:
        raise AssertionError(f"phase 9b: sharded_refine's positions lie {d_ba} m from JAX's "
                             f"(limit {BA_TOL_M})")
    for rank, r in enumerate(ranks):
        text, speed, counts = gates("9b", r, rank=f" rank {rank}")
        print(f"phase 9b: rank {rank} of 2 (gloo, CUDA tensors), {m} frames: {text}; {speed}; "
              f"launches {counts}", flush=True)
    print(f"phase 9b: the ranks agree within {RANKS_AGREE}; their positions lie within "
          f"{GLOO_VS_NCCL_M} m of 9a's; sharded_refine {d_ba:.3g} m from JAX's (limit "
          f"{BA_TOL_M}); the fleet took {fleet_s:.1f} s with its start", flush=True)


def phase10_runner(scans, seq):
    """``scripts/run_kitti_torch.py --mapping --device cuda`` on the corridor's
    first 17 scans written as a KITTI sequence, against ``FullPipeline``'s
    same run on the scans in memory (the trajectory file bit for bit), and
    ``NativeScanReader`` against the scans (bit for bit)."""
    from lidar_visual_odometry_tpu_torch.data.native_loader import NativeScanReader
    from lidar_visual_odometry_tpu_torch.eval.metrics import poses_to_matrices
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline
    from lidar_visual_odometry_tpu_torch.utils.config import kitti_config

    m = SHORT_FRAMES
    with tempfile.TemporaryDirectory() as root:
        seq_dir = os.path.join(root, "sequences", "00")
        os.makedirs(os.path.join(seq_dir, "velodyne"))
        os.makedirs(os.path.join(root, "poses"))
        for k in range(m):
            if scans[k].dtype != np.float32:
                raise AssertionError(f"phase 10: scan {k} is {scans[k].dtype}, not float32")
            xyzr = np.concatenate([scans[k][:, :3], np.zeros((len(scans[k]), 1), np.float32)], 1)
            xyzr.tofile(os.path.join(seq_dir, "velodyne", f"{k:06d}.bin"))
        np.savetxt(os.path.join(seq_dir, "times.txt"), np.arange(m) * 0.1)
        eye = " ".join(f"{v:g}" for v in np.eye(3, 4).reshape(-1))
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write("".join(f"{key}: {eye}\n" for key in ("P0", "P1", "P2", "P3", "Tr")))
        with open(os.path.join(root, "poses", "00.txt"), "w") as f:
            for k in range(m):
                R, t = seq.pose(k)
                f.write(" ".join(f"{v:.6e}" for v in np.hstack([R, t[:, None]]).reshape(-1))
                        + "\n")

        pattern = os.path.join(seq_dir, "velodyne", "%06ld.bin")
        with NativeScanReader(pattern, m) as reader:
            for k, (xyz, mask, refl) in enumerate(reader):
                if not (np.array_equal(xyz[mask], scans[k][:, :3]) and not refl.any()):
                    raise AssertionError(f"phase 10: the native reader's scan {k} differs")

        out = os.path.join(root, "trajectory.txt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "run_kitti_torch.py"), "--root", root,
             "--sequence", "0", "--mapping", "--device", "cuda", "--out", out],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        runner_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 10: the runner failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out) as f:
            got = f.read()
    _, mapped = FullPipeline(kitti_config(0), device="cuda").run_chunked(
        scans[:m], chunk=8, map_skip=1, ingest="polar")
    want = "".join(" ".join(f"{v:.6e}" for v in T[:3].reshape(-1)) + "\n"
                   for T in poses_to_matrices(mapped.quaternions, mapped.positions))
    if got != want:
        raise AssertionError("phase 10: the runner's trajectory differs from FullPipeline's "
                             "run of the same scans in memory")
    print(f"phase 10: run_kitti_torch.py --mapping --device cuda on {m} scans written as "
          f"a KITTI sequence: report {report}; its trajectory file equals "
          f"FullPipeline(kitti_config(0)).run_chunked on the scans in memory bit for bit; "
          f"NativeScanReader returned the scans bit for bit; the runner took {runner_s:.1f} s "
          f"with its start", flush=True)


def _script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quat_angle(q1, q2) -> float:
    """Angle in radians between two rotations given as (w, x, y, z)
    quaternions, from the vector part of conj(q1) q2 (accurate near 0)."""
    a = np.asarray(q1, np.float64)
    b = np.asarray(q2, np.float64)
    w = a[0] * b[0] + a[1:] @ b[1:]
    v = a[0] * b[1:] - b[0] * a[1:] - np.cross(a[1:], b[1:])
    return float(2.0 * np.arctan2(np.linalg.norm(v), abs(w)))


def regime_camera_steps(inputs, dev, path=REGIME_STEPS):
    """One step of the port's visual frontend (``chunk_frame_step``) from each
    JAX state in ``path`` (phase 11's regimes by default; phase 4 passes
    ``CORRIDOR_STEPS``), on the same frame's image and natively packed scan,
    against the step JAX took from that state. The state's pyramid and depth
    cloud are the port's own, from the previous frame. Returns a row a state:
    regime, frame, the tracked counts, and the translation (m) and rotation
    (rad) differences, and how far JAX's own step moved when its state was
    nudged by one ulp (``jax_spread_*``)."""
    import torch

    from lidar_visual_odometry_tpu_torch.data import native_pack
    from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import (
        CamLidarPipeline, _to_uint8, cam_clouds_from_polar,
    )
    from lidar_visual_odometry_tpu_torch.ops import image, se3
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config

    cfg = camlidar_config()
    vcfg, lcfg = cfg.visual, cfg.lidar
    pipe = CamLidarPipeline(cfg, device=dev)
    R_cl = torch.from_numpy(pipe.R_cl).to(dev)
    t_cl = torch.from_numpy(pipe.t_cl.copy()).to(dev)
    ref = np.load(path)
    rows = []
    for name, (scans, images) in inputs.items():
        if f"{name}:frames" not in ref:
            continue
        frames = [int(k) for k in ref[f"{name}:frames"]]
        need = sorted({j for k in frames for j in (k - 1, k)})
        at = {j: i for i, j in enumerate(need)}
        # the ingest's images: polar (two channels) on the regimes, polar2
        # (the range plane) on phase 4's corridor
        channels = int(ref[f"{name}:channels"])
        packed = native_pack.pack_polar_chunk(
            [scans[j] for j in need], n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
            min_range=lcfg.min_range, max_range=lcfg.max_range, channels=channels)
        clouds, masks = cam_clouds_from_polar(pc.polar_image_to_tensor(packed, dev), R_cl, t_cl,
                                              lcfg, vcfg.depth_cloud_cap)
        for k in frames:
            key = f"{name}:{k}:"

            def leaf(i, dtype=torch.float32):
                return torch.tensor(ref[f"{key}vchunk_{i}"], dtype=dtype, device=dev)

            img = torch.from_numpy(_to_uint8(images[k - 1])).to(dev).to(torch.float32) * (
                1.0 / 255.0)
            if vcfg.use_clahe:
                img = image.clahe(img, grid=vcfg.clahe_grid, clip_limit=vcfg.clahe_clip)
            table = vf.FeatureTable(
                uv=leaf(0), active=leaf(1, torch.bool), depth=leaf(2), start_un=leaf(3),
                start_q=leaf(4), start_t=leaf(5), age=leaf(6, torch.int32), flow=leaf(7))
            state = vf.VisualChunkState(
                table, se3.Pose(leaf(8), leaf(9)), se3.Pose(leaf(10), leaf(11)),
                tuple(image.build_pyramid(img, vcfg.lk_levels)),
                vf.build_depth_cloud(clouds[at[k - 1]], masks[at[k - 1]]))
            _, rel, n = vf.chunk_frame_step(
                state, torch.from_numpy(_to_uint8(images[k])).to(dev), clouds[at[k]],
                masks[at[k]], pipe.cam, vcfg)
            jq, jt = ref[f"{key}rel_q"], ref[f"{key}rel_t"]
            rows.append({
                "regime": name, "frame": k, "tracked": int(n),
                "jax_tracked": int(ref[f"{key}tracked"]),
                "dt_m": float(np.abs(rel.t.cpu().numpy() - jt).max()),
                "dr_rad": _quat_angle(rel.q.cpu().numpy(), jq),
                "jax_spread_m": max(float(np.abs(t - jt).max())
                                    for t in ref[f"{key}nudged_rel_t"]),
                "jax_spread_rad": max(_quat_angle(q, jq) for q in ref[f"{key}nudged_rel_q"]),
            })
    return rows


def _step_gate(phase: str, rows: list, seconds: float) -> None:
    """The camera step gate on ``regime_camera_steps``'s rows: each step
    within STEP_TOL_M and STEP_TOL_RAD of JAX's, plus JAX's own one-ulp
    spread at that state. Prints the state nearest its limit and its share
    of it; raises above 1."""
    for r in rows:
        r["share"] = max(r["dt_m"] / (STEP_TOL_M + r["jax_spread_m"]),
                         r["dr_rad"] / (STEP_TOL_RAD + r["jax_spread_rad"]))
    worst = max(rows, key=lambda r: r["share"])
    quiet = [r for r in rows if r["jax_spread_m"] <= STEP_TOL_M]
    print(f"phase {phase}: camera steps from JAX states: where JAX's one-ulp spread stays "
          f"under {STEP_TOL_M} m ({len(quiet)} of {len(rows)} states) the largest "
          f"differences are {max(r['dt_m'] for r in quiet):.3g} m and "
          f"{max(r['dr_rad'] for r in quiet):.3g} rad; the nearest to its limit is "
          f"{worst['regime']} frame {worst['frame']}, {worst['dt_m']:.3g} m and "
          f"{worst['dr_rad']:.3g} rad against {STEP_TOL_M} m + {worst['jax_spread_m']:.3g} "
          f"and {STEP_TOL_RAD} rad + {worst['jax_spread_rad']:.3g} ({worst['share']:.3f} of "
          f"it); {seconds:.1f} s", flush=True)
    if not worst["share"] <= 1.0:
        raise AssertionError(f"phase {phase}: the camera step from JAX's state at "
                             f"{worst['regime']} frame {worst['frame']} lies {worst['dt_m']} m / "
                             f"{worst['dr_rad']} rad from JAX's (limits {STEP_TOL_M} + "
                             f"{worst['jax_spread_m']} m, {STEP_TOL_RAD} + "
                             f"{worst['jax_spread_rad']} rad)")


def render_regimes(pool) -> dict:
    """The regimes of ``tools/jax_reference_regimes.json`` (the eval
    script's), their scans and, for the camera regimes, images, submitted
    frame by frame to ``pool``: {name: (scan futures, image futures)}."""
    with open(REGIMES_REFERENCE) as f:
        ref = json.load(f)
    script = _script("eval_regimes_torch")
    out = {}
    for name, seq in script.build_regimes(0, ref["width"]).items():
        if name not in ref["regimes"]:
            continue
        out[name] = ([pool.submit(seq.scan, k) for k in range(seq.n_frames)],
                     [pool.submit(script.render_camera, seq, k) for k in range(seq.n_frames)]
                     if name in script.VISUAL_REGIMES else [])
    return out


def phase11_regimes(corridor_scans, rendered, dev):
    """Three of the eval script's regimes at full width against
    ``tools/jax_reference_regimes.json``, and the two packers side by side,
    on ``render_regimes``' renders. Raises on a failed gate; prints a line a
    step. Returns the phase's seconds."""
    import torch

    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import native_pack
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline
    from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    t_phase = time.perf_counter()
    with open(REGIMES_REFERENCE) as f:
        ref = json.load(f)
    script = _script("eval_regimes_torch")
    seqs = {name: seq for name, seq in script.build_regimes(0, ref["width"]).items()
            if name in ref["regimes"]}
    visual = script.VISUAL_REGIMES
    lcfg = SystemConfig().lidar
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range)

    # the regimes' scans and images, rendered in threads (one BLAS thread)
    # beside the earlier phases; the wait for what is left
    t0 = time.perf_counter()
    inputs = {}
    for name, (scan_futs, image_futs) in rendered.items():
        scans = [f.result() for f in scan_futs]
        images = [f.result() for f in image_futs]
        _check_inputs(f"11 ({name})", ref["regimes"][name], _sha256((*scans, *images)))
        inputs[name] = scans, images
    if set(inputs) != set(seqs):
        raise AssertionError(f"phase 11: rendered {sorted(inputs)}, not {sorted(seqs)}")
    render_s = time.perf_counter() - t0
    hashes = []
    for name, (scans, _) in inputs.items():
        got = _packed_sha256(scans)
        want = ref["regimes"][name]["packed_sha256"]
        hashes.append(f"{name} {got[:16]} ({'the same' if got == want else 'differs'}; JAX "
                      f"{want[:16]})")
    print(f"phase 11: rendered {sum(len(s) for s, _ in inputs.values())} scans and "
          f"{sum(len(i) for _, i in inputs.values())} images of {len(inputs)} regimes beside "
          f"the earlier phases ({render_s:.1f} s waited here), inputs hash as the reference's; "
          f"the native packer's images "
          f"(polar2, then polar) sha256: {'; '.join(hashes)} (reported, not gated: "
          f"-march=native may round otherwise on another CPU)", flush=True)

    # the two packers on the corridor's frames 1-8
    batch = corridor_scans[PACKER_FRAMES]
    native = native_pack.pack_polar_chunk(batch, **geom)
    plain = pc.pack_polar_chunk(batch, **geom)
    cells = native[..., 0].size
    n_range = int((native[..., 0] != plain[..., 0]).sum())
    n_filled = int(((native[..., 0] > 0) != (plain[..., 0] > 0)).sum())
    n_offsets = int((native[..., 1] != plain[..., 1]).sum())
    times = {"native": [], "numpy": []}
    for _ in range(5):
        for key, fn in (("native", native_pack.pack_polar_chunk),
                        ("numpy", pc.pack_polar_chunk)):
            t0 = time.perf_counter()
            fn(batch, channels=1, **geom)
            times[key].append((time.perf_counter() - t0) * 1e3 / len(batch))
    ms = {key: float(np.median(t)) for key, t in times.items()}
    print(f"phase 11: packers on the corridor's frames 1-8 ({cells} range cells): "
          f"{n_range} range cells differ ({100 * n_range / cells:.4f}%, limit "
          f"{100 * PACKER_DIFF_SHARE}%), {n_filled} filled in one packer and empty in the "
          f"other, {n_offsets} offset cells differ; polar2 pack of 8 frames, median of 5 "
          f"alternating rounds: native {ms['native']:.3f} ms/frame, numpy "
          f"{ms['numpy']:.3f} ms/frame", flush=True)
    if not n_range <= PACKER_DIFF_SHARE * cells:
        raise AssertionError(f"phase 11: the packers' range planes differ in {n_range} of "
                             f"{cells} cells")

    # (a) the bench's SLAM call on each regime, (b) the plain visual call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ates_visual, jax_visual, frames = [], [], 0
    t_runs = time.perf_counter()
    for name, (scans, images) in inputs.items():
        want = ref["regimes"][name]
        seq = seqs[name]
        gt = script.ground_truth(seq)
        t0 = time.perf_counter()
        odo, mapped = FullPipeline(SystemConfig(), device=dev).run_chunked(
            scans, chunk=8, map_skip=1, ingest="polar2")
        wall = time.perf_counter() - t0
        frames += len(scans) - 1
        line = []
        for key, res in (("odometry", odo), ("mapped", mapped)):
            pos = res.positions
            if pos.shape != gt.shape or not np.isfinite(pos).all():
                raise AssertionError(f"phase 11 ({name}): bad {key} trajectory {pos.shape}")
            ate = metrics.ate_rmse(pos, gt, align=False)
            jax = want[f"{key}_ate_m"]
            diff = float(np.abs(pos - np.asarray(want[f"{key}_positions"])).max())
            line.append(f"{key} ATE {ate:.5f} m (JAX CPU {jax:.5f} + {ATE_MARGIN}, largest "
                        f"position difference {diff:.5f} m)")
            if not ate <= jax + ATE_MARGIN:
                raise AssertionError(f"phase 11 ({name}): {key} ATE {ate} m exceeds the JAX "
                                     f"reference {jax} + {ATE_MARGIN}")
        print(f"phase 11: {name}, SLAM polar2, {len(scans)} frames: {'; '.join(line)}; "
              f"{(len(scans) - 1) / wall:.2f} frames/s", flush=True)
        if name not in visual:
            continue
        t0 = time.perf_counter()
        cl = CamLidarPipeline(camlidar_config(), device=dev).run_chunked(
            scans, images, chunk=8, ingest="polar")
        wall = time.perf_counter() - t0
        frames += len(scans) - 1
        if cl.visual_positions.shape != gt.shape or not np.isfinite(cl.visual_positions).all():
            raise AssertionError(f"phase 11 ({name}): bad visual trajectory")
        ate_v = metrics.ate_rmse(cl.visual_positions, gt, align=False)
        ate_l = metrics.ate_rmse(cl.lidar_positions, gt, align=False)
        ates_visual.append(ate_v)
        jax_visual.append(want["ate_visual_m"])
        diff = float(np.abs(cl.visual_positions - np.asarray(want["visual_positions"])).max())
        print(f"phase 11: {name}, cam-lidar polar, {len(scans)} frames: ate_visual "
              f"{ate_v:.5f} m (JAX CPU {want['ate_visual_m']:.5f}), ate_lidar {ate_l:.5f} m "
              f"(JAX CPU {want['ate_lidar_m']:.5f}), largest visual-position difference "
              f"{diff:.5f} m; {(len(scans) - 1) / wall:.2f} frames/s", flush=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    runs_s = time.perf_counter() - t_runs
    mean_v, mean_jax = float(np.mean(ates_visual)), float(np.mean(jax_visual))
    print(f"phase 11: mean ate_visual over {', '.join(visual)} {mean_v:.5f} m (JAX CPU "
          f"{mean_jax:.5f} m; reported, not gated: the camera drifts metres here and one "
          f"track's rounding moves that by centimetres); {frames} frames run in "
          f"{runs_s:.1f} s; launches {counts}", flush=True)
    path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop", "segment_sum",
            "block_topk_windowed", "lk_level")
    if min(counts[name] for name in path) == 0:
        raise AssertionError(f"phase 11: a kernel of the path was never launched: {counts}")
    tracked = sum(len(inputs[name][0]) - 1 for name in visual)
    if counts["lk_level"] != 4 * tracked:
        raise AssertionError(f"phase 11: expected 4 lk_level launches a tracked frame: "
                             f"{counts['lk_level']} over {tracked}")

    # the camera gate: one step of the port from each of JAX's carried states
    t0 = time.perf_counter()
    rows = regime_camera_steps({name: inputs[name] for name in visual}, dev)
    torch.cuda.synchronize()
    for name in visual:
        mine = [r for r in rows if r["regime"] == name]
        dts = ", ".join(f"{r['dt_m']:.3g}" for r in mine)
        drs = ", ".join(f"{r['dr_rad']:.3g}" for r in mine)
        print(f"phase 11: {name}, one camera step from each of {len(mine)} JAX states "
              f"(frames {[r['frame'] for r in mine]}): tracked "
              f"{[r['tracked'] for r in mine]} (JAX {[r['jax_tracked'] for r in mine]}), "
              f"translation differences (m) [{dts}], rotation (rad) [{drs}]", flush=True)
    if {r["regime"] for r in rows} != set(visual):
        raise AssertionError(f"phase 11: no camera step from a JAX state of "
                             f"{set(visual) - {r['regime'] for r in rows}}")
    _step_gate("11", rows, time.perf_counter() - t0)
    return time.perf_counter() - t_phase


def phase12_stress(dev) -> float:
    """One lap of the long-horizon stress drives through the ports of the
    JAX stress scripts, in this process, against
    ``tools/jax_reference_stress.json``. Raises on a failed gate; prints a
    line a script. Returns the phase's seconds."""
    import contextlib
    import io

    import torch

    from lidar_visual_odometry_tpu_torch import kernels

    t_phase = time.perf_counter()
    with open(STRESS_REFERENCE) as f:
        ref = json.load(f)
    argv = ["--laps", str(ref["laps"]), "--leg", str(ref["leg"]), "--turn", str(ref["turn"]),
            "--width", str(ref["width"]), "--chunk", str(ref["chunk"]), "--device", dev.type]
    slam_path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop", "segment_sum",
                 "block_topk_windowed")

    def run(mod):
        """The script's main on ``argv``; (its report, its printed lines,
        the launch counts, seconds)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = mod.main(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        return report, out.getvalue().splitlines(), counts, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        long_drive, visual_drive = _script("stress_long_torch"), _script("stress_visual_torch")
        long_drive.ROOT = visual_drive.ROOT = tmp    # the caches, the snapshot, the checkpoints
        slam, slam_lines, slam_counts, slam_s = run(long_drive)
        vis, vis_lines, vis_counts, vis_s = run(visual_drive)
        tag = f"{ref['laps']}x{ref['leg']}_{ref['turn']}_{ref['width']}"
        cached = np.load(os.path.join(tmp, f".stress_scans_{tag}.npz"))
        scans = [cached[f"s{k}"] for k in range(ref["frames"])]
        cam = visual_drive.CAM
        cached = np.load(os.path.join(tmp, f".stress_imgs_{tag}_{cam['width']}x{cam['height']}"
                                           ".npz"))
        images = [cached[f"i{k}"] for k in range(ref["frames"])]
    _check_inputs("12", ref, _sha256((*scans, *images)))
    print(f"phase 12: stress_long_torch.py {' '.join(argv)}: {slam_lines[-1]} in {slam_s:.1f} s, "
          f"launches {slam_counts}; {_packed_text(scans, ref)}", flush=True)
    print(f"phase 12: stress_visual_torch.py {' '.join(argv)}: {vis_lines[-1]} in {vis_s:.1f} s, "
          f"launches {vis_counts}", flush=True)
    if slam["frames"] != ref["frames"] or vis["frames"] != ref["frames"]:
        raise AssertionError(f"phase 12: {slam['frames']} and {vis['frames']} frames, not "
                             f"{ref['frames']}")
    for name, counts, path in (("stress_long", slam_counts, slam_path),
                               ("stress_visual", vis_counts, slam_path + ("lk_level",))):
        if min(counts.get(k, 0) for k in path) == 0:
            raise AssertionError(f"phase 12: a kernel of {name}'s path was never launched: "
                                 f"{counts}")
    resumed = {"slam": slam["resume_bit_exact"], "coupled": vis["coupled_resume_bit_exact"],
               "direct": vis["direct_resume_bit_exact"]}
    if not all(resumed.values()):
        raise AssertionError(f"phase 12: a resumed run is not the uninterrupted one: {resumed} "
                             f"(SLAM largest difference {slam['resume_max_diff']} m)")
    line = []
    for what, got, key in (("SLAM odometry", slam["ate_odom_m"], "slam_ate_odom_m"),
                           ("SLAM mapped", slam["ate_mapped_m"], "slam_ate_mapped_m"),
                           ("coupled lidar", vis["coupled_ate_lidar_m"], "coupled_ate_lidar_m"),
                           ("coupled mapped", vis["coupled_ate_mapped_m"],
                            "coupled_ate_mapped_m")):
        if not got <= ref[key] + ATE_MARGIN:
            raise AssertionError(f"phase 12: {what} ATE {got} m exceeds the JAX reference "
                                 f"{ref[key]} + {ATE_MARGIN}")
        line.append(f"{what} ATE {got:.4f} m (JAX CPU {ref[key]:.5f} m + {ATE_MARGIN})")
    print(f"phase 12: {ref['frames']} frames, {'; '.join(line)}; resumed bit for bit in all "
          f"three modes; not gated (the U-turn blinds the camera): coupled visual ATE "
          f"{vis['coupled_ate_visual_m']:.4f} m (JAX {ref['coupled_ate_visual_m']:.5f}), direct "
          f"ATE {vis['direct_ate_m']:.4f} m (JAX {ref['direct_ate_m']:.5f}); SLAM t_rel "
          f"{slam['t_rel_pct']}% (JAX {ref['slam_t_rel_pct']:.3f}%), corner map occupancy "
          f"{slam['map_occupancy_corner']} (JAX {ref['slam_map_occupancy_corner']:.3f})",
          flush=True)
    return time.perf_counter() - t_phase


def phase13_diag(scans, images, depths) -> float:
    """``scripts/diag_visual_torch.py``'s four passes over the corridor's
    frames through its ``main`` on the card, against
    ``tools/jax_reference_diag.json``. Raises on a failed gate; prints a line
    a pass. Returns the phase's seconds."""
    import contextlib
    import io

    import torch

    from lidar_visual_odometry_tpu_torch import kernels

    t_phase = time.perf_counter()
    with open(DIAG_REFERENCE) as f:
        ref = json.load(f)
    m = ref["frames"]
    _check_inputs("13", ref, _sha256((*scans[:m], *images[:m], *depths[:m])))
    diag = _script("diag_visual_torch")
    with tempfile.TemporaryDirectory() as tmp:
        diag.ROOT = tmp     # its cache: this script's renders
        np.savez(os.path.join(tmp, f".bench_diag_{m}.npz"),
                 **{f"s{k}": scans[k] for k in range(m)},
                 **{f"i{k}": images[k] for k in range(m)},
                 **{f"d{k}": depths[k] for k in range(m)})
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = diag.main(["--device", "cuda", "--quiet", "--frames", str(m)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if report["inputs_sha256"] != ref["inputs_sha256"]:
        raise AssertionError("phase 13: the script ran other inputs than the reference's")
    passes = report["passes"]
    if set(passes) != set(ref["passes"]):
        raise AssertionError(f"phase 13: passes {sorted(passes)}, the reference's "
                             f"{sorted(ref['passes'])}")
    if counts.get("lk_level", 0) != 4 * (m - 1) * len(passes):
        raise AssertionError(f"phase 13: expected 4 lk_level launches a tracked frame of each "
                             f"pass: {counts}")
    text = []
    for mode, got in passes.items():
        want = ref["passes"][mode]
        if len(got["stats"]) != m - 1 or not np.isfinite(got["ate_m"]):
            raise AssertionError(f"phase 13: {mode}: {len(got['stats'])} frames, ATE "
                                 f"{got['ate_m']}")
        members = want.get("ulp_members", [])
        base = max([want["ate_m"]] + [mem["ate_m"] for mem in members])
        if not got["ate_m"] <= base + ATE_MARGIN:
            raise AssertionError(f"phase 13: {mode} ATE {got['ate_m']} m exceeds the JAX "
                                 f"reference's {base} + {ATE_MARGIN}")
        spread = (f", one-ulp members {min(x['ate_m'] for x in members):.5f}-"
                  f"{max(x['ate_m'] for x in members):.5f} m" if members else "")
        text.append(f"{mode} ATE {got['ate_m']:.5f} m (JAX CPU {want['ate_m']:.5f} m{spread}; "
                    f"limit {base + ATE_MARGIN:.5f})")
    port_d = passes["gt_depth"]["ate_m"] - passes["base"]["ate_m"]
    jax_d = ref["passes"]["gt_depth"]["ate_m"] - ref["passes"]["base"]["ate_m"]
    print(f"phase 13: diag_visual_torch.py on {m} frames in {run_s:.1f} s: {'; '.join(text)}; "
          f"gt_depth - base ATE {port_d:+.5f} m (JAX {jax_d:+.5f} m); launches {counts}",
          flush=True)
    return time.perf_counter() - t_phase


def phase14_scaling() -> float:
    """``scripts/bench_scaling_torch.py`` on one NCCL rank and two gloo ranks
    of the card through its ``main``: prints its rows, gates the ranks'
    agreement and the two ranks against the one, and K2's launches. Returns
    the phase's seconds."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    scaling = _script("bench_scaling_torch")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = scaling.main(["--device", "cuda", "--ranks", "1,2", "--reps", str(SCALING_REPS)])
    if [r["devices"] for r in rows] != [1, 2] or [r["backend"] for r in rows] != ["nccl", "gloo"]:
        raise AssertionError(f"phase 14: fleets {[(r['devices'], r['backend']) for r in rows]}")
    for r in rows:
        keys = ("odometry_ms", "mapping_ms", "ba_ms", "ba_weak_ms", "odometry_eff", "mapping_eff",
                "ba_eff")
        print(f"phase 14: {r['devices']} rank(s), {r['backend']}: "
              + ", ".join(f"{k} {r[k]:.3f}" for k in keys)
              + f"; slowest rank {r['slowest_rank_ms']}; poses from one rank's: "
              + ", ".join(f"{s} {r[f'{s}_vs_1_rank']:.3g} m" for s in SCALING_VS_1_RANK_M)
              + f"; ranks agree within {r['ranks_agree']:.3g}; the fleet took "
              f"{r['fleet_s']:.1f} s; launches {r['launches']}", flush=True)
        if r["launches"].get("associate_kernel", 0) == 0:
            raise AssertionError(f"phase 14: K2 was never launched on {r['devices']} rank(s): "
                                 f"{r['launches']}")
        if not r["ranks_agree"] <= RANKS_AGREE:
            raise AssertionError(f"phase 14: the {r['devices']} ranks differ by "
                                 f"{r['ranks_agree']}")
        for stage, tol in SCALING_VS_1_RANK_M.items():
            if not r[f"{stage}_vs_1_rank"] <= tol:
                raise AssertionError(f"phase 14: {stage} on {r['devices']} ranks lies "
                                     f"{r[f'{stage}_vs_1_rank']} from one rank's (limit {tol})")
    return time.perf_counter() - t_phase


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from lidar_visual_odometry_tpu_torch import kernels
    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.kernels import _build
    from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
    from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM, camlidar_config
    from lidar_visual_odometry_tpu_torch.utils.config import MappingConfig, SystemConfig

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # The corridor's and phase 11's regimes' renders start first, in threads
    # beside the build: rendering is numpy, which releases the GIL, and the
    # build's longest nvcc runs keep only two cores busy. Threads, not
    # processes: the script must leave no process behind.
    seq = synthetic.SyntheticSequence(
        n_frames=N_FRAMES, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    workers = max(1, min(8, os.cpu_count() or 1) - 2)

    def render_image(k):
        Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        return synthetic.render_image(seq.scene, Rc, tc, **CAM)

    pool = ThreadPoolExecutor(workers)
    scan_futs = [pool.submit(seq.scan, k) for k in range(N_FRAMES)]
    image_futs = [pool.submit(render_image, k) for k in range(N_FRAMES)]
    regimes = render_regimes(pool)

    # ---- phase 0: the card, the toolchain, the build ----
    smi = _smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc seconds per source: {per_source})", flush=True)

    t0 = time.perf_counter()
    scans = [f.result() for f in scan_futs]
    rendered = [f.result() for f in image_futs]
    # the images, and the ground-truth depth maps phase 13 swaps in
    images, depths = [r[0] for r in rendered], [r[1] for r in rendered]
    gt = np.stack([seq.pose(k)[1] for k in range(N_FRAMES)])
    scans_sha = _sha256(scans)
    scans_images_sha = _sha256((*scans, *images))
    print(f"rendered {N_FRAMES} scans and camera images beside the build ({workers} threads, "
          f"one BLAS thread each; {time.perf_counter() - t0:.1f} s waited after it): sha256 "
          f"{scans_sha[:16]} (scans), {scans_images_sha[:16]} (scans, then images)", flush=True)

    # ---- phase 1: each kernel against its plain version ----
    results = []
    rng = np.random.default_rng(SEED)
    maps, queries, mcfg, assoc = _world_map(scans, seq, dev)
    for fn in (lambda: phase1_segsum(rng, dev), lambda: phase1_assoc(rng, dev),
               lambda: phase1_gn(rng, dev), lambda: phase1_flat_segsum(rng, dev),
               lambda: phase1_topk_windowed(maps, queries, mcfg),
               lambda: phase1_topk_dense(maps, queries, mcfg),
               lambda: phase1_lk(images, dev),
               lambda: phase1_feature_select(scans, dev),
               lambda: phase1_ring_top2(assoc, coords=False),
               lambda: phase1_ring_top2(assoc, coords=True),
               lambda: phase1_topk_coords_packed(maps, queries, mcfg, packed=False),
               lambda: phase1_topk_coords_packed(maps, queries, mcfg, packed=True)):
        r = fn()
        results.append(r)
        extra = "".join(f", {key} {r[key]:.4f}" for key in (
            "skip_share", "cdist_topk_two_calls_ms", "cdist_topk_gather_three_calls_ms") if key in r)
        extra += "".join(f", {key} {r[key]}" for key in ("output_mismatches", "ms_1_iteration",
                                                          "accepted_picks")
                         if key in r)
        print(f"phase 1: {r['name']} [{r['shapes']}] max_abs_err {r['max_abs_err']:.3g} "
              f"({r['tolerance']}); kernel_ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, "
              f"library_ms {r['library_ms']}, bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']}){extra}", flush=True)
    del maps, queries, assoc
    print(f"phases 0-1 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 2: the odometry path at full width ----
    with open(REFERENCE) as f:
        reference = json.load(f)
    jax_ate = reference["ate_m"]
    _check_inputs("2", reference, scans_sha)
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
    odometry_path = ("segment_sum_batched", "associate_kernel", "gn_inner_loop",
                     "feature_select")
    if min(counts[name] for name in odometry_path) == 0:
        raise AssertionError(f"a kernel of the odometry path was never launched: {counts}")
    if not ate <= jax_ate + ATE_MARGIN:
        raise AssertionError(f"ATE {ate} m exceeds the JAX reference {jax_ate} + {ATE_MARGIN}")
    launches = {name: counts[name] for name in odometry_path}

    # ---- phase 3: the fused SLAM path at full width ----
    with open(SLAM_REFERENCE) as f:
        slam_ref = json.load(f)
    jax_map_ate = slam_ref["mapped_ate_m"]
    _check_inputs("3", slam_ref, scans_sha)
    FullPipeline(cfg, device="cuda").run_chunked(scans, chunk=8, map_skip=1, ingest="polar2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    odo, mapped = FullPipeline(cfg, device="cuda").run_chunked(
        scans, chunk=8, map_skip=1, ingest="polar2")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = sum(mapped.per_frame_s[1:])
    map_ate = metrics.ate_rmse(mapped.positions, gt)
    odo_ate = metrics.ate_rmse(odo.positions, gt)
    peak = torch.cuda.max_memory_allocated()
    rounds = counts["block_topk_windowed"] / 2 / frames
    dev_jax = float(np.abs(mapped.positions - np.asarray(slam_ref["mapped_positions"])).max())
    print(f"phase 3: {frames} frames, {frames / wall:.2f} frames/s, "
          f"{1e3 * wall / frames:.3f} ms/frame, mapped ATE {map_ate:.5f} m (JAX CPU "
          f"reference {jax_map_ate:.5f} m + {ATE_MARGIN}), odometry ATE {odo_ate:.5f} m, "
          f"largest mapped-position difference from the JAX trajectory {dev_jax:.5f} m, "
          f"{rounds:.2f} mapping rounds/frame, peak device memory {peak / 2**20:.1f} MiB, "
          f"launches {counts}", flush=True)
    if mapped.positions.shape != (N_FRAMES, 3) or not np.isfinite(mapped.positions).all():
        raise AssertionError(f"bad mapped trajectory: shape {mapped.positions.shape}")
    slam_path = odometry_path + ("segment_sum", "block_topk_windowed")
    if min(counts[name] for name in slam_path) == 0:
        raise AssertionError(f"a kernel of the SLAM path was never launched: {counts}")
    if not map_ate <= jax_map_ate + ATE_MARGIN:
        raise AssertionError(
            f"mapped ATE {map_ate} m exceeds the JAX reference {jax_map_ate} + {ATE_MARGIN}")
    if not np.array_equal(odo.positions, res.positions):
        raise AssertionError("the SLAM run's odometry positions differ from phase 2's: "
                             f"{float(np.abs(odo.positions - res.positions).max())} m")
    launches.update({name: counts[name] for name in ("segment_sum", "block_topk_windowed")})

    # ---- phase 3b: the dense search (K5) on the first frames ----
    _check_inputs("3b", slam_ref, scans_sha)
    cfg_dense = SystemConfig(mapping=MappingConfig(windowed_nn=False))
    kernels.reset_launch_counts()
    _, mapped_dense = FullPipeline(cfg_dense, device="cuda").run_chunked(
        scans[:DENSE_FRAMES], chunk=8, map_skip=1, ingest="polar2")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    diff = float(np.abs(mapped_dense.positions - mapped.positions[:DENSE_FRAMES]).max())
    # the positions' bytes, hashed: two runs (two trees) map alike iff these agree
    digest = hashlib.sha256(np.ascontiguousarray(mapped_dense.positions).tobytes()).hexdigest()
    print(f"phase 3b: {DENSE_FRAMES} frames with windowed_nn=False, largest mapped-position "
          f"difference from phase 3 {diff:.3g} m (tolerance {DENSE_TOL_M}), mapped positions "
          f"sha256 {digest[:16]}, launches {counts}", flush=True)
    if counts["block_topk"] == 0 or counts["block_topk_windowed"] != 0:
        raise AssertionError(f"the dense search did not run kernel K5 alone: {counts}")
    if not diff <= DENSE_TOL_M:
        raise AssertionError(f"dense and windowed mapping disagree by {diff} m")
    launches["block_topk"] = counts["block_topk"]
    print(f"phases 0-3b took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 4: the camera path at full width ----
    with open(CAMLIDAR_REFERENCE) as f:
        cl_ref = json.load(f)
    jax_ate_visual = cl_ref["ate_visual_m"]
    _check_inputs("4", cl_ref, scans_images_sha)
    cl_cfg = camlidar_config()
    CamLidarPipeline(cl_cfg, device="cuda").run_chunked(scans, images, chunk=8, ingest="polar2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    vf.reset_stats()
    pipe = CamLidarPipeline(cl_cfg, device="cuda")
    cl = pipe.run_chunked(scans, images, chunk=8, ingest="polar2")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = pipe.last_wall
    peak = torch.cuda.max_memory_allocated()
    R0, t00 = seq.pose(0)
    gt_rel = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(N_FRAMES)])
    ate_visual = metrics.ate_rmse(cl.visual_positions, gt_rel, align=False)
    dev_jax = float(np.abs(cl.visual_positions - np.asarray(cl_ref["visual_positions"])).max())
    tracked = int(vf.stats["tracked"]) / vf.stats["frames"]
    solve_its = int(vf.stats["solve_iterations"]) / vf.stats["frames"]
    print(f"phase 4: {frames} frames, {frames / wall:.2f} frames/s, "
          f"{1e3 * wall / frames:.3f} ms/frame, ate_visual {ate_visual:.5f} m (JAX CPU "
          f"interpret-mode reference {jax_ate_visual:.5f} m + {ATE_MARGIN}), largest "
          f"visual-position difference from the JAX trajectory {dev_jax:.5f} m, "
          f"{tracked:.1f} tracked features and {solve_its:.2f} solve_pose iterations a frame, "
          f"peak device memory {peak / 2**20:.1f} MiB, launches {counts}", flush=True)
    if cl.visual_positions.shape != (N_FRAMES, 3) or not np.isfinite(cl.visual_positions).all():
        raise AssertionError(f"bad visual trajectory: shape {cl.visual_positions.shape}")
    camera_path = odometry_path + ("lk_level",)
    if min(counts[name] for name in camera_path) == 0:
        raise AssertionError(f"a kernel of the camera path was never launched: {counts}")
    if counts["lk_level"] != 4 * frames:
        raise AssertionError(f"expected 4 lk_level launches a frame: {counts['lk_level']}")
    base, spread = _ensemble(jax_ate_visual, cl_ref["ulp_members"])
    print(f"phase 4: ate_visual {ate_visual:.5f} m against the JAX run's {jax_ate_visual:.5f} m "
          f"and its {spread}: limit {base:.5f} + {ATE_MARGIN} m", flush=True)
    if not ate_visual <= base + ATE_MARGIN:
        raise AssertionError(f"ate_visual {ate_visual} m exceeds the JAX reference's largest "
                             f"{base} + {ATE_MARGIN}")
    # the camera step gate: one port step from each JAX state of CORRIDOR_STEPS
    t0 = time.perf_counter()
    rows = regime_camera_steps({"corridor": (scans, images)}, dev, CORRIDOR_STEPS)
    torch.cuda.synchronize()
    if len(rows) != len(range(4, N_FRAMES, 4)):
        raise AssertionError(f"phase 4: {len(rows)} camera steps from JAX states, not "
                             f"{len(range(4, N_FRAMES, 4))}")
    dts = ", ".join(f"{r['dt_m']:.3g}" for r in rows)
    print(f"phase 4: one camera step from each of {len(rows)} JAX states (frames "
          f"{[r['frame'] for r in rows]}) on the natively packed scans "
          f"({_packed_text(scans, cl_ref)}): tracked {[r['tracked'] for r in rows]} (JAX "
          f"{[r['jax_tracked'] for r in rows]}), translation differences (m) [{dts}]",
          flush=True)
    _step_gate("4", rows, time.perf_counter() - t0)
    if not np.array_equal(cl.lidar_positions, res.positions):
        raise AssertionError("the cam-lidar run's lidar positions differ from phase 2's: "
                             f"{float(np.abs(cl.lidar_positions - res.positions).max())} m")
    launches["lk_level"] = counts["lk_level"]
    print(f"phases 0-4 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 5: the k-NN entry points off the product path ----
    counts, stats, tie_rel = phase5_knn(scans, res, mapped, dev)
    print(f"phase 5: {frames} frames, K7 (both forms) agrees with K2 and K8 with K5, K5p with K5 "
          f"up to ties of the cut distance: {stats}, largest relative gap of a tie {tie_rel:.3g} "
          f"(bound 2^-8), launches {counts}", flush=True)
    knn_path = ("ring_top2_pallas", "ring_top2_coords", "block_topk_coords", "block_topk_packed")
    if min(counts[name] for name in knn_path) == 0:
        raise AssertionError(f"a kernel of the k-NN entry points was never launched: {counts}")
    launches.update({name: counts[name] for name in knn_path})
    print(f"phases 0-5 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 6: direct photometric VO at full width ----
    d = phase6_direct(scans, images, gt_rel, dev)
    print(f"phase 6: {frames} frames, {d['frames_per_s']:.2f} frames/s, "
          f"{d['ms_per_frame']:.3f} ms/frame, ate_direct {d['ate_direct_m']:.5f} m (JAX CPU "
          f"reference {d['jax_ate_direct_m']:.5f} m + {ATE_MARGIN}), largest position "
          f"difference from the JAX trajectory {d['largest_position_difference_m']:.5f} m "
          f"(quaternion {d['largest_quaternion_difference']:.5f}; from the JAX host loop's "
          f"{d['largest_position_difference_from_the_host_loop_m']:.5f} m, limit "
          f"{HOST_LOOP_TOL_M}), warm and timed runs bit for bit: "
          f"{d['runs_bit_for_bit']}, "
          f"{d['track_iterations_per_frame']:.2f} tracker iterations and "
          f"{d['ba_rounds_per_frame']:.2f} BA rounds a frame, peak device memory "
          f"{d['peak_device_memory_mib']:.1f} MiB, launches of the port's kernels "
          f"{d['launches']}", flush=True)
    print(f"phases 0-6 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 7: the per-frame drivers, the default ingests, resume ----
    host_map = phase7_drivers(scans, images, gt, gt_rel, scans_images_sha, res, (odo, mapped),
                              dev)
    print(f"phases 0-7 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 8: the coupled and mapping cam-lidar modes, IMU fusion ----
    t0 = time.perf_counter()
    phase8_modes(scans, images, seq, gt, gt_rel, mapped, cl, dev)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s; phases 0-8 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 9: the distributed layer, one NCCL rank and two gloo ranks ----
    t0 = time.perf_counter()
    phase9_distributed(scans, images, gt, gt_rel, host_map)
    t9 = time.perf_counter() - t0

    # ---- phase 10: the KITTI runner and the native reader ----
    t0 = time.perf_counter()
    phase10_runner(scans, seq)
    print(f"phase 9 took {t9:.1f} s, phase 10 {time.perf_counter() - t0:.1f} s; phases 0-10 "
          f"took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 11: three synthetic regimes, the packers side by side ----
    t11 = phase11_regimes(scans, regimes, dev)
    pool.shutdown()
    print(f"phase 11 took {t11:.1f} s; phases 0-11 took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # ---- phase 12: one lap of the long-horizon stress drives ----
    t12 = phase12_stress(dev)
    print(f"phase 12 took {t12:.1f} s; phases 0-12 took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # ---- phase 13: the feature-VO drift diagnosis, four passes ----
    t13 = phase13_diag(scans, images, depths)
    print(f"phase 13 took {t13:.1f} s; phases 0-13 took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # ---- phase 14: the distributed stages on one and two ranks ----
    t14 = phase14_scaling()
    print(f"phase 14 took {t14:.1f} s; phases 0-14 took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    for r in results:
        r["launches"] = launches[r["name"]]
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
