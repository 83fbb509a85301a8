"""The JAX package's coupled and mapping cam-lidar modes and its IMU-fused odometry on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 8 gates on these numbers: each run
of the port must reach the ATE of the same call of the JAX package, plus
0.01 m, on the same synthetic sequence (the corridor of the other
``tools/jax_reference_*.py`` at full width, 64 x 2048, capacity 131072). The
calls:

* ``CamLidarPipeline(bench_config()).run_chunked(scans[:17], images[:17],
  chunk=8, ingest="polar2")`` with ``coupled=True`` (8a), ``mapping=True``
  (8b) and both (8c), the tracker's levels on ``pallas_lk.lk_level`` in
  interpret mode (``tools/jax_reference_camlidar.py``'s routing): each run's
  lidar ATE, ``ate_visual`` (no alignment, against the poses relative to
  frame 0) and, with mapping, the mapped ATE, and the trajectories;
* ``ImuFusedOdometry(SystemConfig()).process`` over all 49 frames (8e), each
  frame with its bundle (``sync.bundle_imu``) of
  ``synthesize_imu(seq, frame_period=0.1, rate_hz=100.0)`` at its defaults
  (seed 7, its noise), intervals of 1/100 s: the fused ATE and positions
  (``chip_smoke.py`` gates on the first 17: the fusion is causal).

With ``--eager`` the coupled run also runs under ``jax.disable_jit()``: the
same operations rounded one at a time, the reference's own rounding spread,
which the coupled lidar inherits from the camera (seven minutes more).

The coupled run's one-ulp ensemble (``jax_reference_camlidar.ulp_members``:
the run with ``fx`` up, ``fx`` down, ``fy`` up, ``fy`` down by one float32
ulp) goes under ``coupled_ulp_members``; one mode is enough, because the
three share one visual trajectory. ``packed_sha256`` is the JAX native
packer's images of the 17 frames (polar2, then polar).

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5). Takes about fifteen minutes, twenty-two with ``--eager``. Writes
``tools/jax_reference_modes.json`` (with a sha256 of the scans, the images
and the IMU stream's stamps, accelerations and rates, in that order), which
``chip_smoke.py`` reads, and prints it.

    python tools/jax_reference_modes.py [--frames 49] [--out PATH] [--eager]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# numpy's OpenBLAS has corrupted renders made while other threads called it;
# one BLAS thread keeps the threaded render deterministic (ROADMAP C.5). Set
# before numpy is first imported.
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from jax_reference_camlidar import (  # noqa: E402
    ate_visual, bench_config, inputs_sha256, lk_through_pallas_interpret, packed_sha256, render,
    ulp_members,
)
from lidar_visual_odometry_tpu.data import sync, synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import CamLidarPipeline  # noqa: E402
from lidar_visual_odometry_tpu.models.imu_fusion import ImuFusedOdometry  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402

SHORT_FRAMES = 17   # the camera runs
FRAME_PERIOD, IMU_RATE_HZ = 0.1, 100.0
MODES = {"coupled": dict(coupled=True), "mapping": dict(mapping=True),
         "coupled_mapping": dict(coupled=True, mapping=True)}


def imu_stream(seq):
    """``synthesize_imu`` at its defaults: (stamps, accel, gyro, dts)."""
    stamps, accel, gyro = synthetic.synthesize_imu(seq, frame_period=FRAME_PERIOD,
                                                   rate_hz=IMU_RATE_HZ)
    return stamps, accel, gyro, np.full(stamps.shape, 1.0 / IMU_RATE_HZ, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_modes.json"))
    ap.add_argument("--eager", action="store_true",
                    help="also run the coupled camera call under jax.disable_jit()")
    args = ap.parse_args()

    n, m = args.frames, SHORT_FRAMES
    seq = synthetic.SyntheticSequence(n_frames=n, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        images = list(ex.map(partial(render, seq), range(n)))
    stamps, accel, gyro, dts = imu_stream(seq)
    out = {"backend": jax.default_backend(), "lk": "pallas_lk.lk_level, interpret mode",
           "frames": n, "short_frames": m,
           "inputs_sha256": inputs_sha256(*scans, *images, stamps, accel, gyro),
           "render_s": time.time() - t0}
    gt = np.stack([seq.pose(k)[1] for k in range(n)])

    def record(name, res, t_start):
        out[f"{name}_lidar_ate_m"] = metrics.ate_rmse(res.lidar_positions, gt[:m])
        out[f"{name}_ate_visual_m"] = ate_visual(seq, res.visual_positions, m)
        out[f"{name}_lidar_positions"] = res.lidar_positions.tolist()
        out[f"{name}_visual_positions"] = res.visual_positions.tolist()
        if res.mapped_positions is not None:
            out[f"{name}_mapped_ate_m"] = metrics.ate_rmse(res.mapped_positions, gt[:m])
            out[f"{name}_mapped_positions"] = res.mapped_positions.tolist()
        out[f"{name}_run_s"] = time.time() - t_start
        print(f"{name}: " + ", ".join(f"{k[len(name) + 1:]} {v:.5f}" for k, v in out.items()
                                      if k.startswith(name) and k.endswith(("_m", "_s"))),
              flush=True)

    cfg = bench_config()
    with lk_through_pallas_interpret():
        runs = {}
        for name, kw in MODES.items():
            t0 = time.time()
            runs[name] = CamLidarPipeline(cfg).run_chunked(scans[:m], images[:m], chunk=8,
                                                           ingest="polar2", **kw)
            record(name, runs[name], t0)

        # the one-ulp ensemble of the coupled run (the three modes share one
        # visual trajectory: mapping does not feed back into it)
        def member(mcfg):
            r = CamLidarPipeline(mcfg).run_chunked(scans[:m], images[:m], chunk=8,
                                                   ingest="polar2", coupled=True)
            return r.visual_positions, ate_visual(seq, r.visual_positions, m)

        out["coupled_ulp_members"] = ulp_members(
            cfg, member, np.asarray(runs["coupled"].visual_positions))
    if args.eager:
        with lk_through_pallas_interpret(), jax.disable_jit():
            t0 = time.time()
            res = CamLidarPipeline(cfg).run_chunked(scans[:m], images[:m], chunk=8,
                                                    ingest="polar2", coupled=True)
            record("coupled_eager", res, t0)
        for kind in ("lidar", "visual"):
            out[f"coupled_eager_against_jitted_largest_{kind}_position_difference_m"] = float(
                np.abs(getattr(res, f"{kind}_positions")
                       - getattr(runs["coupled"], f"{kind}_positions")).max())

    t0 = time.time()
    fuser = ImuFusedOdometry(SystemConfig())
    bundles = sync.bundle_imu(np.arange(n) * FRAME_PERIOD, stamps)
    fused = np.stack([np.asarray(fuser.process(scans[k], accel[i], gyro[i], dts[i]).t)
                      for k, i in enumerate(bundles)])
    out["imu_fused_ate_m"] = metrics.ate_rmse(fused, gt)
    out["imu_fused_positions"] = fused.tolist()
    out["imu_fused_run_s"] = time.time() - t0
    print(f"imu_fused: ATE {out['imu_fused_ate_m']:.5f} m in {out['imu_fused_run_s']:.1f} s",
          flush=True)

    out["packed_sha256"] = packed_sha256(scans[:m])
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
