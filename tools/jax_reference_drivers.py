"""The JAX package's per-frame drivers and default ingests on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 7 gates on these numbers: each run
of the port must reach the ATE of the same call of the JAX package, plus
0.01 m, on the same synthetic sequence (``SystemConfig()`` at full width,
capacity 131072; the camera runs with ``bench.py``'s ``_config()``, as
``tools/jax_reference_camlidar.py`` builds it). The calls:

* ``OdometryPipeline(cfg).run_chunked(scans)`` (the default ``"float"``
  ingest), ``run_chunked(scans, quantize=True)`` (``"uint16"``) and the
  per-frame ``run(scans)``, over all frames;
* ``FullPipeline(cfg).run_chunked(scans, map_skip=1)`` (the default
  ``"uint16"`` ingest), over all frames;
* ``FullPipeline(cfg, device_map=True).run(scans[:17])`` and
  ``device_map=False`` (the host cube map), over 17 frames;
* ``CamLidarPipeline(bench_config()).run_chunked(scans[:17], images[:17])``
  (the default ``"uint16"`` ingest) and ``.run(scans[:17], images[:17])``
  (per frame, paired by ``match_nearest``), over 17 frames, with the tracker's
  levels on ``pallas_lk.lk_level`` in interpret mode
  (``tools/jax_reference_camlidar.py``'s routing). The chunk and the per-frame
  driver run the same algorithm under other fusion boundaries and other
  inputs (the chunk uploads uint8 images and uint16 clouds, the per-frame
  driver the float ones), so the largest difference between their visual
  positions is the reference's own spread, which the file records. With
  ``--eager`` both camera calls also run under ``jax.disable_jit()``: the same
  operations rounded one at a time, without XLA's fusions and contractions,
  which is the reference's rounding spread at equal fusion boundaries (about
  twenty more minutes).

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5). Takes about ten minutes. Writes
``tools/jax_reference_drivers.json`` (each run's ATE and positions, and a
sha256 of the scans, then the images), which ``chip_smoke.py`` reads, and
prints it.

    python tools/jax_reference_drivers.py [--frames 49] [--out PATH] [--eager]
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
    ate_visual, bench_config, inputs_sha256, lk_through_pallas_interpret, render,
)
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import CamLidarPipeline  # noqa: E402
from lidar_visual_odometry_tpu.models.pipeline import (  # noqa: E402
    FullPipeline, OdometryPipeline,
)
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402

SHORT_FRAMES = 17   # the per-frame SLAM and the camera runs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_drivers.json"))
    ap.add_argument("--eager", action="store_true",
                    help="also run the camera calls under jax.disable_jit()")
    args = ap.parse_args()

    n, m = args.frames, SHORT_FRAMES
    seq = synthetic.SyntheticSequence(n_frames=n, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        images = list(ex.map(partial(render, seq), range(n)))
    out = {"backend": jax.default_backend(), "frames": n, "short_frames": m,
           "inputs_sha256": inputs_sha256(*scans, *images), "render_s": time.time() - t0}
    gt = np.stack([seq.pose(k)[1] for k in range(n)])
    cfg = SystemConfig()

    def record(name, positions, ate, t_start):
        out[f"{name}_ate_m"] = ate
        out[f"{name}_positions"] = np.asarray(positions).tolist()
        out[f"{name}_run_s"] = time.time() - t_start
        print(f"{name}: ATE {ate:.5f} m in {out[f'{name}_run_s']:.1f} s", flush=True)

    for name, kw in (("odometry_float", {}), ("odometry_uint16", {"quantize": True})):
        t0 = time.time()
        res = OdometryPipeline(cfg).run_chunked(scans, chunk=8, **kw)
        record(name, res.positions, metrics.ate_rmse(res.positions, gt), t0)
    t0 = time.time()
    res = OdometryPipeline(cfg).run(scans)
    record("odometry_per_frame", res.positions, metrics.ate_rmse(res.positions, gt), t0)

    t0 = time.time()
    _, mapped = FullPipeline(cfg).run_chunked(scans, chunk=8, map_skip=1)
    record("slam_uint16_mapped", mapped.positions, metrics.ate_rmse(mapped.positions, gt), t0)
    for device_map in (True, False):
        t0 = time.time()
        _, mapped = FullPipeline(cfg, device_map=device_map).run(scans[:m])
        record(f"slam_per_frame_device_map_{str(device_map).lower()}_mapped", mapped.positions,
               metrics.ate_rmse(mapped.positions, gt[:m]), t0)

    cl_cfg = bench_config()
    with lk_through_pallas_interpret():
        t0 = time.time()
        chunked = CamLidarPipeline(cl_cfg).run_chunked(scans[:m], images[:m], chunk=8)
        record("camlidar_uint16_visual", chunked.visual_positions,
               ate_visual(seq, chunked.visual_positions, m), t0)
        t0 = time.time()
        per_frame = CamLidarPipeline(cl_cfg).run(scans[:m], images[:m])
        record("camlidar_per_frame_visual", per_frame.visual_positions,
               ate_visual(seq, per_frame.visual_positions, m), t0)
    out["camlidar_chunk_against_per_frame_largest_position_difference_m"] = float(
        np.abs(chunked.visual_positions - per_frame.visual_positions).max())
    if args.eager:
        with lk_through_pallas_interpret(), jax.disable_jit():
            for name, call, jitted in (
                    ("camlidar_uint16_visual_eager",
                     lambda: CamLidarPipeline(cl_cfg).run_chunked(scans[:m], images[:m], chunk=8),
                     chunked),
                    ("camlidar_per_frame_visual_eager",
                     lambda: CamLidarPipeline(cl_cfg).run(scans[:m], images[:m]), per_frame)):
                t0 = time.time()
                res = call()
                record(name, res.visual_positions, ate_visual(seq, res.visual_positions, m), t0)
                out[f"{name}_against_jitted_largest_position_difference_m"] = float(
                    np.abs(res.visual_positions - jitted.visual_positions).max())

    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
