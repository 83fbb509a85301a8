"""Mapped ATE of the JAX package's fused SLAM on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 3 gates its mapped ATE on this
number: the port must reach the JAX reference's accuracy on the same 48-frame
synthetic HDL-64 sequence (``bench.py`` mode 2, "fused SLAM":
``FullPipeline(SystemConfig()).run_chunked(scans, chunk=8, map_skip=1,
ingest="polar2")``).

Runs the JAX package on the CPU, where it takes its XLA branches: the dense
chunked ``knn.knn`` for the scan-to-map 5-NN (``lidar_mapping.py:133``), not
the cell-windowed kernel. Within the 1 m association gates both find the same
neighbours. Takes minutes and a few GiB of host memory. Writes the mapped and
odometry ATE, the mapped positions and a sha256 of the scans
(``inputs_sha256``) to ``tools/jax_reference_slam.json``,
which ``chip_smoke.py`` reads, and prints them.

    python tools/jax_reference_slam.py [--frames 49] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# numpy's OpenBLAS has corrupted renders made while other threads called it;
# one BLAS thread keeps every render deterministic (ROADMAP C.5). Set before
# numpy is first imported.
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from jax_reference_camlidar import inputs_sha256  # noqa: E402
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.pipeline import FullPipeline  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_slam.json"))
    args = ap.parse_args()

    seq = synthetic.SyntheticSequence(
        n_frames=args.frames, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    t0 = time.time()
    scans = [seq.scan(k) for k in range(args.frames)]
    render_s = time.time() - t0
    gt = np.stack([seq.pose(k)[1] for k in range(args.frames)])

    t0 = time.time()
    odom, mapped = FullPipeline(SystemConfig()).run_chunked(
        scans, chunk=8, map_skip=1, ingest="polar2"
    )
    run_s = time.time() - t0
    out = json.dumps({
        "backend": jax.default_backend(),
        "frames": args.frames,
        "inputs_sha256": inputs_sha256(*scans),
        "mapped_ate_m": metrics.ate_rmse(mapped.positions, gt),
        "odometry_ate_m": metrics.ate_rmse(odom.positions, gt),
        "render_s": render_s,
        "run_s": run_s,
        "mapped_positions": mapped.positions.tolist(),
    })
    with open(args.out, "w") as f:
        f.write(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
