"""ATE of the JAX package's lidar odometry on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` gates its own ATE on this number: the
port must reach the JAX reference's accuracy on the same 48-frame synthetic
HDL-64 sequence (``bench.py`` lidar mode: ``SystemConfig()`` lidar/odometry
defaults, ``run_chunked(scans, chunk=8, ingest="polar2")``).

Runs the JAX package on the CPU (its XLA branches; no Pallas kernel runs
there). Takes a few minutes and a few GiB of host memory. Writes the ATE,
the estimated positions and a sha256 of the scans (``inputs_sha256``) to
``tools/jax_reference_corridor.json``, which ``chip_smoke.py`` reads, and
prints them.

    python tools/jax_reference_ate.py [--frames 49] [--out PATH]
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
from lidar_visual_odometry_tpu.models.pipeline import OdometryPipeline  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_corridor.json"))
    args = ap.parse_args()

    seq = synthetic.SyntheticSequence(
        n_frames=args.frames, width=1800, speed=1.0, yaw_rate=0.004, noise=0.01
    )
    t0 = time.time()
    scans = [seq.scan(k) for k in range(args.frames)]
    render_s = time.time() - t0
    gt = np.stack([seq.pose(k)[1] for k in range(args.frames)])

    t0 = time.time()
    res = OdometryPipeline(SystemConfig()).run_chunked(
        scans, chunk=8, ingest="polar2"
    )
    run_s = time.time() - t0
    out = json.dumps({
        "backend": jax.default_backend(),
        "frames": args.frames,
        "inputs_sha256": inputs_sha256(*scans),
        "ate_m": metrics.ate_rmse(res.positions, gt),
        "render_s": render_s,
        "run_s": run_s,
        "positions": res.positions.tolist(),
    })
    with open(args.out, "w") as f:
        f.write(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
