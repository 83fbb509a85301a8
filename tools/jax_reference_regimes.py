"""The JAX package on three of ``scripts/eval_regimes.py``'s regimes, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 11 gates its runs on these numbers.
The regimes are the eval script's own at its default 1800 azimuth samples:
``rotation_heavy`` (an S-curve, 41 frames), ``revisit_out_and_back`` (45
frames) and ``high_noise`` (30 frames). On each it runs

(a) the bench's SLAM call, ``FullPipeline(SystemConfig()).run_chunked(scans,
    chunk=8, map_skip=1, ingest="polar2")``: odometry and mapped ATE and
    positions;

and on the first two

(b) the eval script's plain visual call, ``CamLidarPipeline(vcfg).run_chunked(
    scans, images, chunk=8, ingest="polar")`` with its bench-scale camera
    (``eval_regimes.py``'s ``vcfg``, which is ``jax_reference_camlidar.py``'s
    ``bench_config()``), the tracker's levels routed to
    ``pallas_lk.lk_level(interpret=True)`` as the TPU runs them:
    ``ate_visual``, ``ate_lidar`` and the positions.

Every ATE is the eval script's: positions against the ground truth in the
first frame's body frame, no alignment. Each regime records a sha256 of its
inputs (``inputs_sha256``: the scans, then the images where it has them) and
of the JAX native packer's images of all its frames (``packed_sha256``: the
range-only ``polar2`` images, then the two-channel ``polar`` ones).

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5). Takes about twenty minutes. Writes
``tools/jax_reference_regimes.json`` after each run (so a cut run keeps what
it finished) and prints it at the end.

    python tools/jax_reference_regimes.py [--out PATH]
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
    bench_config, inputs_sha256, lk_through_pallas_interpret, render,
)
from lidar_visual_odometry_tpu.data import native_pack, synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import CamLidarPipeline  # noqa: E402
from lidar_visual_odometry_tpu.models.pipeline import FullPipeline  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402

WIDTH = 1800
VISUAL = ("rotation_heavy", "revisit_out_and_back")


def regimes(width: int = WIDTH) -> dict:
    """``eval_regimes.py``'s regimes but the long corridor, as it builds them."""
    return {
        "rotation_heavy": synthetic.PiecewiseArcSequence.s_curve(
            leg=20, yaw_rate=0.04, width=width, noise=0.01),
        "revisit_out_and_back": synthetic.PiecewiseArcSequence.out_and_back(
            leg=16, turn=12, width=width, noise=0.01),
        "high_noise": synthetic.SyntheticSequence(
            n_frames=30, width=width, yaw_rate=0.01, noise=0.05),
    }


def packed_sha256(scans) -> str:
    """sha256 of the native packer's polar2 images of every frame, then its
    polar images, at the pipeline's geometry."""
    lcfg = SystemConfig().lidar
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range)
    return inputs_sha256(native_pack.pack_polar_chunk(scans, channels=1, **geom),
                         native_pack.pack_polar_chunk(scans, channels=2, **geom))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_regimes.json"))
    args = ap.parse_args()

    seqs = regimes()
    out = {"backend": jax.default_backend(), "width": WIDTH,
           "lk": "pallas_lk.lk_level, interpret mode", "regimes": {}}

    def save():
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")

    inputs = {}
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        for name, seq in seqs.items():
            n = seq.n_frames
            scans = list(ex.map(seq.scan, range(n)))
            images = list(ex.map(partial(render, seq), range(n))) if name in VISUAL else []
            inputs[name] = (scans, images)
    out["render_s"] = time.time() - t0

    for name, seq in seqs.items():
        scans, images = inputs[name]
        n = seq.n_frames
        R0, t00 = seq.pose(0)
        gt = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(n)])
        t0 = time.time()
        odom, mapped = FullPipeline(SystemConfig()).run_chunked(
            scans, chunk=8, map_skip=1, ingest="polar2")
        out["regimes"][name] = {
            "frames": n,
            "inputs_sha256": inputs_sha256(*scans, *images),
            "packed_sha256": packed_sha256(scans),
            "odometry_ate_m": metrics.ate_rmse(odom.positions, gt, align=False),
            "mapped_ate_m": metrics.ate_rmse(mapped.positions, gt, align=False),
            "slam_run_s": time.time() - t0,
            "odometry_positions": odom.positions.tolist(),
            "mapped_positions": mapped.positions.tolist(),
        }
        save()

    cfg = bench_config()
    with lk_through_pallas_interpret():
        for name in VISUAL:
            seq = seqs[name]
            scans, images = inputs[name]
            n = seq.n_frames
            R0, t00 = seq.pose(0)
            gt = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(n)])
            t0 = time.time()
            res = CamLidarPipeline(cfg).run_chunked(scans, images, chunk=8, ingest="polar")
            out["regimes"][name].update({
                "ate_visual_m": metrics.ate_rmse(res.visual_positions, gt, align=False),
                "ate_lidar_m": metrics.ate_rmse(res.lidar_positions, gt, align=False),
                "visual_run_s": time.time() - t0,
                "visual_positions": res.visual_positions.tolist(),
                "lidar_positions": res.lidar_positions.tolist(),
            })
            save()
    out["mean_ate_visual_m"] = float(np.mean(
        [out["regimes"][name]["ate_visual_m"] for name in VISUAL]))
    save()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
