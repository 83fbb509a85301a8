"""Visual ATE of the JAX package's cam-lidar pipeline on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 4 gates its ``ate_visual`` on this
number: the port must reach the JAX reference's accuracy on the same 48-frame
synthetic sequence and camera (``bench.py`` mode 3, "cam-lidar":
``CamLidarPipeline(cfg).run_chunked(scans, images, chunk=8, ingest="polar2")``
with ``bench.py``'s ``_config()``, images from ``synthetic.render_image``).

On the CPU the JAX package tracks features with the vmapped XLA
``lk._track_level``, which clamps every bilinear sample, runs a fixed
iteration count and ignores the ``active`` mask; on the TPU it runs the Pallas
kernel ``pallas_lk.lk_level``, which clamps the window origin, stops each
feature at ``lk_eps`` and skips inactive rows. Near a border the two track
differently. The port reproduces the kernel, so the reference run routes each
level to ``lk_level(..., interpret=True)``: ``ops/lk.py`` sees a TPU backend
(its own ``jax`` name is replaced by a proxy whose ``default_backend()`` says
"tpu"; nothing else in the JAX package sees it) and ``pallas_lk.lk_level`` is
wrapped to run in interpret mode. JAX's caches are cleared around the run so
that no program traced without the patch is reused. A second run without the
patch records the XLA path's ``ate_visual`` for information.

Takes several minutes (four interpret-mode LK calls a frame). Writes
``tools/jax_reference_camlidar.json``, which ``chip_smoke.py`` reads, and
prints it.

    python tools/jax_reference_camlidar.py [--frames 49] [--out PATH] [--no-xla]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import CamLidarPipeline  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import (  # noqa: E402
    CameraConfig, ExtrinsicConfig, SystemConfig, VisualConfig,
)

# bench.py's CAM and _config(), copied
CAM = dict(fx=240.0, fy=240.0, cx=320.0, cy=96.0, width=640, height=192)


def bench_config() -> SystemConfig:
    R_sc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    ext = tuple(tuple(float(v) for v in row) + (0.0,) for row in R_sc.T)
    return SystemConfig(
        camera=CameraConfig(fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"], cy=CAM["cy"],
                            width=CAM["width"], height=CAM["height"]),
        visual=VisualConfig(depth_cloud_cap=16384, lk_window=13, lk_levels=3,
                            lk_reverse_levels=1, lk_iters_coarse=4, max_tracked=768,
                            grid_cols=25),
        extrinsic=ExtrinsicConfig(matrix=ext),
    )


class _TpuBackendJax:
    """``jax`` as ``ops/lk.py`` sees it under the patch: every attribute is
    jax's own, except that ``default_backend()`` says "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextmanager
def lk_through_pallas_interpret():
    """Route ``lk.track_pyramid``'s levels to ``pallas_lk.lk_level`` in
    interpret mode, as the TPU runs them."""
    from lidar_visual_odometry_tpu.ops import lk as jlk
    from lidar_visual_odometry_tpu.ops import pallas_lk

    orig_jax, orig_level = jlk.jax, pallas_lk.lk_level
    jax.clear_caches()
    jlk.jax = _TpuBackendJax()
    pallas_lk.lk_level = partial(orig_level, interpret=True)
    try:
        yield
    finally:
        jlk.jax = orig_jax
        pallas_lk.lk_level = orig_level
        jax.clear_caches()


def render(seq, k):
    Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
    return synthetic.render_image(seq.scene, Rc, tc, **CAM)[0]


def ate_visual(seq, positions, n):
    R0, t00 = seq.pose(0)
    gt_rel = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(n)])
    return metrics.ate_rmse(positions, gt_rel, align=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_camlidar.json"))
    ap.add_argument("--no-xla", action="store_true",
                    help="skip the information-only run on the XLA LK path")
    args = ap.parse_args()

    n = args.frames
    seq = synthetic.SyntheticSequence(n_frames=n, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        images = list(ex.map(partial(render, seq), range(n)))
    render_s = time.time() - t0
    cfg = bench_config()

    t0 = time.time()
    with lk_through_pallas_interpret():
        res = CamLidarPipeline(cfg).run_chunked(scans, images, chunk=8, ingest="polar2")
    run_s = time.time() - t0
    out = {
        "backend": jax.default_backend(),
        "lk": "pallas_lk.lk_level, interpret mode",
        "frames": n,
        "ate_visual_m": ate_visual(seq, res.visual_positions, n),
        "render_s": render_s,
        "run_s": run_s,
        "visual_positions": res.visual_positions.tolist(),
        "visual_quats": res.visual_quats.tolist(),
        "lidar_positions": res.lidar_positions.tolist(),
    }
    if not args.no_xla:
        t0 = time.time()
        xla = CamLidarPipeline(cfg).run_chunked(scans, images, chunk=8, ingest="polar2")
        out["xla_lk_ate_visual_m"] = ate_visual(seq, xla.visual_positions, n)
        out["xla_lk_run_s"] = time.time() - t0
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
