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

Rounding alone moves the camera's trajectory by centimetres (``PERF.md`` §6),
so the tool also runs the ensemble that ``chip_smoke.py`` bounds the port's
``ate_visual`` with: four members, each the reference run with one camera
intrinsic moved by one float32 ulp (``fx`` up, ``fx`` down, ``fy`` up, ``fy``
down; the pipelines compute in float32). A member whose visual trajectory
comes out bit for bit the reference run's is replaced by ``cx`` up, then
``cy`` up. Each member's ``ate_visual`` goes under ``ulp_members``. The
record also holds a sha256 of the JAX native packer's images of every frame
(``packed_sha256``: the range-only polar2 images, then the two-channel polar
ones), which ``chip_smoke.py`` prints beside the port's.

Scans and images are rendered in threads with numpy's BLAS held to one
thread (several BLAS threads under several Python threads have corrupted
renders). Takes about ten minutes (four interpret-mode LK calls a frame, six runs).
Writes ``tools/jax_reference_camlidar.json`` (with a sha256 of the scans,
then the images), which ``chip_smoke.py`` reads, and prints it.

    python tools/jax_reference_camlidar.py [--frames 49] [--out PATH] [--no-xla]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
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

from lidar_visual_odometry_tpu.data import native_pack, synthetic  # noqa: E402
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


def inputs_sha256(*arrays) -> str:
    """sha256 over the arrays' bytes in order: the scans, then the images."""
    digest = hashlib.sha256()
    for arr in arrays:
        digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def packed_sha256(scans) -> str:
    """sha256 of the JAX native packer's polar2 images of every frame, then
    its polar images, at the pipelines' lidar geometry."""
    lcfg = SystemConfig().lidar
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range)
    return inputs_sha256(native_pack.pack_polar_chunk(scans, channels=1, **geom),
                         native_pack.pack_polar_chunk(scans, channels=2, **geom))


# The ensemble's members: a camera intrinsic and the way it moves by one
# float32 ulp; the spares replace, in order, a member that leaves the visual
# trajectory bit for bit the reference run's.
MEMBERS = (("fx", "up"), ("fx", "down"), ("fy", "up"), ("fy", "down"))
SPARES = (("cx", "up"), ("cy", "up"))


def nudged(cfg: SystemConfig, name: str, direction: str) -> SystemConfig:
    """``cfg`` with one camera intrinsic moved by one float32 ulp."""
    value = np.float32(getattr(cfg.camera, name))
    to = np.float32(np.inf if direction == "up" else -np.inf)
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, **{name: float(np.nextafter(value, to))}))


def ulp_members(cfg: SystemConfig, run, visual_positions) -> list:
    """``run(cfg')`` -> (visual positions, ``ate_visual``) for each member's
    configuration; a member whose positions equal ``visual_positions`` bit
    for bit is replaced by the next spare. One record a member."""
    members, spares = [], list(SPARES)
    for name, direction in MEMBERS:
        while True:
            t0 = time.time()
            mcfg = nudged(cfg, name, direction)
            positions, ate = run(mcfg)
            positions = np.asarray(positions)
            if not np.array_equal(positions, visual_positions):
                break
            print(f"member {name} {direction}: the visual trajectory is the reference run's "
                  f"bit for bit; replaced", flush=True)
            if not spares:
                raise SystemExit("no spare member left")
            name, direction = spares.pop(0)
        members.append({
            "intrinsic": name, "direction": direction,
            "value": getattr(mcfg.camera, name), "ate_visual_m": ate,
            "largest_visual_position_difference_m": float(
                np.abs(positions - visual_positions).max()),
            "run_s": time.time() - t0})
        print(f"member {name} {direction}: ate_visual {ate:.5f} m", flush=True)
    return members


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

        def member(mcfg):
            r = CamLidarPipeline(mcfg).run_chunked(scans, images, chunk=8, ingest="polar2")
            return r.visual_positions, ate_visual(seq, r.visual_positions, n)

        members = ulp_members(cfg, member, np.asarray(res.visual_positions))
    out = {
        "backend": jax.default_backend(),
        "lk": "pallas_lk.lk_level, interpret mode",
        "frames": n,
        "inputs_sha256": inputs_sha256(*scans, *images),
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
    out["ulp_members"] = members
    out["packed_sha256"] = packed_sha256(scans)
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
