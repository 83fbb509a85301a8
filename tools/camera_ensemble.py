"""One-ulp camera ensembles on phase 4's corridor, the port's and the JAX package's.

``chip_smoke.py`` phase 4 gates the port's ``ate_visual`` at the largest of
the JAX run's and its four one-ulp members' (``tools/jax_reference_camlidar.py``:
the run with ``fx`` or ``fy`` moved by one float32 ulp) + 0.01 m. This tool
shows how far rounding alone spreads each package's camera there, for
information; no gate reads it. Each run is ``CamLidarPipeline(cfg)
.run_chunked(scans, images, chunk=8, ingest="polar2")`` on the corridor's 49
frames with the bench camera, and each member moves one intrinsic of ``cfg``
by one float32 ulp up or down (``jax_reference_camlidar.nudged``).

``--side port`` (the default; ``--device cuda``): the port's unnudged run and
one run a member, each ``ate_visual`` printed beside the JAX member's from
the reference JSON where it has one. ``--side jax`` (CPU): the JAX package's
runs of the members, its tracker's levels on ``pallas_lk.lk_level`` in
interpret mode as the reference's; ``--eager`` adds the unnudged run under
``jax.disable_jit()`` (the same operations rounded one at a time, about
half an hour).

Scans and images are rendered in threads with numpy's BLAS held to one
thread and must hash as the reference's inputs. A member takes about 10 s on
the card and two minutes on the CPU.

    python tools/camera_ensemble.py [--side port|jax] [--members fx,fy,cx,cy] [--eager]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def members(names: str) -> list:
    return [(name, way) for name in names.split(",") if name for way in ("up", "down")]


def port_side(ref, scans, images, gt_rel, names, device) -> list:
    from lidar_visual_odometry_tpu_torch.eval import metrics
    from lidar_visual_odometry_tpu_torch.models.cam_lidar_pipeline import CamLidarPipeline
    from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config

    cfg = camlidar_config()
    jax_ates = {(m["intrinsic"], m["direction"]): m["ate_visual_m"] for m in ref["ulp_members"]}
    runs = [("reference", "", cfg, ref["ate_visual_m"])]
    for name, way in members(names):
        value = np.float32(getattr(cfg.camera, name))
        to = np.float32(np.inf if way == "up" else -np.inf)
        cam = dataclasses.replace(cfg.camera, **{name: float(np.nextafter(value, to))})
        runs.append((name, way, dataclasses.replace(cfg, camera=cam),
                     jax_ates.get((name, way))))
    rows = []
    for name, way, mcfg, jax_ate in runs:
        t0 = time.perf_counter()
        res = CamLidarPipeline(mcfg, device=device).run_chunked(scans, images, chunk=8,
                                                                ingest="polar2")
        rows.append({"member": f"{name} {way}".strip(), "ate_visual_m": metrics.ate_rmse(
            res.visual_positions, gt_rel, align=False), "jax_ate_visual_m": jax_ate,
            "s": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def jax_side(ref, scans, images, seq, names, eager) -> list:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax_reference_camlidar import (
        ate_visual, bench_config, lk_through_pallas_interpret, nudged,
    )
    from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import CamLidarPipeline

    cfg = bench_config()
    n = len(scans)
    runs = [(f"{name} {way}", nudged(cfg, name, way)) for name, way in members(names)]
    rows = []
    with lk_through_pallas_interpret():
        for label, mcfg in runs:
            t0 = time.perf_counter()
            res = CamLidarPipeline(mcfg).run_chunked(scans, images, chunk=8, ingest="polar2")
            rows.append({"member": label, "jax_ate_visual_m": ate_visual(
                seq, res.visual_positions, n), "s": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        if eager:
            t0 = time.perf_counter()
            with jax.disable_jit():
                res = CamLidarPipeline(cfg).run_chunked(scans, images, chunk=8,
                                                        ingest="polar2")
            rows.append({"member": "reference, eager", "jax_ate_visual_m": ate_visual(
                seq, res.visual_positions, n), "s": time.perf_counter() - t0,
                "largest_visual_position_difference_from_the_jitted_m": float(np.abs(
                    np.asarray(res.visual_positions)
                    - np.asarray(ref["visual_positions"])).max())})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--members", default="fx,fy",
                    help="intrinsics to move one float32 ulp up and down")
    ap.add_argument("--eager", action="store_true",
                    help="JAX side: also the unnudged run under jax.disable_jit()")
    args = ap.parse_args()

    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.utils.bench_config import CAM

    with open(chip_smoke.CAMLIDAR_REFERENCE) as f:
        ref = json.load(f)
    n = ref["frames"]
    seq = synthetic.SyntheticSequence(n_frames=n, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)

    def render(k):
        Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        return synthetic.render_image(seq.scene, Rc, tc, **CAM)[0]

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        images = list(ex.map(render, range(n)))
    chip_smoke._check_inputs("the ensemble", ref, chip_smoke._sha256((*scans, *images)))
    if args.side == "port":
        R0, t00 = seq.pose(0)
        gt_rel = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(n)])
        rows = port_side(ref, scans, images, gt_rel, args.members, args.device)
        ates = [r["ate_visual_m"] for r in rows]
    else:
        rows = jax_side(ref, scans, images, seq, args.members, args.eager)
        ates = [r["jax_ate_visual_m"] for r in rows]
    print(json.dumps({"side": args.side, "members": args.members, "range_m": [min(ates),
                      max(ates)], "mean_m": float(np.mean(ates))}))


if __name__ == "__main__":
    main()
