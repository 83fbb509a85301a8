"""The JAX package's distributed layer on the bench's corridor, on the CPU over
8 virtual devices.

The PyTorch port's ``chip_smoke.py`` phase 9 gates on these numbers: each
distributed run of the port must reach the ATE of the same call of the JAX
package, plus 0.01 m, on the same synthetic sequence (the corridor of the
other ``tools/jax_reference_*.py`` at full width, 64 x 2048, capacity
131072), over its first 17 frames. The calls:

* ``DistributedSlamPipeline(SystemConfig()).run(scans[:17])``: the odometry
  and mapped ATEs and positions;
* ``DistributedCamLidarPipeline(bench_config()).run(scans[:17],
  images[:17])`` (coupled, ``map_skip=1``), the tracker's levels on
  ``pallas_lk.lk_level`` in interpret mode (``tools/jax_reference_camlidar.py``'s
  routing): the lidar and mapped ATEs, ``ate_visual`` (no alignment, against
  the poses relative to frame 0) and the positions;
* ``sharded_refine`` on a direct-VO window of the same images: the keyframes
  of frames ``BA_FRAMES``, each with 1024 camera-frame points (the depth
  cloud ``camera_cloud_select`` cuts from its scan, 2048 points, every
  second one), the camera poses relative to frame 0 perturbed by
  ``BA_NOISE`` (frame 0 fixed), level 0, pairs within 2, ``ba_iters`` (4)
  steps: the initial and the refined poses.

The cam-lidar run's one-ulp ensemble (``jax_reference_camlidar.ulp_members``:
the run with ``fx`` up, ``fx`` down, ``fy`` up, ``fy`` down by one float32
ulp) goes under ``camlidar_ulp_members``, and ``packed_sha256`` is the JAX
native packer's images of the 17 frames (polar2, then polar).

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5). Writes ``tools/jax_reference_parallel.json`` (with a sha256 of
the 17 scans, then the 17 images, and one of the BA window's images, points
and masks), which ``chip_smoke.py`` reads, and prints it.

    python tools/jax_reference_parallel.py [--frames 17] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# one BLAS thread keeps the threaded render deterministic (ROADMAP C.5); set
# before numpy is first imported
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jax_reference_camlidar import (  # noqa: E402
    ate_visual, bench_config, inputs_sha256, lk_through_pallas_interpret, packed_sha256, render,
    ulp_members,
)
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import camera_cloud_select  # noqa: E402
from lidar_visual_odometry_tpu.ops import camera, se3  # noqa: E402
from lidar_visual_odometry_tpu.parallel import sharded_ba, sharded_odometry  # noqa: E402
from lidar_visual_odometry_tpu.parallel.distributed_camlidar import (  # noqa: E402
    DistributedCamLidarPipeline,
)
from lidar_visual_odometry_tpu.parallel.distributed_pipeline import (  # noqa: E402
    DistributedSlamPipeline,
)
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402

BA_FRAMES = (0, 1, 2, 3, 4)
BA_CLOUD_CAP, BA_STRIDE = 2048, 2
# se3 tangent (t, θ) perturbations of keyframes 1-4 (keyframe 0 is the
# gauge): up to 2.9 cm, which 4 steps bring to about 1 cm (twice these left
# a keyframe where it began, and keyframes 2 m apart drifted off)
BA_NOISE = 0.5 * np.array([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                           [0.04, -0.03, 0.02, 0.004, -0.006, 0.005],
                           [-0.03, 0.04, -0.03, -0.005, 0.004, -0.006],
                           [0.02, 0.03, -0.04, 0.003, 0.005, -0.004],
                           [-0.04, -0.02, 0.03, -0.004, -0.003, 0.006]], np.float32)


def ba_window(seq, scans, images, cfg):
    """The BA window's host inputs: level-0 images (K, H, W), camera-frame
    points (K, P, 3) and masks (K, P), and the true camera poses relative to
    frame 0 as (K, 3, 3) rotations and (K, 3) translations (float64)."""
    E = np.asarray(cfg.extrinsic.matrix, np.float32)
    imgs, pts, masks, Rs, ts = [], [], [], [], []
    R0, t0 = synthetic.camera_from_velodyne_pose(*seq.pose(0))
    for k in BA_FRAMES:
        xyz, m = camera_cloud_select(np.asarray(scans[k])[:, :3], E[:, :3], E[:, 3], BA_CLOUD_CAP)
        pts.append(xyz[::BA_STRIDE])
        masks.append(m[::BA_STRIDE])
        imgs.append(np.asarray(images[k], np.float32))
        R, t = synthetic.camera_from_velodyne_pose(*seq.pose(k))
        Rs.append(R0.T @ R)
        ts.append(R0.T @ (t - t0))
    return np.stack(imgs), np.stack(pts), np.stack(masks), np.stack(Rs), np.stack(ts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_parallel.json"))
    args = ap.parse_args()

    m = args.frames
    # the corridor of the other references: its first m frames are the same
    seq = synthetic.SyntheticSequence(n_frames=49, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(m)))
        images = list(ex.map(partial(render, seq), range(m)))
    out = {"backend": jax.default_backend(), "devices": len(jax.devices()),
           "lk": "pallas_lk.lk_level, interpret mode", "frames": m,
           "inputs_sha256": inputs_sha256(*scans, *images), "render_s": time.time() - t0}
    gt = np.stack([seq.pose(k)[1] for k in range(m)])

    t0 = time.time()
    odom, mapped, _ = DistributedSlamPipeline(SystemConfig()).run(scans)
    out.update(slam_odometry_ate_m=metrics.ate_rmse(odom, gt),
               slam_mapped_ate_m=metrics.ate_rmse(mapped, gt),
               slam_odometry_positions=odom.tolist(), slam_mapped_positions=mapped.tolist(),
               slam_run_s=time.time() - t0)
    print(f"slam: odometry ATE {out['slam_odometry_ate_m']:.5f} m, mapped ATE "
          f"{out['slam_mapped_ate_m']:.5f} m in {out['slam_run_s']:.1f} s", flush=True)

    cfg = bench_config()
    t0 = time.time()
    with lk_through_pallas_interpret():
        odom, mapped, vis, _ = DistributedCamLidarPipeline(cfg).run(scans, images)
    out.update(camlidar_lidar_ate_m=metrics.ate_rmse(odom, gt),
               camlidar_mapped_ate_m=metrics.ate_rmse(mapped, gt),
               camlidar_ate_visual_m=ate_visual(seq, vis, m),
               camlidar_lidar_positions=odom.tolist(), camlidar_mapped_positions=mapped.tolist(),
               camlidar_visual_positions=np.asarray(vis).tolist(), camlidar_run_s=time.time() - t0)
    print(f"camlidar: lidar ATE {out['camlidar_lidar_ate_m']:.5f} m, mapped ATE "
          f"{out['camlidar_mapped_ate_m']:.5f} m, ate_visual {out['camlidar_ate_visual_m']:.5f} m "
          f"in {out['camlidar_run_s']:.1f} s", flush=True)

    def member(mcfg):
        with lk_through_pallas_interpret():
            _, _, v, _ = DistributedCamLidarPipeline(mcfg).run(scans, images)
        return v, ate_visual(seq, v, m)

    camlidar_members = ulp_members(cfg, member, np.asarray(vis))

    imgs, pts, masks, Rs, ts = ba_window(seq, scans, images, cfg)
    true = se3.Pose(se3.matrix_to_quat(jnp.asarray(Rs, jnp.float32)), jnp.asarray(ts, jnp.float32))
    init = se3.Pose(se3.quat_normalize(se3.quat_mul(se3.so3_exp(jnp.asarray(BA_NOISE[:, 3:])),
                                                    true.q)),
                    true.t + jnp.asarray(BA_NOISE[:, :3]))
    cam = camera.Pinhole.from_config(cfg.camera)
    t0 = time.time()
    refined = sharded_ba.sharded_refine(
        sharded_odometry.make_mesh(), (jnp.asarray(imgs),), jnp.asarray(pts),
        jnp.asarray(masks), init, cam, n_iters=cfg.visual.ba_iters, level=0,
        pair_radius=cfg.visual.ba_pair_radius)
    out.update(ba_frames=list(BA_FRAMES), ba_cloud_cap=BA_CLOUD_CAP, ba_stride=BA_STRIDE,
               ba_inputs_sha256=inputs_sha256(imgs, pts, masks),
               ba_true_t=np.asarray(true.t).tolist(), ba_init_q=np.asarray(init.q).tolist(),
               ba_init_t=np.asarray(init.t).tolist(), ba_q=np.asarray(refined.q).tolist(),
               ba_t=np.asarray(refined.t).tolist(), ba_n_iters=cfg.visual.ba_iters,
               ba_pair_radius=cfg.visual.ba_pair_radius, ba_run_s=time.time() - t0)
    err0 = np.linalg.norm(np.asarray(init.t) - np.asarray(true.t), axis=1).max()
    err1 = np.linalg.norm(np.asarray(refined.t) - np.asarray(true.t), axis=1).max()
    print(f"sharded_refine: largest position error {err0:.5f} m before, {err1:.5f} m after, "
          f"in {out['ba_run_s']:.1f} s", flush=True)

    out["camlidar_ulp_members"] = camlidar_members
    out["packed_sha256"] = packed_sha256(scans)
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
