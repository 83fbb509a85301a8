"""The JAX package on one lap of the long-horizon stress drives, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 12 gates on these numbers: it runs
``scripts/stress_long_torch.py`` and ``scripts/stress_visual_torch.py`` on
``--laps 1 --leg 6 --turn 14`` (41 frames at 1800 samples: a 6-frame leg, a
14-frame 180-degree U-turn, the leg back, the second U-turn), and each ATE
must lie within 0.01 m of the JAX run of the same calls here. One pass of
each JAX script's calls, at their configurations:

* ``scripts/stress_long.py``: frame 0 registered from its padded raw points,
  then every chunk of 8 packed by the native packer (polar2, the chunk padded
  to 8 frames) through ``device_mapping.slam_chunk_polar`` with ``map_skip``
  1: the odometry and mapped ATEs (no alignment), t_rel and r_rel of the
  mapped poses (``metrics.kitti_relative_errors``, step 4), the map's
  occupancy, the positions;
* ``scripts/stress_visual.py``: ``CamLidarPipeline(cfg).run_chunked(scans,
  images, chunk=8, ingest="polar2", coupled=True, mapping=True)`` with the
  bench camera, the tracker's levels on ``pallas_lk.lk_level`` in interpret
  mode (``tools/jax_reference_camlidar.py``'s routing): the lidar, mapped and
  visual ATEs and t_rel; ``DirectVOChunked(cam, cfg.visual,
  point_cap=2048).run_chunked`` on the images and ``_cam_cloud`` clouds: the
  direct ATE of its poses mapped to the lidar frame.

Scans and images are rendered in threads with numpy's BLAS held to one thread
(ROADMAP C.5). Records ``inputs_sha256`` (the scans, then the images) and
``packed_sha256`` (the JAX native packer's images of every frame, polar2,
then polar). Takes about twenty minutes. Writes
``tools/jax_reference_stress.json``, which ``chip_smoke.py`` reads, and
prints it.

    python tools/jax_reference_stress.py [--laps 1] [--leg 6] [--turn 14] [--out PATH]
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jax_reference_camlidar import (  # noqa: E402
    bench_config, inputs_sha256, lk_through_pallas_interpret, packed_sha256, render,
)
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.data.native_pack import pack_polar_chunk  # noqa: E402
from lidar_visual_odometry_tpu.eval import metrics  # noqa: E402
from lidar_visual_odometry_tpu.models import device_mapping as dm  # noqa: E402
from lidar_visual_odometry_tpu.models import lidar_odometry as lo  # noqa: E402
from lidar_visual_odometry_tpu.models import scan_registration as sr  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import (  # noqa: E402
    CamLidarPipeline, _map_cam_poses_to_lidar,
)
from lidar_visual_odometry_tpu.models.direct_vo import DirectVOChunked  # noqa: E402
from lidar_visual_odometry_tpu.ops import camera as cam_ops  # noqa: E402
from lidar_visual_odometry_tpu.ops import pointcloud as pc  # noqa: E402
from lidar_visual_odometry_tpu.ops import se3  # noqa: E402
from lidar_visual_odometry_tpu.utils.config import SystemConfig  # noqa: E402

CHUNK = 8


def drive(laps: int, leg: int, turn: int) -> synthetic.PiecewiseArcSequence:
    """The stress scripts' multi-lap out-and-back at 1800 samples."""
    lap = ((leg, 1.0, 0.0), (turn, 0.6, np.pi / turn), (leg, 1.0, 0.0),
           (turn, 0.6, np.pi / turn))
    return synthetic.PiecewiseArcSequence(width=1800, noise=0.01, segments=lap * laps)


def slam(scans, n):
    """``stress_long.py``'s uninterrupted run: (odometry positions, mapped
    positions, mapped quaternions, map state), frame 0 at the identity."""
    cfg = SystemConfig()
    lcfg = cfg.lidar
    xyz0, mask0 = pc.pad_points(np.asarray(scans[0])[:, :3], 131072)
    odo = lo.init_state(sr.register_scan(jnp.asarray(xyz0), jnp.asarray(mask0), lcfg).features)
    mp = dm.init_state(cfg.mapping)
    ot, mq, mt = [], [], []
    for s in range(1, n, CHUNK):
        imgs = pack_polar_chunk(scans[s:s + CHUNK], n_scans=lcfg.n_scans,
                                width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                                max_range=lcfg.max_range, n_frames=CHUNK, channels=1)
        odo, mp, op, mpo = dm.slam_chunk_polar(odo, mp, jnp.asarray(imgs), lcfg, cfg.odometry,
                                               cfg.mapping, start_idx=s, map_skip=1)
        ot.append(np.asarray(op.t))
        mq.append(np.asarray(mpo.q))
        mt.append(np.asarray(mpo.t))
    odom = np.concatenate([np.zeros((1, 3), np.float32), *ot])[:n]
    mapped = np.concatenate([np.zeros((1, 3), np.float32), *mt])[:n]
    mapped_q = np.concatenate([np.array([[1.0, 0, 0, 0]], np.float32), *mq])[:n]
    occ = (float(np.asarray(mp.corner_mask).sum()) / cfg.mapping.map_corner_cap,
           float(np.asarray(mp.surf_mask).sum()) / cfg.mapping.map_surf_cap)
    return odom, mapped, mapped_q, occ


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=1)
    ap.add_argument("--leg", type=int, default=6)
    ap.add_argument("--turn", type=int, default=14)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_stress.json"))
    args = ap.parse_args()

    seq = drive(args.laps, args.leg, args.turn)
    n = seq.n_frames
    t0 = time.time()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        images = list(ex.map(partial(render, seq), range(n)))
    out = {"backend": jax.default_backend(), "lk": "pallas_lk.lk_level, interpret mode",
           "laps": args.laps, "leg": args.leg, "turn": args.turn, "width": 1800,
           "chunk": CHUNK, "frames": n, "inputs_sha256": inputs_sha256(*scans, *images),
           "packed_sha256": packed_sha256(scans), "render_s": time.time() - t0}

    R0, t00 = seq.pose(0)
    gt = np.stack([R0.T @ (seq.pose(k)[1] - t00) for k in range(n)])
    gt_q = np.stack([np.asarray(se3.matrix_to_quat(jnp.asarray(R0.T @ seq.pose(k)[0],
                                                               dtype=jnp.float32)))
                     for k in range(n)])

    def ate(pos):
        return metrics.ate_rmse(np.asarray(pos), gt, align=False)

    def rel(qs, ts):
        t_rel, r_rel = metrics.kitti_relative_errors(
            metrics.poses_to_matrices(np.asarray(qs), np.asarray(ts)),
            metrics.poses_to_matrices(gt_q, gt), step=4)
        return float(t_rel), float(r_rel)

    t0 = time.time()
    odom, mapped, mapped_q, (occ_c, occ_s) = slam(scans, n)
    t_rel, r_rel = rel(mapped_q, mapped)
    out.update(slam_ate_odom_m=ate(odom), slam_ate_mapped_m=ate(mapped), slam_t_rel_pct=t_rel,
               slam_r_rel_deg_per_100m=r_rel, slam_map_occupancy_corner=occ_c,
               slam_map_occupancy_surf=occ_s, slam_odometry_positions=odom.tolist(),
               slam_mapped_positions=mapped.tolist(), slam_run_s=time.time() - t0)
    print(f"slam: odometry ATE {out['slam_ate_odom_m']:.5f} m, mapped ATE "
          f"{out['slam_ate_mapped_m']:.5f} m in {out['slam_run_s']:.1f} s", flush=True)

    cfg = bench_config()
    t0 = time.time()
    with lk_through_pallas_interpret():
        res = CamLidarPipeline(cfg).run_chunked(scans, images, chunk=CHUNK, ingest="polar2",
                                                coupled=True, mapping=True)
    t_rel, r_rel = rel(res.mapped_quats, res.mapped_positions)
    out.update(coupled_ate_lidar_m=ate(res.lidar_positions),
               coupled_ate_mapped_m=ate(res.mapped_positions),
               coupled_ate_visual_m=ate(res.visual_positions), coupled_t_rel_pct=t_rel,
               coupled_r_rel_deg_per_100m=r_rel,
               coupled_lidar_positions=np.asarray(res.lidar_positions).tolist(),
               coupled_mapped_positions=np.asarray(res.mapped_positions).tolist(),
               coupled_visual_positions=np.asarray(res.visual_positions).tolist(),
               coupled_run_s=time.time() - t0)
    print(f"coupled: lidar ATE {out['coupled_ate_lidar_m']:.5f} m, mapped ATE "
          f"{out['coupled_ate_mapped_m']:.5f} m, visual ATE {out['coupled_ate_visual_m']:.5f} m "
          f"in {out['coupled_run_s']:.1f} s", flush=True)

    t0 = time.time()
    clp = CamLidarPipeline(cfg)
    clouds, cmasks = zip(*(clp._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
    dvo = DirectVOChunked(cam_ops.Pinhole.from_config(cfg.camera), cfg.visual, point_cap=2048)
    ts_d, qs_d, _ = dvo.run_chunked(images, list(clouds), list(cmasks), chunk=CHUNK)
    _, vt = _map_cam_poses_to_lidar(jnp.asarray(qs_d), jnp.asarray(ts_d), clp.T_lidar_cam,
                                    clp.T_cam_lidar)
    out.update(direct_ate_m=ate(vt), direct_positions=np.asarray(vt).tolist(),
               direct_run_s=time.time() - t0)
    print(f"direct: ATE {out['direct_ate_m']:.5f} m in {out['direct_run_s']:.1f} s", flush=True)

    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
