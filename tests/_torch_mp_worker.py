"""The rank functions of the port's fleet tests (started by
``lidar_visual_odometry_tpu_torch.parallel.launch``; the PyTorch counterpart
of ``tests/_mp_worker.py``).

Each function runs on every rank of a gloo fleet on the CPU: it takes the
rank's mesh and the inputs the test wrote (numpy arrays, the same on every
rank), runs the port's distributed functions on them and returns numpy
arrays; the test compares the ranks with one another and with the JAX
package's sharded functions. This module imports torch, numpy and the port,
nothing else: the configurations the JAX side uses are built from the same
numbers in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_visual_odometry_tpu_torch.models.lidar_mapping import LocalMap
from lidar_visual_odometry_tpu_torch.models import visual_frontend as vf
from lidar_visual_odometry_tpu_torch.ops import camera, se3
from lidar_visual_odometry_tpu_torch.ops.features import FeatureCloud, ScanFeatures
from lidar_visual_odometry_tpu_torch.ops.pointcloud import PointBatch
from lidar_visual_odometry_tpu_torch.parallel import multihost
from lidar_visual_odometry_tpu_torch.parallel import sharded_ba, sharded_mapping
from lidar_visual_odometry_tpu_torch.parallel import sharded_odometry, sharded_visual
from lidar_visual_odometry_tpu_torch.utils.config import (
    CameraConfig, ExtrinsicConfig, LidarConfig, MappingConfig, OdometryConfig, SystemConfig,
    VisualConfig,
)

# tests/test_parallel.py's sizes and configurations
ODOM_CFG = OdometryConfig(outer_iters=4, gn_iters=4)
MAP_CFG = MappingConfig(outer_iters=3, gn_iters=4)
VIS_CFG = VisualConfig(gn_iters=30, lk_levels=2, lk_window=9, grid_rows=2, grid_cols=4,
                       max_tracked=64, max_features_per_cell=8, depth_cloud_cap=2048)
CAM = dict(fx=120.0, fy=120.0, cx=160.0, cy=48.0, width=320, height=96)
BA_ITERS = 8
SLAM_CAPACITY = 65536
SLAM_CFG = SystemConfig(lidar=LidarConfig(azimuth_bins=1024),
                        odometry=OdometryConfig(outer_iters=3, gn_iters=4))
R_SC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
CAMLIDAR_CFG = SystemConfig(
    lidar=LidarConfig(azimuth_bins=1024),
    odometry=OdometryConfig(outer_iters=3, gn_iters=4),
    camera=CameraConfig(**CAM),
    visual=VisualConfig(gn_iters=20, lk_levels=2, lk_window=9, grid_rows=2, grid_cols=4,
                        max_tracked=64, max_features_per_cell=8, depth_cloud_cap=2048),
    extrinsic=ExtrinsicConfig(matrix=tuple(tuple(float(v) for v in row) + (0.0,)
                                           for row in R_SC.T)),
)


def _t(mesh, x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def _pose(mesh, inputs, name):
    return se3.Pose(_t(mesh, inputs[f"{name}_q"]), _t(mesh, inputs[f"{name}_t"]))


def _cloud(mesh, inputs, name):
    return FeatureCloud(*(_t(mesh, inputs[f"{name}_{k}"])
                          for k in ("xyz", "ring", "rel_time", "mask")))


def _cam(mesh):
    return camera.Pinhole(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], CAM["width"],
                          CAM["height"], torch.zeros(5, device=mesh.device))


def sharded_cases(mesh, inputs):
    """Each sharded function whose inputs the test wrote: odometry
    (``odo_*``), mapping (``map_*``), BA (``ba_*``), the visual step
    (``vis_*``), and ``multihost``'s placement (``mh_*``)."""
    out = {}
    if "odo_sharp_xyz" in inputs:
        curr = ScanFeatures(*(_cloud(mesh, inputs, f"odo_{k}")
                              for k in ("sharp", "less_sharp", "flat", "less_flat")))
        pose = sharded_odometry.sharded_scan_to_scan(
            mesh, curr, _cloud(mesh, inputs, "odo_prev_less_sharp"),
            _cloud(mesh, inputs, "odo_prev_less_flat"), se3.identity_pose(mesh.device),
            ODOM_CFG)
        out.update(odo_q=pose.q, odo_t=pose.t)
    if "map_corner_xyz" in inputs:
        local = LocalMap(*(PointBatch(_t(mesh, inputs[f"map_{c}_xyz"]),
                                      _t(mesh, inputs[f"map_{c}_mask"])) for c in ("lc", "ls")))
        pose = sharded_mapping.sharded_mapping_step(
            mesh, _t(mesh, inputs["map_corner_xyz"]), _t(mesh, inputs["map_corner_mask"]),
            _t(mesh, inputs["map_surf_xyz"]), _t(mesh, inputs["map_surf_mask"]), local,
            _pose(mesh, inputs, "map_init"), MAP_CFG)
        out.update(map_q=pose.q, map_t=pose.t)
    if "ba_points" in inputs:
        levels = sum(1 for k in inputs if k.startswith("ba_pyr"))
        pyrs = tuple(_t(mesh, inputs[f"ba_pyr{lvl}"]) for lvl in range(levels))
        poses = sharded_ba.sharded_refine(
            mesh, pyrs, _t(mesh, inputs["ba_points"]), _t(mesh, inputs["ba_mask"]),
            _pose(mesh, inputs, "ba_init"), _cam(mesh), n_iters=BA_ITERS, level=0)
        out.update(ba_q=poses.q, ba_t=poses.t)
    if "vis_table_uv" in inputs:
        levels = VIS_CFG.lk_levels
        prev_pyr = tuple(_t(mesh, inputs[f"vis_prev{lvl}"]) for lvl in range(levels))
        cur_pyr = tuple(_t(mesh, inputs[f"vis_cur{lvl}"]) for lvl in range(levels))
        dc = vf.DepthCloud(*(_t(mesh, inputs[f"vis_dc_{k}"]) for k in vf.DepthCloud._fields))
        table = vf.FeatureTable(*(_t(mesh, inputs[f"vis_table_{k}"])
                                  for k in vf.FeatureTable._fields))
        ident = se3.identity_pose(mesh.device)
        uv1, ok, rel, pose_w = sharded_visual.sharded_visual_step(
            mesh, prev_pyr, cur_pyr, dc, table, ident, ident, _cam(mesh), VIS_CFG)
        out.update(vis_uv1=uv1, vis_ok=ok, vis_rel_t=rel.t, vis_pose_w_t=pose_w.t)
    if "mh_x" in inputs:
        out.update(_multihost_cases(mesh, inputs))
    return out


def _multihost_cases(mesh, inputs):
    """``multihost``'s placement of ``mh_x`` and a pose: ``shard_batch``
    along two axes and ``replicate`` must give back the whole arrays, and
    ``block`` this rank's rows."""
    x = inputs["mh_x"]
    pose = multihost.replicate(mesh, se3.Pose(inputs["mh_q"], inputs["mh_t"]))
    return {"mh_along0": multihost.shard_batch(mesh, {"x": x})["x"],
            "mh_along1": multihost.shard_batch(mesh, [x], axis=1)[0],
            "mh_q": pose.q, "mh_t": pose.t, "mh_block": mesh.block(_t(mesh, x)),
            "mh_rank": np.int64(mesh.rank), "mh_size": np.int64(mesh.size),
            "mh_device": np.array(str(mesh.device))}


def fail(mesh, inputs):
    """A rank that raises: the launcher must report it."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 was asked to fail")
    return {}


def slam(mesh, inputs):
    """``DistributedSlamPipeline.run`` over the scans ``scan0`` … ."""
    from lidar_visual_odometry_tpu_torch.parallel.distributed_pipeline import (
        DistributedSlamPipeline,
    )

    scans = [inputs[f"scan{k}"] for k in range(int(inputs["n"]))]
    pipe = DistributedSlamPipeline(SLAM_CFG, n_devices=mesh.size, capacity=SLAM_CAPACITY,
                                   device=mesh.device.type)
    odom, mapped, _ = pipe.run(scans)
    return {"odom": odom, "mapped": mapped}


def camlidar(mesh, inputs):
    """``DistributedCamLidarPipeline.run`` over the scans and images."""
    from lidar_visual_odometry_tpu_torch.parallel.distributed_camlidar import (
        DistributedCamLidarPipeline,
    )

    n = int(inputs["n"])
    pipe = DistributedCamLidarPipeline(CAMLIDAR_CFG, n_devices=mesh.size,
                                       capacity=SLAM_CAPACITY, device=mesh.device.type)
    odom, mapped, vis, _ = pipe.run([inputs[f"scan{k}"] for k in range(n)],
                                    [inputs[f"image{k}"] for k in range(n)])
    return {"odom": odom, "mapped": mapped, "vis": vis}
