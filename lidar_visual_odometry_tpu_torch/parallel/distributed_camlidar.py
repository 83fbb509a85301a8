"""The distributed cam-lidar driver, ported from
``lidar_visual_odometry_tpu/parallel/distributed_camlidar.py``.

The reference's runtime embeds the visual stack in the laserOdometry process
(``laserOdometry.cpp:248,308``) with laserMapping refining behind it on its
own thread (``laserMapping.cpp:934``). Per matched (scan, image) pair, on
every rank:

* the visual frontend runs parallel over features: KLT and the depth gates
  on each rank's block of the table, one all-reduce a GN iteration
  (``sharded_visual``), then the replicated table update and replenishment
  (``visual_frontend.update_after_external_solve``, ``_replenish``);
* the visual relative pose, mapped into the lidar frame and gated
  (``cam_lidar_pipeline.visual_prior_gate``), warm-starts the all-reduced
  scan-to-scan GN when ``coupled`` (``CamLidarProcess.cpp:278-307``);
* the scan-to-map refinement shards the gathered submap
  (``sharded_mapping``) at the mapping cadence, with the host ``CubeMap``
  bookkeeping of ``DistributedSlamPipeline``.

Frame 0 bootstraps as ``CamLidarPipeline.run_chunked`` does: its features
from the padded float cloud, its depth cloud cut on the host
(``camera_cloud_select``), a replenish-only table. Tracked frames pack their
scans into the polar image on the host with the native packer
(``data/native_pack.py``, the JAX package's packer), take their features
from the polar image and
their depth clouds from it on the device (``cam_clouds_from_polar``), and
upload their images as uint8, as the single-device chunk does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import native_pack
from ..models import visual_frontend as vf
from ..models.cam_lidar_pipeline import (
    MAX_PRIOR_STEP, _map_cam_poses_to_lidar, _np_quat_from_matrix, _to_uint8,
    cam_clouds_from_polar, camera_cloud_select, visual_prior_gate,
)
from ..models.pipeline import _register_raw
from ..models.scan_registration import register_polar_impl
from ..ops import camera as cam_ops
from ..ops import image as image_ops
from ..ops import pointcloud as pc
from ..ops import se3
from ..utils.config import SystemConfig
from . import sharded_odometry as so
from . import sharded_visual as sv
from .distributed_pipeline import DistributedSlamPipeline


class DistributedCamLidarPipeline(DistributedSlamPipeline):
    """Camera + lidar + mapping, all three sharded stages on every rank."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), n_devices: int | None = None,
                 capacity: int = 131072, coupled: bool = True,
                 max_prior_step: float = MAX_PRIOR_STEP, device="cuda"):
        super().__init__(cfg, n_devices=n_devices, capacity=capacity, device=device)
        dev = self.device
        self.coupled = coupled
        self.max_prior_step = max_prior_step
        self.cam = cam_ops.Pinhole.from_config(cfg.camera, dev)
        E = np.asarray(cfg.extrinsic.matrix, np.float32)
        self.R_cl = E[:, :3]
        self.t_cl = E[:, 3]
        q_cl = _np_quat_from_matrix(self.R_cl)
        self.T_cam_lidar = se3.Pose(torch.from_numpy(q_cl).to(dev),
                                    torch.from_numpy(self.t_cl.copy()).to(dev))
        q_inv = q_cl * np.array([1.0, -1.0, -1.0, -1.0], np.float32)
        self.T_lidar_cam = se3.Pose(
            torch.from_numpy(q_inv).to(dev),
            torch.from_numpy(-(self.R_cl.T @ self.t_cl).astype(np.float32)).to(dev))
        self._R_cl = torch.from_numpy(self.R_cl).to(dev)
        self._t_cl = torch.from_numpy(self.t_cl.copy()).to(dev)
        # the visual carry (≡ VisualChunkState), host attributes
        self.table = None
        self.pose_cam = se3.identity_pose(dev)
        self.warm_rel = se3.identity_pose(dev)
        self._prev_pyr = None
        self._prev_dc = None

    def _pack_scan(self, points: np.ndarray) -> torch.Tensor:
        """One raw scan as a (1, R, W, 2) polar image of int32 cells on the
        rank's device (the ``"polar"`` ingest)."""
        lcfg = self.cfg.lidar
        img = native_pack.pack_polar_chunk(
            [np.asarray(points)[:, :3]], n_scans=lcfg.n_scans, width=lcfg.azimuth_bins,
            min_range=lcfg.min_range, max_range=lcfg.max_range, n_frames=1, channels=2)
        return pc.polar_image_to_tensor(img, self.device)

    def _prep_image(self, image, first: bool) -> torch.Tensor:
        """Frame 0's image stays float (``init_chunk_state``'s input); a
        tracked frame's travels as uint8, as in the single-device chunk."""
        if first:
            img = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)
        else:
            img = torch.from_numpy(_to_uint8(image)).to(self.device)
            img = img.to(torch.float32) * (1.0 / 255.0)
        cfg = self.cfg.visual
        if cfg.use_clahe:
            img = image_ops.clahe(img, grid=cfg.clahe_grid, clip_limit=cfg.clahe_clip)
        return img

    def process_pair(self, points: np.ndarray, image, map_skip: int = 1
                     ) -> tuple[se3.Pose, se3.Pose]:
        """One matched (scan, image) pair; returns (the map-refined lidar
        world pose, the camera's world pose)."""
        cfg = self.cfg.visual
        dev = self.device
        first = self._prev is None
        raw = np.asarray(points)[:, :3]
        if first:
            feats = _register_raw(raw, self.capacity, self.cfg.lidar, dev).features
            pimg = None
        else:
            pimg = self._pack_scan(raw)
            feats = register_polar_impl(pimg[0], self.cfg.lidar).features
        pyr = tuple(image_ops.build_pyramid(self._prep_image(image, first), cfg.lk_levels))

        if self._prev_pyr is None:
            cxyz, cmask = camera_cloud_select(raw, self.R_cl, self.t_cl, cfg.depth_cloud_cap)
            dc = vf.build_depth_cloud(torch.from_numpy(cxyz).to(dev),
                                      torch.from_numpy(cmask).to(dev))
            self.table = vf._replenish(vf.empty_table(cfg.max_tracked, dev), pyr[0], self.cam,
                                       se3.identity_pose(dev), cfg)
        else:
            dcx, dcm = cam_clouds_from_polar(pimg, self._R_cl, self._t_cl, self.cfg.lidar,
                                             cfg.depth_cloud_cap)
            dc = vf.build_depth_cloud(dcx[0], dcm[0])

        rel_cam = n_tracked = None
        if self._prev_pyr is not None:
            uv1, ok, rel_cam, new_pose_cam = sv.sharded_visual_step(
                self.mesh, self._prev_pyr, pyr, self._prev_dc, self.table, self.pose_cam,
                self.warm_rel, self.cam, cfg)
            table, _ = vf.update_after_external_solve(uv1, ok, self._prev_dc, self.table,
                                                      self.pose_cam, rel_cam, self.cam)
            # the surviving tracks before replenishment: the coupled gate's
            # tracking-health term (≡ chunk_frame_step's n_tracked)
            n_tracked = table.active.sum()
            self.table = vf._replenish(table, pyr[0], self.cam, new_pose_cam, cfg)
            self.pose_cam = new_pose_cam
            self.warm_rel = rel_cam
        self._prev_pyr = pyr
        self._prev_dc = dc

        if self._prev is not None:
            if self.coupled and rel_cam is not None:
                init = visual_prior_gate(
                    self.pose_rel, rel_cam, self.T_lidar_cam, self.T_cam_lidar,
                    self.max_prior_step, n_tracked=n_tracked,
                    min_tracked=int(cfg.coupled_min_track_ratio * cfg.max_tracked))
            else:
                init = self.pose_rel
            rel = so.sharded_scan_to_scan(self.mesh, feats, *self._prev, init,
                                          self.cfg.odometry)
            self.pose_w = se3.se3_compose(self.pose_w, rel)
            self.pose_rel = rel
        self._prev = (feats.less_sharp, feats.less_flat)
        return self._mapping_update(feats, map_skip), self.pose_cam

    def run(self, scans, images, map_skip: int = 1, progress: bool = False):
        """Returns (odometry positions (N, 3), mapped positions (N, 3), the
        visual positions in the lidar frame (N, 3), wall seconds)."""
        t0 = time.perf_counter()
        odom_t, mapped, vis = [], [], []
        for pts, img in zip(scans, images):
            refined, pose_cam = self.process_pair(np.asarray(pts), img, map_skip=map_skip)
            odom_t.append(self.pose_w.t)
            mapped.append(refined.t)
            vis.append(pose_cam)
        odom = torch.stack(odom_t).cpu().numpy()
        mapped_t = torch.stack(mapped).cpu().numpy()
        wall = time.perf_counter() - t0
        _, vt = _map_cam_poses_to_lidar(torch.stack([p.q for p in vis]),
                                        torch.stack([p.t for p in vis]),
                                        self.T_lidar_cam, self.T_cam_lidar)
        if progress:
            n = len(mapped)
            print(f"distributed cam-lidar ({self.mesh.size} ranks): {n} frames in {wall:.2f} s "
                  f"→ {(n - 1) / wall:.1f} frames/s")
        return odom, mapped_t, vt.cpu().numpy(), wall
