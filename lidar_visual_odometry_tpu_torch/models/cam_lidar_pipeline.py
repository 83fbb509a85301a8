"""Combined camera-lidar odometry (≡ CamLidarProcess + laserOdometry), ported
from ``lidar_visual_odometry_tpu/models/cam_lidar_pipeline.py``.

The reference's laserOdometry node embeds the visual stack: the cloud is moved
into the camera frame by the extrinsic (``CamLidarProcess.cpp:250-266``) and
feeds ``Frontend::trackfeature``, while lidar scan-to-scan runs beside it,
unfused. ``CamLidarPipeline.run_chunked`` reproduces that uncoupled topology a
chunk of frames at a time: per chunk one upload of the packed polar scans and
one of the uint8 images; the lidar half runs ``odometry_chunk_polar``, the
camera depth clouds are decoded from the same polar scans on the device
(``cam_clouds_from_polar``), and the visual half runs ``visual_chunk``. The
visual trajectory is mapped back to the lidar frame as
``T_w_lidar = T_lidar_cam ∘ T_w_cam ∘ T_cam_lidar``
(``CamLidarProcess.cpp:284-293``).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP item):
the coupled and mapping modes (``coupled=True``, ``mapping=True``), the
``"uint16"`` ingest (the reference's default, so callers pass
``ingest="polar2"``), checkpoint/resume/``stop_after`` and the per-frame
``run`` with ``match_nearest``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import pointcloud as pc
from ..ops import se3
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import lidar_odometry as lo
from . import scan_registration as sr
from . import visual_frontend as vf
from .pipeline import _check_ingest, _check_no_checkpoint


def camera_cloud_select(raw: np.ndarray, R_cl: np.ndarray, t_cl: np.ndarray, cap: int):
    """Host-side camera-frame depth cloud: extrinsic transform, z > 0.3
    near-clip, an even stride down to ``cap`` (scan order is azimuth-major:
    a plain truncation would keep one wedge), fixed-capacity pad."""
    cam_pts = raw @ R_cl.T + t_cl
    cam_pts = cam_pts[cam_pts[:, 2] > 0.3]
    if cam_pts.shape[0] > cap:
        stride = -(-cam_pts.shape[0] // cap)
        cam_pts = cam_pts[::stride][:cap]
    return pc.pad_points(cam_pts, cap)


def _np_quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from a 3×3 rotation, host numpy (Shepperd's method)."""
    t = np.trace(R)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q = q.astype(np.float32)
    return q / np.linalg.norm(q)


def _map_cam_poses_to_lidar(cam_q, cam_t, T_lidar_cam: se3.Pose, T_cam_lidar: se3.Pose):
    """T_w_lidar = T_lidar_cam ∘ T_w_cam ∘ T_cam_lidar, batched over frames."""
    p = se3.se3_compose(se3.se3_compose(T_lidar_cam, se3.Pose(cam_q, cam_t)), T_cam_lidar)
    return p.q, p.t


def cam_clouds_from_polar(pimgs: torch.Tensor, R_cl: torch.Tensor, t_cl: torch.Tensor,
                          lidar_cfg, cap: int, z_min: float = 0.3):
    """Camera-frame depth clouds decoded on the device from the uploaded polar
    scans (K, R, W, C) int32 cells: points in front of the camera
    (z > z_min), then an even stride down to ``cap``, compacted by one stable
    sort on the strided rank. Returns ((K, cap, 3) float32, (K, cap) bool)."""
    outs, masks = [], []
    for img in pimgs:
        cs = pc.polar_to_compact(img, n_scans=lidar_cfg.n_scans, width=lidar_cfg.azimuth_bins,
                                 min_range=lidar_cfg.min_range, max_range=lidar_cfg.max_range)
        pts = cs.xyz.reshape(-1, 3)
        valid = cs.valid.reshape(-1)
        cam_pts = pts @ R_cl.T + t_cl
        valid = valid & (cam_pts[:, 2] > z_min)
        rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
        cnt = torch.clamp(rank[-1] + 1, min=1)
        stride = (cnt + cap - 1) // cap
        sel = valid & (torch.remainder(rank, stride) == 0)
        n_sel = (cnt + stride - 1) // stride
        key = torch.where(sel, torch.div(rank, stride, rounding_mode="floor"),
                          torch.full_like(rank, pts.shape[0] + 1))
        order = torch.sort(key, stable=True).indices[:cap]
        outs.append(cam_pts[order])
        masks.append(torch.arange(cap, device=pts.device) < n_sel)
    return torch.stack(outs), torch.stack(masks)


@dataclass
class CamLidarResult:
    lidar_positions: np.ndarray     # (N, 3) lidar-odometry trajectory
    visual_positions: np.ndarray    # (N, 3) visual odometry in the lidar frame
    lidar_quats: np.ndarray
    visual_quats: np.ndarray
    mapped_positions: np.ndarray | None = None
    mapped_quats: np.ndarray | None = None


def _to_uint8(im) -> np.ndarray:
    im = np.asarray(im)
    return im if im.dtype == np.uint8 else np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)


class CamLidarPipeline:
    """Lidar odometry and the visual frontend side by side on ``device``
    (default CUDA)."""

    def __init__(self, cfg: SystemConfig = SystemConfig(), capacity: int = 131072,
                 device="cuda"):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        self.cam = cam_ops.Pinhole.from_config(cfg.camera, self.device)
        E = np.asarray(cfg.extrinsic.matrix, np.float32)
        self.R_cl = E[:, :3]
        self.t_cl = E[:, 3]
        q_cl = _np_quat_from_matrix(self.R_cl)
        dev = self.device
        self.T_cam_lidar = se3.Pose(torch.from_numpy(q_cl).to(dev),
                                    torch.from_numpy(self.t_cl.copy()).to(dev))
        # inverse: q⁻¹ = conj(q), t⁻¹ = −Rᵀ t
        q_inv = q_cl * np.array([1.0, -1.0, -1.0, -1.0], np.float32)
        self.T_lidar_cam = se3.Pose(
            torch.from_numpy(q_inv).to(dev),
            torch.from_numpy(-(self.R_cl.T @ self.t_cl).astype(np.float32)).to(dev))
        self.last_wall = 0.0

    def _cam_cloud(self, raw: np.ndarray):
        """The camera-frame depth cloud of a raw (n, 3) scan on the host
        (the JAX package's ``_cam_cloud``; the direct VO bench builds its
        clouds with it)."""
        return camera_cloud_select(raw, self.R_cl, self.t_cl, self.cfg.visual.depth_cloud_cap)

    def run(self, scans, images, scan_stamps=None, image_stamps=None):
        raise NotImplementedError(
            "CamLidarPipeline.run (per frame, paired by match_nearest) is not ported "
            "yet (ROADMAP A.7); use run_chunked")

    def run_chunked(self, scans, images, chunk: int = 8, progress: bool = False,
                    ingest: str = "uint16", coupled: bool = False, mapping: bool = False,
                    map_skip: int = 1, checkpoint_path: str | None = None,
                    checkpoint_every: int = 0, resume: bool = False,
                    stop_after: int | None = None) -> CamLidarResult:
        """Run a whole sequence of raw (n_i, ≥3) scans and 1:1 paired images
        ((H, W) uint8, or float in [0, 1]), ``chunk`` frames per upload. Frame
        0 bootstraps both states from its raw points (and its image as
        given); later images travel as uint8. Returns both trajectories;
        frame 0 is the identity in both. The parameters are the reference's:
        only ``"polar2"`` and ``"polar"`` are ported, the default ``"uint16"``
        and the checkpoint arguments raise ``NotImplementedError`` (ROADMAP
        A.7)."""
        if coupled:
            raise NotImplementedError(
                "coupled=True (the visual pose warm-starting lidar odometry) is not ported "
                "yet (ROADMAP A.8 follow-up: cam-lidar coupled/mapping modes)")
        if mapping:
            raise NotImplementedError(
                "mapping=True (cam-lidar with device mapping) is not ported yet "
                "(ROADMAP A.8 follow-up: cam-lidar coupled/mapping modes)")
        _check_no_checkpoint(checkpoint_path, checkpoint_every, resume, stop_after)
        _check_ingest(ingest, unported=("uint16",))   # the reference's ingests
        n = len(scans)
        if len(images) != n:
            raise ValueError(f"{n} scans but {len(images)} images: run_chunked pairs them 1:1")
        dev = self.device
        lcfg, vcfg = self.cfg.lidar, self.cfg.visual
        cap = vcfg.depth_cloud_cap

        # frame 0 bootstraps both carried states
        raw0 = np.asarray(scans[0])[:, :3]
        xyz0, mask0 = pc.pad_points(raw0, self.capacity)
        odo_state = lo.init_state(sr.register_scan(xyz0, mask0, lcfg, device=dev).features)
        cxyz0, cmask0 = camera_cloud_select(raw0, self.R_cl, self.t_cl, cap)
        vis_state = vf.init_chunk_state(
            torch.as_tensor(np.asarray(images[0], np.float32), device=dev),
            torch.from_numpy(cxyz0).to(dev), torch.from_numpy(cmask0).to(dev),
            self.cam, vcfg)
        R_cl = torch.from_numpy(self.R_cl).to(dev)
        t_cl = torch.from_numpy(self.t_cl.copy()).to(dev)

        t0 = time.perf_counter()
        lq, lt, vq, vt = [], [], [], []
        for s in range(1, n, chunk):
            batch = range(s, min(s + chunk, n))
            packed = pc.pack_polar_chunk(
                [np.asarray(scans[k])[:, :3] for k in batch], n_scans=lcfg.n_scans,
                width=lcfg.azimuth_bins, min_range=lcfg.min_range, max_range=lcfg.max_range,
                channels=1 if ingest == "polar2" else 2)
            pimgs = pc.polar_image_to_tensor(packed, dev)
            dimgs = torch.from_numpy(np.stack([_to_uint8(images[k]) for k in batch])).to(dev)
            dcx, dcm = cam_clouds_from_polar(pimgs, R_cl, t_cl, lcfg, cap)
            odo_state, poses_l = lo.odometry_chunk_polar(odo_state, pimgs, lcfg,
                                                         self.cfg.odometry, device=dev)
            vis_state, poses_c = vf.visual_chunk(vis_state, dimgs, dcx, dcm, self.cam, vcfg)
            lq.append(poses_l.q)
            lt.append(poses_l.t)
            vq.append(poses_c.q)
            vt.append(poses_c.t)

        ident_q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
        zero_t = torch.zeros((1, 3), device=dev)
        mq, mt = _map_cam_poses_to_lidar(torch.cat(vq), torch.cat(vt),
                                         self.T_lidar_cam, self.T_cam_lidar)
        out = [torch.cat([ident_q] + lq), torch.cat([zero_t] + lt),
               torch.cat([ident_q, mq]), torch.cat([zero_t, mt])]
        lidar_q, lidar_t, vis_q, vis_t = (x.cpu().numpy() for x in out)
        wall = time.perf_counter() - t0
        if progress:
            print(f"cam-lidar: {n} frames ({n - 1} computed) in {wall:.2f} s "
                  f"→ {(n - 1) / wall:.1f} frames/s")
        self.last_wall = wall
        return CamLidarResult(lidar_positions=lidar_t, visual_positions=vis_t,
                              lidar_quats=lidar_q, visual_quats=vis_q)
