"""Combined camera-lidar odometry (≡ CamLidarProcess + laserOdometry), ported
from ``lidar_visual_odometry_tpu/models/cam_lidar_pipeline.py``.

The reference's laserOdometry node embeds the visual stack: the cloud is moved
into the camera frame by the extrinsic (``CamLidarProcess.cpp:250-266``) and
feeds ``Frontend::trackfeature``, while lidar scan-to-scan runs beside it,
unfused. ``CamLidarPipeline.run_chunked`` reproduces that uncoupled topology a
chunk of frames at a time, in one of two ingests. ``"uint16"`` (the
reference's default): the scans quantised at 3.9 mm with a count a frame, the
camera depth clouds cut on the host and quantised alike, the images as uint8;
the lidar half runs ``odometry_chunk_quantized``. ``"polar2"`` / ``"polar"``:
one upload of the packed polar scans and one of the uint8 images; the lidar
half runs ``odometry_chunk_polar`` and the camera depth clouds are decoded
from the same polar scans on the device (``cam_clouds_from_polar``). The
visual half runs ``visual_chunk``. ``run`` is the per-frame driver: each scan
through ``LidarOdometry``, and each scan that ``match_nearest`` pairs with an
image through ``VisualOdometry``. The visual trajectory is mapped back to the
lidar frame as ``T_w_lidar = T_lidar_cam ∘ T_w_cam ∘ T_cam_lidar``
(``CamLidarProcess.cpp:284-293``).

Not ported yet: the coupled and mapping modes (``coupled=True``,
``mapping=True``), which raise ``NotImplementedError`` naming ROADMAP A.8.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data.sync import match_nearest
from ..ops import camera as cam_ops
from ..ops import pointcloud as pc
from ..ops import se3
from ..utils import checkpoint as ckpt
from ..utils.config import SystemConfig
from ..utils.device import resolve_device
from . import lidar_odometry as lo
from . import visual_frontend as vf
from .pipeline import _check_ingest, _pack_polar, _quantize, _register_raw


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
        # the per-frame drivers of ``run``; their state carries across calls
        self.odom = lo.LidarOdometry(cfg.odometry)
        self.vo = vf.VisualOdometry(self.cam, cfg.visual, dev)

    def _cam_cloud(self, raw: np.ndarray):
        """The camera-frame depth cloud of a raw (n, 3) scan on the host
        (the JAX package's ``_cam_cloud``; the direct VO bench builds its
        clouds with it)."""
        return camera_cloud_select(raw, self.R_cl, self.t_cl, self.cfg.visual.depth_cloud_cap)

    def run(self, scans, images, scan_stamps=None, image_stamps=None) -> CamLidarResult:
        """Per frame: every scan through lidar odometry; the image that
        ``match_nearest`` pairs with it (stamps default to 10 Hz) through the
        visual frontend, with the scan's camera-frame cloud. A scan with no
        image keeps the last visual pose. Images (H, W) float32 in [0, 1]."""
        dev = self.device
        n = len(scans)
        if scan_stamps is None:
            scan_stamps = np.arange(n, dtype=np.float64) * 0.1
        if image_stamps is None:
            image_stamps = np.arange(len(images), dtype=np.float64) * 0.1
        pairing = match_nearest(scan_stamps, image_stamps)

        lidar_poses, visual_poses = [], []
        pose_c = se3.identity_pose(dev)
        for k in range(n):
            raw = np.asarray(scans[k])[:, :3]
            pose_l, _ = self.odom.process(_register_raw(raw, self.capacity, self.cfg.lidar,
                                                     dev).features)
            lidar_poses.append(pose_l)
            # CamLidarProcess drops the clouds no image matches
            if pairing[k] >= 0:
                cxyz, cmask = self._cam_cloud(raw)
                pose_c = self.vo.process(
                    torch.from_numpy(np.asarray(images[pairing[k]], np.float32)).to(dev),
                    torch.from_numpy(cxyz).to(dev), torch.from_numpy(cmask).to(dev))
            visual_poses.append(pose_c)

        vq, vt = _map_cam_poses_to_lidar(torch.stack([p.q for p in visual_poses]),
                                         torch.stack([p.t for p in visual_poses]),
                                         self.T_lidar_cam, self.T_cam_lidar)
        return CamLidarResult(
            lidar_positions=torch.stack([p.t for p in lidar_poses]).cpu().numpy(),
            visual_positions=vt.cpu().numpy(),
            lidar_quats=torch.stack([p.q for p in lidar_poses]).cpu().numpy(),
            visual_quats=vq.cpu().numpy())

    def run_chunked(self, scans, images, chunk: int = 8, progress: bool = False,
                    ingest: str = "uint16", coupled: bool = False, mapping: bool = False,
                    map_skip: int = 1, checkpoint_path: str | None = None,
                    checkpoint_every: int = 0, resume: bool = False,
                    stop_after: int | None = None) -> CamLidarResult:
        """Run a whole sequence of raw (n_i, ≥3) scans and 1:1 paired images
        ((H, W) uint8, or float in [0, 1]), ``chunk`` frames per upload. Frame
        0 bootstraps both states from its raw points (and its image as
        given); later images travel as uint8. Returns both trajectories;
        frame 0 is the identity in both. The parameters are the reference's;
        ``coupled`` and ``mapping`` raise ``NotImplementedError`` (ROADMAP
        A.8). A checkpoint carries the odometry and the visual chunk states,
        the lidar trajectory of frames 1 on (``traj_q`` / ``traj_t``) and the
        visual one (``traj_v_q`` / ``traj_v_t``), as the reference writes
        them."""
        if coupled:
            raise NotImplementedError(
                "coupled=True (the visual pose warm-starting lidar odometry) is not ported "
                "yet (ROADMAP A.8 follow-up: cam-lidar coupled/mapping modes)")
        if mapping:
            raise NotImplementedError(
                "mapping=True (cam-lidar with device mapping) is not ported yet "
                "(ROADMAP A.8 follow-up: cam-lidar coupled/mapping modes)")
        _check_ingest(ingest, allowed=("uint16", "polar", "polar2"))
        n = len(scans)
        if len(images) != n:
            raise ValueError(f"{n} scans but {len(images)} images: run_chunked pairs them 1:1")
        dev = self.device
        lcfg, vcfg = self.cfg.lidar, self.cfg.visual
        cap = vcfg.depth_cloud_cap

        if resume:
            start, odo_state, traj_q, traj_t = ckpt.load_checkpoint(checkpoint_path, device=dev)
            vis_state, _ = ckpt.load_chunk_states(checkpoint_path, dev)
            data = np.load(checkpoint_path)
            if odo_state is None or vis_state is None or "traj_v_q" not in data:
                raise ValueError(f"{checkpoint_path} is not a cam-lidar pipeline checkpoint "
                                 "(no odometry or visual chunk state)")
            first = {"q": traj_q, "t": traj_t, "v_q": data["traj_v_q"],
                     "v_t": data["traj_v_t"]}
        else:
            # frame 0 bootstraps both carried states
            raw0 = np.asarray(scans[0])[:, :3]
            odo_state = lo.init_state(_register_raw(raw0, self.capacity, lcfg, dev).features)
            cxyz0, cmask0 = self._cam_cloud(raw0)
            vis_state = vf.init_chunk_state(
                torch.as_tensor(np.asarray(images[0], np.float32), device=dev),
                torch.from_numpy(cxyz0).to(dev), torch.from_numpy(cmask0).to(dev),
                self.cam, vcfg)
            start = 1
            first = {k: np.zeros((0, 4 if k.endswith("q") else 3), np.float32)
                     for k in ("q", "t", "v_q", "v_t")}
        rec = ckpt.RunRecord(checkpoint_path, checkpoint_every, stop_after, start, first)
        R_cl = torch.from_numpy(self.R_cl).to(dev)
        t_cl = torch.from_numpy(self.t_cl.copy()).to(dev)

        t0 = time.perf_counter()
        for s in range(start, n, chunk):
            batch = range(s, min(s + chunk, n))
            raws = [np.asarray(scans[k])[:, :3] for k in batch]
            dimgs = lo.upload(np.stack([_to_uint8(images[k]) for k in batch]), dev)
            if ingest.startswith("polar"):
                pimgs = _pack_polar(raws, lcfg, ingest, dev)
                dcx, dcm = cam_clouds_from_polar(pimgs, R_cl, t_cl, lcfg, cap)
                odo_state, poses_l = lo.odometry_chunk_polar(odo_state, pimgs, lcfg,
                                                             self.cfg.odometry, device=dev)
            else:
                clouds = [self._cam_cloud(raw) for raw in raws]
                dcx = lo.upload(np.stack([lo.quantize_points(c) for c, _ in clouds]), dev)
                dcm = lo.upload(np.stack([m for _, m in clouds]), dev)
                odo_state, poses_l = lo.odometry_chunk_quantized(
                    odo_state, *_quantize(raws, self.capacity, dev), lcfg, self.cfg.odometry)
            vis_state, poses_c = vf.visual_chunk(vis_state, dimgs, dcx, dcm, self.cam, vcfg)
            rec.append(q=poses_l.q, t=poses_l.t, v_q=poses_c.q, v_t=poses_c.t)
            next_s = min(s + chunk, n)
            if rec.snapshot_due(next_s):
                done = next_s - 1   # rows of frames 1 on
                ckpt.save_checkpoint(
                    checkpoint_path, frame_idx=next_s, odom_state=odo_state,
                    trajectory_q=rec.host("q")[:done], trajectory_t=rec.host("t")[:done],
                    visual_chunk=vis_state,
                    extra={"traj_v_q": rec.host("v_q")[:done], "traj_v_t": rec.host("v_t")[:done]})
            if rec.stops(next_s):
                n = next_s
                break

        lidar_q, lidar_t, cam_q, cam_t = (rec.host(k)[:n - 1] for k in ("q", "t", "v_q", "v_t"))
        mq, mt = _map_cam_poses_to_lidar(torch.from_numpy(cam_q).to(dev),
                                         torch.from_numpy(cam_t).to(dev),
                                         self.T_lidar_cam, self.T_cam_lidar)
        vis_q, vis_t = mq.cpu().numpy(), mt.cpu().numpy()
        wall = time.perf_counter() - t0
        done = max(n - start, 1)
        if progress:
            print(f"cam-lidar: {n} frames ({done} computed) in {wall:.2f} s "
                  f"→ {done / wall:.1f} frames/s")
        self.last_wall = wall
        ident_q = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
        zero_t = np.zeros((1, 3), np.float32)
        return CamLidarResult(
            lidar_positions=np.concatenate([zero_t, lidar_t]),
            visual_positions=np.concatenate([zero_t, vis_t]),
            lidar_quats=np.concatenate([ident_q, lidar_q]),
            visual_quats=np.concatenate([ident_q, vis_q]))
