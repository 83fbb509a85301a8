"""Direct (photometric) visual odometry (≡ Frontend::track_camlidar), ported
from ``lidar_visual_odometry_tpu/models/direct_vo.py``.

The reference's alternative VO path: a constant-velocity prior, Tracker2
photometric alignment against the latest keyframe, keyframe creation by
visible ratio and a 5-keyframe window with photometric BA
(``src/vloam/Frontend.cpp:64-186``; the BA call the reference left commented
out at ``:175-178`` is live here, as in the JAX package):

* track: ``tracker_direct.track`` (coarse-to-fine, Student-t weights);
* keyframe policy: visible ratio below ``keyframe_visible_ratio`` (above 1,
  the default, every frame is a keyframe, as the reference hard-codes);
* window BA: ``window_ba.refine`` over the window whenever a keyframe joins a
  full window.

``DirectVO.process`` runs one frame from the host. ``DirectVOChunked`` runs
the JAX package's fused chunk (``direct_chunk``) as a loop over the chunk's
frames on the device: one upload of the chunk's uint8 images and
uint16-quantised clouds, the poses kept on the device until one copy at the
end. The keyframe decision needs no device read when the threshold is above 1
(the visible ratio is at most 1), and one read a frame otherwise; the
tracker's and the BA's early exits read the step's max-norm once an
iteration. The JAX package's two visible-ratio functions (the window's and
the chunk's ``_visible_ratio``) are one here, ``keyframe.visible_fraction``.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..ops import image, se3
from ..utils import checkpoint as ckpt
from ..utils.config import VisualConfig
from ..utils.device import resolve_device
from . import keyframe as kfm
from . import tracker_direct, window_ba
from .cam_lidar_pipeline import _to_uint8
from .lidar_odometry import quantize_points, upload
from .lidar_odometry import dequantize as decode_points

# The JAX package's sampler precisions for the BA (its one-hot MXU passes)
SAMPLE_PRECISIONS = ("high", "bf16", "highest")


def _untimed(stage: str):
    """The default stage timer: no context around a stage."""
    return contextlib.nullcontext()


def _run_window_ba(pyrs, pts, masks, poses, cam, cfg: VisualConfig) -> se3.Pose:
    """The BA call of the host loop and the chunk: each keyframe's points
    strided down to about ``ba_points``, the level ``ba_level`` clamped to
    the pyramid, ``ba_iters`` rounds, pairs within ``ba_pair_radius``.

    ``ba_sample_precision`` must name one of the JAX package's samplers, as
    its lookup demands, and is then ignored: it picks the TPU's one-hot MXU
    passes, and the port samples in float32 by gathers."""
    if cfg.ba_sample_precision not in SAMPLE_PRECISIONS:
        raise KeyError(cfg.ba_sample_precision)
    stride = max(1, pts.shape[1] // cfg.ba_points) if cfg.ba_points else 1
    return window_ba.refine(
        pyrs, pts[:, ::stride], masks[:, ::stride], poses, cam,
        n_iters=cfg.ba_iters, level=min(cfg.ba_level, cfg.pyramid_levels - 1),
        tdist_dof=cfg.tdist_dof, step_tol=cfg.ba_step_tol, pair_radius=cfg.ba_pair_radius,
    )


class DirectVO:
    """Per-frame host driver of direct VO on ``device`` (default CUDA)."""

    def __init__(self, cam, cfg: VisualConfig = VisualConfig(), *,
                 keyframe_visible_ratio: float = 1.1, run_window_ba: bool = True,
                 point_cap: int = 2048, device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.kf_ratio = keyframe_visible_ratio
        self.run_window_ba = run_window_ba
        self.point_cap = point_cap
        self.device = resolve_device(device)
        self.window = kfm.KeyframeWindow(cfg.keyframe_window)
        self.pose_w = se3.identity_pose(self.device)    # Twc
        self.vel = se3.identity_pose(self.device)       # constant-velocity prior T_k_km1
        self.ref_kf: kfm.Keyframe | None = None

    def process(self, img: torch.Tensor, pts_cam: torch.Tensor,
                pts_mask: torch.Tensor) -> se3.Pose:
        """One frame: (H, W) float image in [0, 1], (P, 3) camera-frame
        points and their (P,) mask. Returns the frame's world pose."""
        levels = self.cfg.pyramid_levels
        pyr = tuple(image.build_pyramid(img, levels))
        if self.ref_kf is None:
            self.ref_kf = kfm.make_keyframe(img, self.cam, pts_cam, pts_mask, self.pose_w,
                                            levels=levels, cap=self.point_cap)
            self.window.add(self.ref_kf)
            return self.pose_w

        # constant-velocity warm start: T_cur_kf ≈ vel ∘ (T_kf_w ∘ T_w_last)
        T_last_kf = se3.se3_compose(se3.se3_inverse(self.pose_w), self.ref_kf.pose_w)
        init = se3.se3_compose(self.vel, se3.se3_inverse(T_last_kf))
        T_cur_kf = tracker_direct.track(self.ref_kf, pyr, self.cam, init, levels=levels,
                                        tdist_dof=self.cfg.tdist_dof)
        prev_pose = self.pose_w
        self.pose_w = se3.se3_compose(self.ref_kf.pose_w, se3.se3_inverse(T_cur_kf))
        self.vel = se3.se3_compose(se3.se3_inverse(self.pose_w), prev_pose)

        # keyframe decision (visible-ratio criterion, Keyframe.cpp:97-131)
        cur_kf = kfm.make_keyframe(img, self.cam, pts_cam, pts_mask, self.pose_w,
                                   levels=levels, cap=self.point_cap)
        ratio = self.window.visible_ratio(cur_kf, self.ref_kf, self.cam)
        if ratio < self.kf_ratio:
            self.window.add(cur_kf)
            self.ref_kf = cur_kf
            if self.run_window_ba and len(self.window) == self.window.size:
                pyrs, pts, masks, poses = self.window.stacked()
                refined = _run_window_ba(pyrs, pts, masks, poses, self.cam, self.cfg)
                for i, kf in enumerate(self.window.frames):
                    self.window.frames[i] = kf._replace(
                        pose_w=se3.Pose(refined.q[i], refined.t[i]))
                self.ref_kf = self.window.frames[-1]
                self.pose_w = self.ref_kf.pose_w
        return self.pose_w


# ---------------------------------------------------------------------------
# The chunk: the window state stays on the device across a chunk's frames
# ---------------------------------------------------------------------------

class DirectChunkState(NamedTuple):
    pyrs: tuple               # per level: (S, H/2^l, W/2^l) window pyramids
    points: torch.Tensor      # (S, P, 3) selected keyframe points
    point_mask: torch.Tensor  # (S, P)
    poses_q: torch.Tensor     # (S, 4) window world poses (newest = slot S-1)
    poses_t: torch.Tensor     # (S, 3)
    count: int                # filled slots, known on the host
    pose_w: se3.Pose          # current-frame world pose
    vel: se3.Pose             # constant-velocity prior T_k_km1


def _ref_keyframe(state: DirectChunkState) -> kfm.Keyframe:
    S = state.points.shape[0]
    return kfm.Keyframe(tuple(p[S - 1] for p in state.pyrs), state.points[S - 1],
                        state.point_mask[S - 1],
                        se3.Pose(state.poses_q[S - 1], state.poses_t[S - 1]))


def init_direct_state(img0: torch.Tensor, pts0_cam: torch.Tensor, mask0: torch.Tensor, cam,
                      cfg: VisualConfig, *, point_cap: int = 2048) -> DirectChunkState:
    """Bootstrap the window with frame 0 as its first keyframe (slot S-1)."""
    S = cfg.keyframe_window
    dev = img0.device
    ident = se3.identity_pose(dev)
    kf = kfm.make_keyframe(img0, cam, pts0_cam, mask0, ident, levels=cfg.pyramid_levels,
                           cap=point_cap)

    def window(x):
        return torch.cat([x.new_zeros((S - 1, *x.shape)), x[None]])

    return DirectChunkState(
        pyrs=tuple(window(lvl) for lvl in kf.pyramid),
        points=window(kf.points),
        point_mask=window(kf.point_mask),
        poses_q=ident.q.expand(S, 4).clone(),
        poses_t=torch.zeros((S, 3), device=dev),
        count=1,
        pose_w=ident,
        vel=ident,
    )


def _add_keyframe(state: DirectChunkState, pyr, sel_pts, sel_mask, pose_new: se3.Pose,
                  vel: se3.Pose, cam, cfg: VisualConfig, run_ba: bool) -> DirectChunkState:
    """Shift the new keyframe into the window; BA once the window is full."""
    S = state.points.shape[0]

    def shift(win, x):
        return torch.cat([win[1:], x[None]])

    pyrs = tuple(shift(p, lvl) for p, lvl in zip(state.pyrs, pyr))
    points = shift(state.points, sel_pts)
    pmask = shift(state.point_mask, sel_mask)
    q = shift(state.poses_q, pose_new.q)
    t = shift(state.poses_t, pose_new.t)
    count = min(state.count + 1, S)
    if run_ba and count >= S:
        q, t = _run_window_ba(pyrs, points, pmask, se3.Pose(q, t), cam, cfg)
    return DirectChunkState(pyrs, points, pmask, q, t, count,
                            se3.Pose(q[S - 1], t[S - 1]), vel)


def _direct_step(state: DirectChunkState, img: torch.Tensor, pts_cam: torch.Tensor,
                 pmask: torch.Tensor, cam, cfg: VisualConfig, kf_ratio: float, run_ba: bool,
                 point_cap: int, timer=_untimed) -> tuple[DirectChunkState, se3.Pose]:
    """One frame of the chunk: track against the newest keyframe, then the
    keyframe decision and (on a full window) the BA. ``timer(stage)`` gives
    the context each stage runs in."""
    with timer("decode + pyramid"):
        pyr = tuple(image.build_pyramid(img, cfg.pyramid_levels))
    ref = _ref_keyframe(state)

    with timer("track"):
        T_last_kf = se3.se3_compose(se3.se3_inverse(state.pose_w), ref.pose_w)
        init = se3.se3_compose(state.vel, se3.se3_inverse(T_last_kf))
        T_cur_kf = tracker_direct.track(ref, pyr, cam, init, levels=cfg.pyramid_levels,
                                        tdist_dof=cfg.tdist_dof)
        pose_new = se3.se3_compose(ref.pose_w, se3.se3_inverse(T_cur_kf))
        vel = se3.se3_compose(se3.se3_inverse(pose_new), state.pose_w)

    # the comparison is in float32, as on the device; ratio ≤ 1, so a
    # threshold above 1 adds every frame without a read
    threshold = float(np.float32(kf_ratio))
    with timer("keyframe decision"):
        add = threshold > 1.0 or float(kfm.visible_fraction(cam, ref, pose_new)) < threshold
    if not add:
        new_state = state._replace(pose_w=pose_new, vel=vel)
    else:
        with timer("select points"):
            sel_pts, sel_mask = kfm.select_points(img, cam, pts_cam, pmask, cap=point_cap)
        with timer("window shift + BA"):
            new_state = _add_keyframe(state, pyr, sel_pts, sel_mask, pose_new, vel, cam, cfg,
                                      run_ba)
    return new_state, new_state.pose_w


def direct_chunk(state: DirectChunkState, imgs: torch.Tensor, pts: torch.Tensor,
                 masks: torch.Tensor, cam, cfg: VisualConfig, kf_ratio: float = 1.1,
                 run_ba: bool = True, point_cap: int = 2048, timer=_untimed):
    """K frames of the direct stack: imgs (K, H, W) uint8, pts (K, P, 3)
    uint16 codes (``decode_points``), masks (K, P). Returns (state, world
    poses stacked (K, 4) / (K, 3)). ``timer`` as in ``_direct_step``."""
    qs, ts = [], []
    for k in range(imgs.shape[0]):
        with timer("decode + pyramid"):
            img = imgs[k].to(torch.float32) * (1.0 / 255.0)
            pts_k = decode_points(pts[k])
        state, pose = _direct_step(state, img, pts_k, masks[k], cam, cfg, kf_ratio, run_ba,
                                   point_cap, timer)
        qs.append(pose.q)
        ts.append(pose.t)
    return state, se3.Pose(torch.stack(qs), torch.stack(ts))


def direct_chunk_state_from_numpy(arrays: Mapping[str, np.ndarray], levels: int,
                                  device="cuda") -> DirectChunkState:
    """The carried state from the keys the JAX package's checkpoint writes
    for a ``DirectChunkState`` (``utils/checkpoint.py``, ``dchunk_0`` … in
    leaf order): the ``levels`` window pyramids, points, point mask, poses
    (q, t), count, pose_w (q, t) and vel (q, t)."""
    dev = resolve_device(device)
    leaves = iter(range(levels + 9))

    def nxt(dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[f"dchunk_{next(leaves)}"]), dtype=dtype,
                            device=dev)

    pyrs = tuple(nxt() for _ in range(levels))
    points, point_mask, poses_q, poses_t = nxt(), nxt(torch.bool), nxt(), nxt()
    count = int(np.asarray(arrays[f"dchunk_{next(leaves)}"]))
    pose_w = se3.Pose(nxt(), nxt())
    vel = se3.Pose(nxt(), nxt())
    return DirectChunkState(pyrs, points, point_mask, poses_q, poses_t, count, pose_w, vel)


class DirectVOChunked:
    """Host driver of the chunked direct-VO path on ``device`` (default
    CUDA): a chunk's frames go up in one upload each of images, clouds and
    masks, and the poses come back in one copy at the end. ``stage_timer``
    (a function of a stage's name giving the context the stage runs in; no
    context by default) lets a profiler time the stages of ``run_chunked``."""

    def __init__(self, cam, cfg: VisualConfig = VisualConfig(), *,
                 keyframe_visible_ratio: float = 1.1, run_window_ba: bool = True,
                 point_cap: int = 2048, device="cuda"):
        self.cam = cam
        self.cfg = cfg
        self.kf_ratio = keyframe_visible_ratio
        self.run_ba = run_window_ba
        self.point_cap = point_cap
        self.device = resolve_device(device)
        self.stage_timer = _untimed

    def run_chunked(self, images, clouds, cloud_masks, chunk: int = 8, progress: bool = False,
                    checkpoint_path: str | None = None, checkpoint_every: int = 0,
                    resume: bool = False, stop_after: int | None = None):
        """images: (H, W) float in [0, 1] (or 0-255) or uint8; clouds: (P, 3)
        float32 camera-frame points; cloud_masks: (P,) bool. Frame 0
        bootstraps the window from its float image (÷255 when its largest
        value is above 1.5) and its unquantised cloud; the later frames
        travel as uint8 images and uint16 codes. Returns (positions (N, 3),
        quaternions (N, 4), wall seconds), frame 0 at the identity. The
        parameters are the reference's; a checkpoint carries the window state
        and the trajectory of frames 1 on."""
        dev = self.device
        n = len(images)
        if resume:
            data = np.load(checkpoint_path)
            start = int(data["frame_idx"])
            first = {"q": data["traj_q"], "t": data["traj_t"]}
            _, state = ckpt.load_chunk_states(checkpoint_path, dev)
        else:
            im0 = np.asarray(images[0], np.float32)
            if im0.max() > 1.5:
                im0 = im0 / 255.0
            state = init_direct_state(
                torch.from_numpy(im0).to(dev),
                torch.from_numpy(np.asarray(clouds[0], np.float32)).to(dev),
                torch.from_numpy(np.asarray(cloud_masks[0], bool)).to(dev),
                self.cam, self.cfg, point_cap=self.point_cap)
            start = 1
            first = {"q": np.zeros((0, 4), np.float32), "t": np.zeros((0, 3), np.float32)}
        rec = ckpt.RunRecord(checkpoint_path, checkpoint_every, stop_after, start, first)

        t0 = time.perf_counter()
        for s in range(start, n, chunk):
            batch = range(s, min(s + chunk, n))
            with self.stage_timer("upload (images, codes, masks)"):
                imgs = np.stack([_to_uint8(images[k]) for k in batch])
                qpts = np.stack([quantize_points(np.asarray(clouds[k])) for k in batch])
                ms = np.stack([np.asarray(cloud_masks[k], bool) for k in batch])
                up = (upload(imgs, dev), upload(qpts, dev), upload(ms, dev))
            state, poses = direct_chunk(
                state, *up, self.cam, self.cfg, kf_ratio=self.kf_ratio, run_ba=self.run_ba,
                point_cap=self.point_cap, timer=self.stage_timer)
            rec.append(q=poses.q, t=poses.t)
            next_s = min(s + chunk, n)
            if rec.snapshot_due(next_s):
                done = next_s - 1   # rows of frames 1 on
                ckpt.save_checkpoint(checkpoint_path, frame_idx=next_s,
                                     trajectory_q=rec.host("q")[:done],
                                     trajectory_t=rec.host("t")[:done], direct_chunk=state)
            if rec.stops(next_s):
                n = next_s
                break

        ident = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
        out_q = np.concatenate([ident, rec.host("q")[:n - 1]])
        out_t = np.concatenate([np.zeros((1, 3), np.float32), rec.host("t")[:n - 1]])
        wall = time.perf_counter() - t0
        if progress:
            done = max(n - start, 1)
            print(f"direct-VO: {n} frames ({done} computed) in {wall:.2f} s "
                  f"→ {done / wall:.1f} frames/s")
        return out_t, out_q, wall
