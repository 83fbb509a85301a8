"""Keyframe data model for direct tracking (≡ Frame/Keyframe/KeyframeWindow),
ported from ``lidar_visual_odometry_tpu/models/keyframe.py``.

A keyframe holds an image pyramid and a fixed-capacity set of gradient-selected
3-D points (camera frame). The reference selects points by bucketing the
projected lidar cloud into runs of 10 candidates and keeping the arg-max
gradient magnitude if it exceeds 6.25/255² (``src/vloam/Keyframe.cpp:32-94``);
here that is a reshape and a row arg-max, then a stable compaction of the
selected points to the front.

``KeyframeWindow`` is the 5-slot FIFO of the window BA
(``KeyframeWindow.cpp:23-32``), stacked along a leading axis for the BA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import image, se3


class Keyframe(NamedTuple):
    pyramid: tuple            # (H/2^l, W/2^l) images, level 0 first
    points: torch.Tensor      # (P, 3) selected points, keyframe camera frame
    point_mask: torch.Tensor  # (P,)
    pose_w: se3.Pose          # Twc


GRAD_GATE = 6.25 / (255.0 * 255.0)  # Keyframe.cpp:60 (images in [0, 1])


def select_points(img: torch.Tensor, cam, pts_cam: torch.Tensor, pts_mask: torch.Tensor, *,
                  cap: int = 2048, bucket: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient-bucket sampling of the projected cloud (Keyframe.cpp:32-94).

    Scans the candidates in buckets of ``bucket`` and keeps each bucket's
    largest |∇I|² (the first on ties) if it is above the gate; the kept
    points move to the front in candidate order and the rest is padded to
    ``cap``. Returns (points (cap, 3), mask (cap,))."""
    gx, gy = image.gradients(img)
    gmag = gx * gx + gy * gy

    uv, in_front = cam_ops.project(cam, pts_cam)
    ok = pts_mask & in_front & cam_ops.is_in_image(cam, uv, boundary=2.0)
    g = torch.where(ok, image.bilinear(gmag, uv), torch.full_like(uv[..., 0], -1.0))

    n_buckets = pts_cam.shape[0] // bucket
    g_b = g[: n_buckets * bucket].reshape(n_buckets, bucket)
    best = torch.argmax(g_b, dim=1)
    best_g = torch.gather(g_b, 1, best[:, None])[:, 0]
    sel_idx = torch.arange(n_buckets, device=g.device) * bucket + best
    sel_ok = best_g > GRAD_GATE

    order = torch.argsort((~sel_ok).to(torch.uint8), stable=True)
    sel_idx = sel_idx[order][:cap]
    sel_ok = sel_ok[order][:cap]
    pts = pts_cam[sel_idx]
    if n_buckets < cap:
        pad = cap - n_buckets
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        sel_ok = torch.cat([sel_ok, sel_ok.new_zeros((pad,))])
    return pts, sel_ok


def make_keyframe(img: torch.Tensor, cam, pts_cam: torch.Tensor, pts_mask: torch.Tensor,
                  pose_w: se3.Pose, *, levels: int = 4, cap: int = 2048) -> Keyframe:
    pyr = tuple(image.build_pyramid(img, levels))
    pts, mask = select_points(img, cam, pts_cam, pts_mask, cap=cap)
    return Keyframe(pyr, pts, mask, pose_w)


def visible_fraction(cam, kf: Keyframe, pose_a: se3.Pose) -> torch.Tensor:
    """Device scalar: the fraction of ``kf``'s points in the image seen from
    ``pose_a`` (Keyframe.cpp:97-131), the keyframe-creation criterion."""
    T_ab = se3.se3_compose(se3.se3_inverse(pose_a), kf.pose_w)
    uv, front = cam_ops.project(cam, se3.se3_apply(T_ab, kf.points))
    vis = kf.point_mask & front & cam_ops.is_in_image(cam, uv)
    return torch.sum(vis) / torch.clamp(torch.sum(kf.point_mask), min=1)


class KeyframeWindow:
    """Host-side FIFO of the last N keyframes (stacked for BA)."""

    def __init__(self, size: int = 5):
        self.size = size
        self.frames: list[Keyframe] = []

    def add(self, kf: Keyframe) -> None:
        self.frames.append(kf)
        if len(self.frames) > self.size:
            self.frames.pop(0)

    def __len__(self) -> int:
        return len(self.frames)

    def stacked(self):
        """(pyramids per level (N, h, w), points (N, P, 3), masks (N, P),
        poses (N,)) of a full window."""
        assert len(self.frames) == self.size
        pyrs = tuple(torch.stack([kf.pyramid[lvl] for kf in self.frames])
                     for lvl in range(len(self.frames[0].pyramid)))
        return (
            pyrs,
            torch.stack([kf.points for kf in self.frames]),
            torch.stack([kf.point_mask for kf in self.frames]),
            se3.Pose(torch.stack([kf.pose_w.q for kf in self.frames]),
                     torch.stack([kf.pose_w.t for kf in self.frames])),
        )

    def visible_ratio(self, kf_a: Keyframe, kf_b: Keyframe, cam) -> float:
        """Fraction of kf_b's points visible from kf_a (Keyframe.cpp:97-131);
        one device read."""
        return float(visible_fraction(cam, kf_b, kf_a.pose_w))


class KeyframeDB:
    """Append-only keyframe archive (≡ KeyframeDB, ``KeyframeDB.cpp:19-55``):
    poses and point clouds of every keyframe, the clouds as host numpy, and
    the debug view as the accumulated (u, v) splats of the last keyframes in
    the latest one's image."""

    def __init__(self):
        self.poses: list[se3.Pose] = []
        self.points: list[np.ndarray] = []
        self.masks: list[np.ndarray] = []

    def add(self, kf: Keyframe) -> None:
        self.poses.append(kf.pose_w)
        self.points.append(kf.points.cpu().numpy())
        self.masks.append(kf.point_mask.cpu().numpy())

    def __len__(self) -> int:
        return len(self.poses)

    def accum_points_in_latest(self, cam, num_keyframe: int = 5, level: int = 0):
        """Project the last ``num_keyframe`` archived clouds into the latest
        keyframe's image plane (KeyframeDB.cpp:27-48). Returns (uv (M, 2) at
        the given pyramid level, valid (M,)) as numpy."""
        assert self.poses, "empty archive"
        T_wl = self.poses[-1]
        scale = 0.5 ** level
        uvs, oks = [], []
        for pose, pts, m in zip(self.poses[-num_keyframe:], self.points[-num_keyframe:],
                                self.masks[-num_keyframe:]):
            T_li = se3.se3_compose(se3.se3_inverse(T_wl), pose)
            pts_l = se3.se3_apply(T_li, torch.from_numpy(pts).to(pose.t.device))
            uv, front = cam_ops.project(cam, pts_l)
            ok = torch.from_numpy(m).to(uv.device) & front & cam_ops.is_in_image(
                cam, uv, boundary=2.0)
            uvs.append(uv.cpu().numpy() * scale)
            oks.append(ok.cpu().numpy())
        return np.concatenate(uvs), np.concatenate(oks)
