"""Entry ``lidar_slam``: the program's ``FullPipeline.run_chunked`` (the
lidar chain with scan-to-map refinement on the device map) on one sequence
of host scans, and its check against the plain reference: the odometry of
every frame and the mapped pose of every frame."""

from __future__ import annotations

import numpy as np

from ..reference import aloam
from .lidar_odometry import _frames_ok, settings, system_config


def build(config: dict, device):
    from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline

    return FullPipeline(system_config(config), capacity=config["run"]["capacity"],
                        device=device)


def run(program, scans: list, config: dict) -> dict:
    r = config["run"]
    odo, mp = program.run_chunked(scans, chunk=r["chunk"], map_skip=r["map_skip"],
                                  ingest=r["ingest"])
    return {"odom_q": np.asarray(odo.quaternions), "odom_t": np.asarray(odo.positions),
            "map_q": np.asarray(mp.quaternions), "map_t": np.asarray(mp.positions)}


def check(scans: list, out: dict, config: dict, ar, frames) -> dict:
    """The gaps of the odometry motion and the mapped pose of each of
    ``frames`` from the reference's (m and rad)."""
    L, O, M = settings(config)
    if not _frames_ok(scans, out, ("odom_q", "odom_t", "map_q", "map_t")):
        return {"frames_ok": False}
    feats = aloam.sequence_features(
        scans, L, ar, sorted(set(range(max(frames) + 1)) | set(aloam.odometry_frames_needed(frames))))
    og = aloam.check_odometry(ar, feats, out["odom_q"], out["odom_t"], O, frames).values()
    mg = aloam.check_mapping(ar, feats, out["odom_q"], out["odom_t"], out["map_q"],
                             out["map_t"], M, frames).values()
    return {"frames_ok": True,
            "odom_dt_m": [g[0] for g in og], "odom_dr_rad": [g[1] for g in og],
            "map_dt_m": [g[0] for g in mg], "map_dr_rad": [g[1] for g in mg]}


def control(scans: list, config: dict, ar) -> dict:
    L, O, M = settings(config)
    (oq, ot), (mq, mt) = aloam.slam_chain(ar, aloam.sequence_features(scans, L, ar), O, M)
    return {k: v.double().cpu().numpy()
            for k, v in (("odom_q", oq), ("odom_t", ot), ("map_q", mq), ("map_t", mt))}
