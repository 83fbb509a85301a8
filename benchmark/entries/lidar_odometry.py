"""Entry ``lidar_odometry``: the program's ``OdometryPipeline.run_chunked``
on one sequence of host scans, and its check against the plain reference.

An entry module gives ``build(config, device)`` (a fresh program object for
one sequence), ``run(program, scans, config)`` (the timed call; numpy
outputs), ``check(scans, outputs, config, arith)`` (the numbers compared) and
``control(scans, config, arith)`` (the reference in the program's place)."""

from __future__ import annotations

import numpy as np

from ..reference import aloam


def settings(config: dict) -> tuple[dict, dict, dict]:
    s = config["settings"]
    return s["lidar"], s["odometry"], s.get("mapping", {})


def system_config(config: dict):
    from lidar_visual_odometry_tpu_torch.utils.config import (LidarConfig, MappingConfig,
                                                              OdometryConfig, SystemConfig)

    L, O, M = settings(config)
    M = {k: tuple(v) if isinstance(v, list) else v for k, v in M.items()}
    return SystemConfig(lidar=LidarConfig(**L), odometry=OdometryConfig(**O),
                        mapping=MappingConfig(**M))


def build(config: dict, device):
    from lidar_visual_odometry_tpu_torch.models.pipeline import OdometryPipeline

    return OdometryPipeline(system_config(config), capacity=config["run"]["capacity"],
                            device=device)


def run(program, scans: list, config: dict) -> dict:
    r = config["run"]
    res = program.run_chunked(scans, chunk=r["chunk"], ingest=r["ingest"])
    return {"odom_q": np.asarray(res.quaternions), "odom_t": np.asarray(res.positions)}


def _frames_ok(scans, out, keys) -> bool:
    return all(len(out[k]) == len(scans) and np.isfinite(out[k]).all() for k in keys)


def check(scans: list, out: dict, config: dict, ar, frames) -> dict:
    """The gaps of the odometry motion of each of ``frames`` from the
    reference's (m and rad); ``frames_ok`` False when a frame is missing or
    not finite."""
    L, O, _ = settings(config)
    if not _frames_ok(scans, out, ("odom_q", "odom_t")):
        return {"frames_ok": False}
    feats = aloam.sequence_features(scans, L, ar, aloam.odometry_frames_needed(frames))
    gaps = aloam.check_odometry(ar, feats, out["odom_q"], out["odom_t"], O, frames)
    return {"frames_ok": True, "odom_dt_m": [g[0] for g in gaps.values()],
            "odom_dr_rad": [g[1] for g in gaps.values()]}


def control(scans: list, config: dict, ar) -> dict:
    L, O, _ = settings(config)
    q, t = aloam.odometry_chain(ar, aloam.sequence_features(scans, L, ar), O)
    return {"odom_q": q.double().cpu().numpy(), "odom_t": t.double().cpu().numpy()}
