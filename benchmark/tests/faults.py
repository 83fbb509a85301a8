"""Faults planted under the timed path, for the tests that show the check
fails them. A worker applies one by name (``apply``) before its set-up:

* ``unchanged``: the scan-to-scan solve returns its starting pose (a step
  that leaves its state unchanged);
* ``half``: every second frame of each uploaded chunk is left out, the
  frame before it packed in its place (half of the batch left out);
* ``altered``: one frame's odometry motion is moved by 2 cm where the
  odometry step produces it (an answer altered).

The cells run on one card, so no exchange between cards can be left out."""

from __future__ import annotations

ALTERED_FRAME = 3


def apply(name: str) -> None:
    from lidar_visual_odometry_tpu_torch.models import device_mapping as dm
    from lidar_visual_odometry_tpu_torch.models import lidar_odometry as lo
    from lidar_visual_odometry_tpu_torch.models import pipeline
    from lidar_visual_odometry_tpu_torch.ops import se3

    if name == "unchanged":
        def scan_to_scan(curr, prev_ls, prev_lf, init_rel, cfg, reduce_fn=None):
            return init_rel

        lo.scan_to_scan_impl = scan_to_scan
    elif name == "half":
        pack = pipeline._pack_polar

        def half(batch, lcfg, ingest, dev):
            kept = [batch[i - (i % 2)] for i in range(len(batch))]
            return pack(kept, lcfg, ingest, dev)

        pipeline._pack_polar = half
    elif name == "altered":
        step = lo.odometry_step
        init = lo.init_state
        calls = {"n": 0}

        def init_state(feats):
            calls["n"] = 0
            return init(feats)

        def odometry_step(state, feats, cfg, init_rel=None):
            new, pose_w = step(state, feats, cfg, init_rel)
            calls["n"] += 1
            if calls["n"] == ALTERED_FRAME:
                t = pose_w.t.clone()
                t[0] += 0.02
                pose_w = se3.Pose(pose_w.q, t)
                new = new._replace(pose_w=pose_w)
            return new, pose_w

        lo.init_state = init_state
        lo.odometry_step = odometry_step
        dm.odometry_step = odometry_step
    else:
        raise ValueError(f"unknown fault {name!r}")
