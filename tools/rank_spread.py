"""Where a distributed SLAM run on two ranks can part from the same run on one.

Runs ``DistributedSlamPipeline(SystemConfig()).run`` as one rank (an NCCL
world of one on the card) over the corridor's first ``--frames`` scans (the
synthetic sequence of ``chip_smoke.py``, full width), three times:

1. ``blocks``: at every call of the sharded scan-to-map step's merged 5-NN
   (``parallel.sharded_mapping._nn_merged``) the search is repeated on the
   same queries and submap cut into 1 and into 2 rank blocks, each block
   streamed in 2048-column chunks and the blocks' k best merged as the
   ranks' are, once with each per-pair distance: ``matmul``
   (``knn.pairwise_sqdist``, |q|² + |c|² − 2 q·c through a matrix product)
   and ``by_axis`` (``knn.sqdist_by_axis``, the search's own). For each it
   counts the queries whose merged neighbours differ between 1 and 2 blocks
   and reports the first: frame, feature class, round, query, distances.
2. ``nudge``: the run again with the odometry's x at frame ``--nudge-frame``
   moved by one float32 ulp before its scan-to-map step, against the run
   unchanged: how far the mapped positions move, from which frame, and the
   scan-to-map rounds a frame in both (the adaptive exit reads the pose).

The pipeline's own search is left as it is, so each trajectory is the
product's. Prints one JSON object (and writes it to ``--out``).

    python tools/rank_spread.py [--frames 17] [--nudge-frame 1] [--out PATH]
"""

from __future__ import annotations

import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")   # before numpy (ROADMAP C.5)
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 2048


def blocked_search(q, c_xyz, c_mask, k, n_blocks, dist_fn):
    """(dist (Q, k), coordinates (Q, k, 3)): the map cut into ``n_blocks``
    rank blocks, each searched as ``knn.knn(chunk=CHUNK)`` searches with
    ``dist_fn``, the blocks' k best merged by (distance, rank, slot)."""
    import torch

    from lidar_visual_odometry_tpu_torch.ops import knn

    Q, C = q.shape[0], c_xyz.shape[0]
    per = C // n_blocks
    parts = []
    for b in range(n_blocks):
        xyz, mask = c_xyz[b * per:(b + 1) * per], c_mask[b * per:(b + 1) * per]
        valid = torch.nonzero(mask).squeeze(1)
        cands = xyz[valid]
        best_d = torch.full((Q, k), 1e30, dtype=q.dtype, device=q.device)
        best_i = torch.zeros((Q, k), dtype=torch.int64, device=q.device)
        for base in range(0, valid.shape[0], CHUNK):
            d = torch.cat([best_d, dist_fn(q, cands[base:base + CHUNK])], dim=1)
            all_i = torch.cat([best_i, valid[base:base + CHUNK].expand(Q, -1)], dim=1)
            sel, best_d = knn._smallest_k(d, k)
            best_i = all_i.gather(1, sel)
        parts.append(torch.cat([best_d[..., None], xyz[best_i]], dim=-1))
    cand = torch.stack(parts).permute(1, 0, 2, 3).reshape(Q, n_blocks * k, 4)
    sel, best = knn._smallest_k(cand[..., 0], k)
    return best, cand[..., 1:].gather(1, sel[..., None].expand(Q, k, 3))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--nudge-frame", type=int, default=1)
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args()

    import torch

    from lidar_visual_odometry_tpu_torch.data import synthetic
    from lidar_visual_odometry_tpu_torch.ops import knn, se3
    from lidar_visual_odometry_tpu_torch.parallel import multihost
    from lidar_visual_odometry_tpu_torch.parallel import sharded_mapping as sm
    from lidar_visual_odometry_tpu_torch.parallel.distributed_pipeline import (
        DistributedSlamPipeline,
    )
    from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

    if not torch.cuda.is_available():
        print("rank_spread: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    seq = synthetic.SyntheticSequence(n_frames=49, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    with ThreadPoolExecutor(8) as ex:
        scans = list(ex.map(seq.scan, range(args.frames)))

    forms = {"matmul": knn.pairwise_sqdist, "by_axis": knn.sqdist_by_axis}
    blocks = {"calls": 0, "queries": 0,
              **{f: {"queries_differing": 0, "calls_differing": 0, "first": None}
                 for f in forms}}
    where = {"frame": 0, "call": 0, "compare": False}
    product = sm._nn_merged

    def compare_blocks(qpts, cands, k, got):
        which = "corner" if where["call"] % 2 == 0 else "surf"
        for form, fn in forms.items():
            d1, x1 = blocked_search(qpts, cands.xyz, cands.mask, k, 1, fn)
            d2, x2 = blocked_search(qpts, cands.xyz, cands.mask, k, 2, fn)
            if form == "by_axis" and not (torch.equal(d1, got[0]) and torch.equal(x1, got[1])):
                raise AssertionError("the one-block search is not the product's")
            bad = torch.nonzero((x1 != x2).any(-1).any(-1)).squeeze(1)
            r = blocks[form]
            r["queries_differing"] += int(bad.numel())
            r["calls_differing"] += int(bad.numel() > 0)
            if bad.numel() and r["first"] is None:
                i = int(bad[0])
                r["first"] = {"frame": where["frame"], "class": which,
                              "round": where["call"] // 2, "query": i,
                              "dist_1_block": d1[i].tolist(), "dist_2_blocks": d2[i].tolist()}
        blocks["calls"] += 1
        blocks["queries"] += int(qpts.shape[0])

    def watched(mesh, qpts, cands, k):
        got = product(mesh, qpts, cands, k)
        if where["compare"]:
            compare_blocks(qpts, cands, k, got)
        where["call"] += 1
        return got

    def run(compare=False, nudge_at=None):
        """Mapped positions (N, 3) and merged searches a frame."""
        where["compare"] = compare
        pipe = DistributedSlamPipeline(SystemConfig(), n_devices=1, device="cuda")
        mapping_update = pipe._mapping_update

        def nudged(feats, map_skip=1):
            if pipe._frame == nudge_at:
                t = pipe.pose_w.t.clone()
                t[0] = torch.nextafter(t[0], torch.tensor(np.inf, device=t.device))
                pipe.pose_w = se3.Pose(pipe.pose_w.q, t)
            return mapping_update(feats, map_skip)

        pipe._mapping_update = nudged
        mapped, searches = [], []
        for k, pts in enumerate(scans):
            where.update(frame=k, call=0)
            mapped.append(pipe.process_scan(np.asarray(pts)).t)
            searches.append(where["call"])
        return torch.stack(mapped).cpu().numpy().astype(np.float64), searches

    sm._nn_merged = watched
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, device="cuda")
        try:
            base, base_searches = run(compare=True)
            moved, moved_searches = run(nudge_at=args.nudge_frame)
        finally:
            multihost.shutdown()
    per_frame = np.abs(moved - base).max(axis=1)
    over = np.nonzero(per_frame > 1e-5)[0]
    report = {
        "card": smi, "frames": args.frames, "blocks": blocks,
        "nudge": {"frame": args.nudge_frame, "what": "odometry x + 1 float32 ulp",
                  "largest_mapped_move_m": float(per_frame.max()),
                  "first_frame_over_1e-5_m": int(over[0]) if over.size else None,
                  "mapped_move_m_per_frame": per_frame.tolist(),
                  "searches_per_frame": base_searches,
                  "searches_per_frame_nudged": moved_searches},
    }
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
