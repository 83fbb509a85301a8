"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/tools/readings.py --workload slam_city_x8 \
        --program-seeds 1 2 3 ... --control-seeds 101 102 103 --seconds 10 \
        [--out chiprun_out/readings.jsonl]

``--program-seeds``: whole short runs of the cell (every stream at once, the
window's load), each checking one sequence a stream against the reference,
as a benchmark run does; the largest of each number over the seeds is the
lower reading (every statistic of every gap, compared or not, is in each
line's ``info["gaps"]``). ``--control-seeds``: the reference itself,
computed in float32 with TF32 matrix products, put in the program's place on
each stream's sequence and checked the same way; the smallest of each number
over the seeds is the upper reading. One JSON line a seed."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def control_gaps(workload: str, seed: int, device: str = "cuda", root: Path = ROOT,
                 streams: int | None = None) -> dict:
    """With the TF32 reference in the program's place: each limit's number
    as a run compares it (``harness.statistic``), and every statistic of
    every gap (``harness.summary``)."""
    import importlib

    import torch

    from benchmark import harness, spec, traffic_gen
    from benchmark.reference import aloam
    from benchmark.worker import check_frames

    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(cell["config"], root / "benchmark")
    traffic = spec.traffic(cell["traffic"], root / "benchmark")
    entry = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    per_stream = []
    n = traffic["streams"] if streams is None else streams
    for s in range(n):
        boxes, R, t = traffic_gen.sequence(traffic, seed, s)
        scans = traffic_gen.render(traffic, boxes, R, t, seed, s, device)
        out = entry.control(scans, cfg, aloam.control_arith(device))
        frames = check_frames(seed, s, len(scans), cfg["check_frames"])
        per_stream.append(entry.check(scans, out, cfg, aloam.Arith(torch.float64, device), frames))
    by_gap = {k: [c[k] for c in per_stream] for k in per_stream[0] if k != "frames_ok"}
    out = {"frames_ok": all(c["frames_ok"] for c in per_stream),
           "limits": {k: harness.statistic(k, by_gap) for k in cfg["limits"]},
           "gaps": harness.summary(by_gap)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    def emit(row):
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    for seed in args.program_seeds:
        out, _lines, info = harness.run_cell(args.workload, seed, args.seconds, False, root=ROOT)
        emit({"workload": args.workload, "side": "program", "seed": seed,
              "correct": out["correct"], "checks": out["checks"], "metrics": out["metrics"],
              "info": info})
    for seed in args.control_seeds:
        t = time.monotonic()
        emit({"workload": args.workload, "side": "control", "seed": seed,
              "checks": control_gaps(args.workload, seed), "s": time.monotonic() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
