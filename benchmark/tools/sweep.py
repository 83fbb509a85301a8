"""Aggregate frame rate and device idle share of a cell at several stream
counts, one run each (traced and not), on the card:

    python3 benchmark/tools/sweep.py --workload odom_city_x8 --streams 1 2 4 8 \
        --seed 7 --seconds 15 [--out chiprun_out/sweep.jsonl]

Prints one JSON line a run with the host's CPU count beside it."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--trace", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    host = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
    for w in args.workload:
        for n in args.streams:
            for tr in args.trace:
                out, lines, info = harness.run_cell(w, args.seed, args.seconds, bool(tr),
                                                    root=ROOT, streams=n)
                row = {"workload": w, "streams": n, "trace": tr, **host, "result": out,
                       "info": info}
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
