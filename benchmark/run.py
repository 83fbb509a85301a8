"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from each stream's profiled second sequence of the window. The numbers compared
with the plain reference, each beside its limit, are the last lines of
standard error. Exits non-zero, printing no result, without the cards, when
a worker fails, or when a forbidden module (JAX or the JAX package) was
loaded."""

from __future__ import annotations

import time

T_START_NS = time.monotonic_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark.worker import banned_modules

    try:
        out, lines, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                            bool(args.trace), root=ROOT,
                                            t_start_ns=T_START_NS)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except harness.WorkerFailed as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    banned = banned_modules()
    if banned or any(line.startswith("forbidden") for line in lines):
        print(f"no result: forbidden modules loaded: {banned or lines[-1]}", file=sys.stderr)
        return 5
    print(json.dumps(info), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
