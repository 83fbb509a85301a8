"""The port's lidar chain read by its spans (``utils/profiler.py``): what each
layer costs the host, how often and how long the host waits on the card, and
what each stream's host was doing while the card sat idle.

    python tools/span_trace.py streams --workload odom_city_x8 --seed N [--seconds 51]
    python tools/span_trace.py audit [--seed N]
    python tools/span_trace.py cost [--seed N] [--pairs 10]
    python tools/span_trace.py outputs --out FILE [--seed N] [--root CHECKOUT]

``streams`` makes one traced run of a benchmark cell, as ``benchmark/run.py
--trace 1`` does (every stream's second sequence of the window under
``torch.profiler``), with the span recorder on in each stream worker for
exactly its profiled sequence (``apply``, the worker's hook for code planted
before its set-up). It prints the benchmark's result object and the span
readings: ``METRICS`` over the traced sequences' frames, and ``idle_split``,
the card's idle time in the traced stretch by what each stream's main thread
was doing (inside a program span, waiting in a ``sync`` span, or outside the
program), with the ten longest idle gaps and every stream's innermost open
span in each.

``audit`` runs one sequence of each cell's entry (stream 0 of the cell's
traffic) under ``torch.cuda.set_sync_debug_mode("warn")`` with the recorder
on, and lists every synchronising call with the spans open around it and its
call site: on the chain every one must lie inside a ``sync`` span. ``cost``
times one stream's sequence of each cell with the recorder on and off, in
alternating pairs, and checks that both give the same poses bit for bit.
``outputs`` writes one sequence's poses of each cell (streams 0 and 1) to an
npz, from the program in ``--root``, to compare two checkouts bit for bit.

Every mode needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("odom_city_x8", "slam_city_x8")
SEED = 2147483901
LAYERS = ("pack", "upload", "features", "odometry", "mapping", "sync")


# ---------------------------------------------------------------------------
# readings of the spans (ctx: the benchmark's trace context plus "spans", one
# recorder's arrays a stream)
# ---------------------------------------------------------------------------

def _summaries(ctx) -> list:
    from lidar_visual_odometry_tpu_torch.utils.profiler import summarise

    if "_summaries" not in ctx:
        ctx["_summaries"] = [summarise(s) for s in ctx["spans"]]
    return ctx["_summaries"]


def _sum(ctx, names, key) -> float:
    return sum(s[n][key] for s in _summaries(ctx) for n in names if n in s)


def frames(ctx) -> int:
    return int(_sum(ctx, ("frame",), "count"))


def _per_frame(ctx, names, key):
    f = frames(ctx)
    if f <= 0 or not any(n in s for s in _summaries(ctx) for n in names):
        return None
    return _sum(ctx, names, key) / f


def _sync_wait_pct(ctx):
    seq = _sum(ctx, ("sequence",), "ms")
    return 100.0 * _sum(ctx, ("sync",), "host_ms") / seq if seq > 0 else None


def _below(s: np.ndarray, e: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Length of the sorted disjoint intervals [s, e) that lies before each t."""
    cum = np.concatenate([[0], np.cumsum(e - s)])
    i = np.searchsorted(s, t, side="right")
    over = np.where(i > 0, np.maximum(e[np.maximum(i - 1, 0)] - t, 0), 0) if len(s) else 0
    return cum[i] - over


def _overlap(s, e, gaps: np.ndarray) -> int:
    """ns of the sorted disjoint intervals [s, e) inside the gaps."""
    if not len(s) or not len(gaps):
        return 0
    return int((_below(s, e, gaps[:, 1]) - _below(s, e, gaps[:, 0])).sum())


def _intervals(spans: dict, mask: np.ndarray):
    order = np.argsort(spans["start"][mask], kind="stable")
    return spans["start"][mask][order], spans["end"][mask][order]


def idle_states(spans: dict, gaps: np.ndarray) -> dict:
    """ns of the gaps in which one stream's main thread was inside a program
    span but not in a ``sync`` span (dispatching), inside a ``sync`` span
    (waiting on the card), or outside every span."""
    from lidar_visual_odometry_tpu_torch.utils.profiler import outermost

    total = int((gaps[:, 1] - gaps[:, 0]).sum()) if len(gaps) else 0
    inside = _overlap(*_intervals(spans, spans["parent"] < 0), gaps)
    sync = _overlap(*_intervals(spans, outermost(spans, ["sync"])), gaps)
    return {"dispatch": inside - sync, "sync": sync, "outside": total - inside}


def _gaps(ctx) -> np.ndarray:
    return np.asarray(ctx["gaps"], np.int64).reshape(-1, 2)


def _idle_host_dispatch_pct(ctx):
    gaps = _gaps(ctx)
    total = int((gaps[:, 1] - gaps[:, 0]).sum()) if len(gaps) else 0
    if total <= 0 or not ctx["spans"]:
        return None
    return 100.0 * statistics.fmean(idle_states(s, gaps)["dispatch"] / total
                                    for s in ctx["spans"])


METRICS = {
    "pack_ms_per_frame": lambda c: _per_frame(c, ("pack", "upload"), "ms"),
    "features_host_ms_per_frame": lambda c: _per_frame(c, ("features",), "host_ms"),
    "odometry_host_ms_per_frame": lambda c: _per_frame(c, ("odometry",), "host_ms"),
    "mapping_host_ms_per_frame": lambda c: _per_frame(c, ("mapping",), "host_ms"),
    "syncs_per_frame": lambda c: _per_frame(c, ("sync",), "count"),
    "sync_wait_pct": _sync_wait_pct,
    "idle_host_dispatch_pct": _idle_host_dispatch_pct,
}


def innermost(spans: dict, t: int) -> str:
    """The innermost span open at ``t`` ('sync:<site>' for a sync), or
    'outside'."""
    m = np.flatnonzero((spans["start"] <= t) & (spans["end"] > t))
    if not len(m):
        return "outside"
    i = int(m[np.argmax(spans["start"][m])])
    name = spans["names"][spans["name"][i]]
    site = spans["attrs"].get(i, {}).get("site")
    return f"{name}:{site}" if site else name


def uncovered(ctx) -> dict:
    """The ``sequence`` time, summed over streams, outside the layers' spans
    (``LAYERS``), as a share, and the self time of the spans around them."""
    from lidar_visual_odometry_tpu_torch.utils.profiler import outermost

    seq = layer = 0
    for s in ctx["spans"]:
        dur = s["end"] - s["start"]
        seq += int(dur[outermost(s, ["sequence"])].sum())
        layer += int(dur[outermost(s, LAYERS)].sum())
    own = {n: _sum(ctx, (n,), "self_ms") for n in ("sequence", "chunk", "frame")}
    return {"pct": 100.0 * (seq - layer) / seq if seq else None, "self_ms": own}


def idle_split(ctx) -> dict:
    """The card's idle time in the traced stretch by each stream's state
    (``idle_states``), means over streams in s and % of the idle time, and
    the ten longest gaps with every stream's innermost open span."""
    gaps = _gaps(ctx)
    total = int((gaps[:, 1] - gaps[:, 0]).sum()) if len(gaps) else 0
    states = [idle_states(s, gaps) for s in ctx["spans"]]
    mean = {k: statistics.fmean(st[k] for st in states) for k in ("dispatch", "sync", "outside")}
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:10]] if len(gaps) else []
    return {
        "idle_s": total / 1e9,
        "mean_over_streams_s": {k: v / 1e9 for k, v in mean.items()},
        "mean_over_streams_pct": {k: 100.0 * v / total if total else None
                                  for k, v in mean.items()},
        "longest_gaps": [{"s": int(b - a) / 1e9,
                          "streams": [innermost(s, (int(a) + int(b)) // 2) for s in ctx["spans"]]}
                         for a, b in longest],
    }


def read(ctx) -> dict:
    out = {k: f(ctx) for k, f in METRICS.items()}
    out["frames"] = f = frames(ctx)
    out["rounds_per_frame"] = {k: _per_frame(ctx, (f"{k}.round",), "count")
                               for k in ("odometry", "mapping")}
    names = sorted({n for sm in _summaries(ctx) for n in sm})
    out["host_ms_per_frame"] = {n: _per_frame(ctx, (n,), "host_ms") for n in names} if f else {}
    sites = collections.Counter(a["site"] for s in ctx["spans"] for a in s["attrs"].values()
                                if "site" in a)
    out["syncs_per_frame_by_site"] = {k: n / f for k, n in sorted(sites.items())} if f else {}
    out["uncovered"] = uncovered(ctx)
    out["idle_split"] = idle_split(ctx)
    return out


# ---------------------------------------------------------------------------
# the stream workers' hook
# ---------------------------------------------------------------------------

def apply(name: str) -> None:
    """In a benchmark stream worker, before its set-up: ``spans`` turns the
    recorder on and off with the worker's profiler, and adds the spans to
    what the profile returns."""
    if name != "spans":
        raise ValueError(f"unknown hook {name!r}")
    from benchmark import trace
    from lidar_visual_odometry_tpu_torch.utils import profiler

    class Profile(trace.Profile):
        def __init__(self):
            super().__init__()
            profiler.start()

        def stop(self) -> dict:
            spans = profiler.stop()
            return {**super().stop(), "spans": spans}

    trace.Profile = Profile


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------

def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _cell(workload: str):
    import importlib

    from benchmark import spec

    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    cfg = spec.config(cell["config"])
    return cfg, spec.traffic(cell["traffic"]), importlib.import_module(
        f"benchmark.entries.{cfg['entry']}")


def _scans(traffic, seed, stream):
    from benchmark import traffic_gen

    return traffic_gen.render(traffic, *traffic_gen.sequence(traffic, seed, stream), seed, stream,
                              "cuda")


def streams(args) -> dict:
    from benchmark import harness

    tools = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPATH"] = tools + os.pathsep + os.environ.get("PYTHONPATH", "")
    got = {}
    context = harness.trace_context

    def capture(results, cfg, device_name):
        ctx = context(results, cfg, device_name)
        ctx["spans"] = [r["traced"]["spans"] for r in results]
        got["ctx"] = ctx
        return ctx

    harness.trace_context = capture
    out, lines, info = harness.run_cell(args.workload, args.seed, args.seconds, True,
                                        root=ROOT, fault="span_trace:spans")
    return {"card": _card(), "workload": args.workload, "seed": args.seed, "result": out,
            "checks": lines, "traced_sequence_s_median": info["traced_sequence_s_median"],
            "sequence_s_median": info["sequence_s_median"], "spans": read(got["ctx"])}


def audit(args) -> dict:
    import traceback
    import warnings

    import torch

    from lidar_visual_odometry_tpu_torch.utils import profiler

    report = {"card": _card()}
    for workload in CELLS:
        cfg, traffic, entry = _cell(workload)
        scans = _scans(traffic, args.seed, 0)
        entry.run(entry.build(cfg, "cuda"), scans[:1 + cfg["run"]["chunk"]], cfg)
        torch.cuda.synchronize()
        found = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            rec = profiler._active
            chain = []
            for i in (rec._open if rec is not None else []):
                site = rec.attrs.get(i, {}).get("site")
                chain.append(rec.names[rec.name[i]] + (f":{site}" if site else ""))
            full = traceback.extract_stack()[:-1]
            stack = [f for f in full
                     if f.filename.startswith(ROOT) and not f.filename.endswith("span_trace.py")]
            found.append((tuple(chain), tuple(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                                              f"{f.name}" for f in (stack or full)[-3:])))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            profiler.start()
            try:
                entry.run(entry.build(cfg, "cuda"), scans, cfg)
            finally:
                spans = profiler.stop()
                torch.cuda.set_sync_debug_mode(0)
        in_sync = [f for f in found if any(c.startswith("sync") for c in f[0])]
        outside = collections.Counter(
            (" > ".join(c) or "outside", " | ".join(s)) for c, s in found
            if not any(x.startswith("sync") for x in c))
        sites = collections.Counter(c[-1] for c, _ in in_sync)
        summary = profiler.summarise(spans)
        report[workload] = {
            "frames": summary.get("frame", {}).get("count", 0),
            "synchronising_calls": len(found),
            "inside_sync_spans": len(in_sync), "by_sync_site": dict(sites),
            "sync_spans": summary.get("sync", {}).get("count", 0),
            "outside_sync_spans": [{"calls": n, "open_spans": c, "call_site": s}
                                   for (c, s), n in outside.most_common()]}
    return report


def cost(args) -> dict:
    import torch

    from lidar_visual_odometry_tpu_torch.utils import profiler

    report = {"card": _card()}
    for workload in CELLS:
        cfg, traffic, entry = _cell(workload)
        scans = _scans(traffic, args.seed, 0)
        entry.run(entry.build(cfg, "cuda"), scans, cfg)
        torch.cuda.synchronize()
        times, outs, n_spans = {True: [], False: []}, {}, 0
        for p in range(args.pairs):
            for recorded in ((True, False) if p % 2 == 0 else (False, True)):
                t0 = time.monotonic_ns()
                if recorded:
                    profiler.start()
                out = entry.run(entry.build(cfg, "cuda"), scans, cfg)
                if recorded:
                    n_spans = len(profiler.stop()["name"])
                times[recorded].append((time.monotonic_ns() - t0) / 1e9)
                outs.setdefault(recorded, out)
        same = all(np.array_equal(outs[True][k], outs[False][k]) for k in outs[True])

        def stats(v):
            q = statistics.quantiles(v, n=4)
            return {"median": statistics.median(v), "q1": q[0], "q3": q[2], "runs": v}

        diff = [a - b for a, b in zip(times[True], times[False])]
        report[workload] = {"on_s": stats(times[True]), "off_s": stats(times[False]),
                            "on_minus_off_s": stats(diff), "spans_a_sequence": n_spans,
                            "same_poses_bit_for_bit": same}
    return report


def outputs(args) -> dict:
    arrays = {}
    for workload in CELLS:
        cfg, traffic, entry = _cell(workload)
        for stream in (0, 1):
            scans = _scans(traffic, args.seed, stream)
            for k, v in entry.run(entry.build(cfg, "cuda"), scans, cfg).items():
                arrays[f"{workload}.{stream}.{k}"] = v
    np.savez(args.out, **arrays)
    return {"card": _card(), "root": args.root, "arrays": len(arrays), "out": args.out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("streams", "audit", "cost", "outputs"))
    ap.add_argument("--workload", choices=CELLS, default=CELLS[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--root", default=ROOT, help="outputs: the checkout whose program runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.mode == "outputs":
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("span_trace: needs a CUDA device", file=sys.stderr)
        return 2
    report = {"streams": streams, "audit": audit, "cost": cost, "outputs": outputs}[
        args.mode](args)
    print(json.dumps(report, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
