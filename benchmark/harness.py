"""One run of one cell: the stream workers started, the window opened and
closed on one clock, the end-to-end metrics (``--trace 0``) or the per-layer
metrics (``--trace 1``) worked out, and the outputs judged.

``run_cell`` returns the result object that ``run.py`` prints, the lines of
numbers compared and what else the run saw. It raises ``NoDevice`` when the card the cell asks for
is not there; ``device="cpu"`` (tests only) runs the program's plain
versions on the CPU and cannot trace."""

from __future__ import annotations

import os
import pickle
import queue
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import spec, trace
from .worker import banned_modules

READY_TIMEOUT_S = 1100     # the first run of a checkout builds the kernels
MARGIN_NS = 300_000_000    # from the last worker's ready to the window's start


class NoDevice(RuntimeError):
    pass


class WorkerFailed(RuntimeError):
    pass


def _reader(fd: int, idx: int, q: queue.Queue) -> None:
    with os.fdopen(fd, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                q.put((idx, ("eof", None)))
                return
            q.put((idx, pickle.loads(f.read(int.from_bytes(head, "little")))))


def _send(proc, obj) -> None:
    data = pickle.dumps(obj)
    proc.stdin.write(len(data).to_bytes(8, "little") + data)
    proc.stdin.flush()


def check_device(device: str, chips: int) -> None:
    import torch

    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")


def prebuild(config: dict, device: str) -> None:
    """Build the program's CUDA kernels (for the card) and native packer once,
    before the workers start, into the program's own build directory in the
    checkout."""
    from lidar_visual_odometry_tpu_torch.data import native_pack

    if device == "cuda":
        from lidar_visual_odometry_tpu_torch.kernels import _build

        _build.build_all()
    L = config["settings"]["lidar"]
    native_pack.pack_polar_chunk([], n_scans=L["n_scans"], width=L["azimuth_bins"],
                                 min_range=L["min_range"], max_range=L["max_range"],
                                 n_frames=0)


def worker_env(root: Path) -> dict:
    env = dict(os.environ)
    cache = root / ".bench_cache"
    env.update({
        "PYTHONPATH": str(root) + os.pathsep + env.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "CUDA_CACHE_PATH": str(cache / "cuda"),
        "USE_FLAX": "0",
    })
    return env


def _collect(procs, q, want: str, timeout_s: float) -> list:
    got = [None] * len(procs)
    deadline = time.monotonic() + timeout_s
    while any(g is None for g in got):
        try:
            idx, (kind, payload) = q.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            raise WorkerFailed(f"workers {[i for i, g in enumerate(got) if g is None]} sent no "
                               f"{want!r} within {timeout_s:.0f} s") from None
        if kind == "error":
            raise WorkerFailed(f"worker {idx} failed:\n{payload}")
        if kind == "eof":
            if got[idx] is None:
                raise WorkerFailed(f"worker {idx} exited (code {procs[idx].wait()}) "
                                   f"before {want!r}")
            continue
        got[idx] = payload
    return got


def run_workers(root: Path, jobs: list, seconds: float):
    """Start one worker a job, open the window once all are ready, return
    (window start ns, window end ns, results)."""
    env = worker_env(root)
    q: queue.Queue = queue.Queue()
    procs, threads = [], []
    try:
        for i, job in enumerate(jobs):
            r, w = os.pipe()
            p = subprocess.Popen([sys.executable, "-m", "benchmark.worker", str(w)],
                                 cwd=root, env=env, stdin=subprocess.PIPE, pass_fds=(w,))
            os.close(w)
            procs.append(p)
            th = threading.Thread(target=_reader, args=(r, i, q), daemon=True)
            th.start()
            threads.append(th)
            _send(p, job)
        ready = _collect(procs, q, "ready", READY_TIMEOUT_S)
        t0 = max(ready) + MARGIN_NS
        t_end = t0 + int(seconds * 1e9)
        for p in procs:
            _send(p, ("go", t0, t_end))
        results = _collect(procs, q, "result", seconds + 600)
        for p in procs:
            p.stdin.close()
            p.wait(timeout=60)
        return t0, t_end, results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for th in threads:
            th.join(timeout=5)


def frames_per_s(results: list, t0: int, t_end: int) -> float:
    """Per stream: the frames of the sequences it completed in the window
    over the time from the window's start to its last completion; summed."""
    total = 0.0
    for r in results:
        done = [x for x in r["records"] if x["done"] <= t_end]
        if done:
            total += sum(x["frames"] for x in done) / ((max(x["done"] for x in done) - t0) / 1e9)
    return total


def compared(per_stream: list) -> float:
    """The number compared for one gap: each stream's widest gap over its
    checked frames, and of those the median over the streams. A single
    stream's rarest frame (float32 rounding in a weakly constrained
    direction) moves a median of 8 far less than the widest of all; a fault
    in the program's code, which every stream runs, moves it fully."""
    return float(statistics.median(max(v) for v in per_stream))


def second(per_stream: list) -> float:
    """The second-widest stream's widest gap: over its limit as soon as two
    streams are, where a fault that shows in only a few streams (one frame
    of a sequence, checked by some streams and not others) leaves the median
    unmoved."""
    widest = sorted(max(v) for v in per_stream)
    return float(widest[-2] if len(widest) > 1 else widest[-1])


STATISTICS = {"": compared, "second": second}


def statistic(name: str, per_stream_by_gap: dict) -> float:
    """A limit's number by its key: ``<gap>`` is the median (``compared``),
    ``<gap>.second`` the second-widest stream (``second``)."""
    gap, _, stat = name.partition(".")
    return STATISTICS[stat](per_stream_by_gap[gap])


def summary(per_stream_by_gap: dict) -> dict:
    """Every statistic of every gap, compared or not, and each stream's
    widest: what the readings of the limits are taken from."""
    return {g: {"median": compared(v), "second": second(v),
                "widest": float(max(max(x) for x in v)),
                "streams": [float(max(x)) for x in v]}
            for g, v in sorted(per_stream_by_gap.items())}


def judge(results: list, limits: dict):
    """(correct, attempted, failed, {name: (value, limit)}, ``summary`` of
    every gap): every sequence started in the window must return every
    frame, finite; each compared number (``statistic``) must lie within its
    limit; ``failed`` counts the frames of sequences that came back short or
    not finite, and the checked frames over a limit that was exceeded."""
    attempted = failed = 0
    correct = True
    streams = []
    for r in results:
        n = r["frames_in_sequence"]
        for x in r["records"]:
            attempted += n
            if x["frames"] != n or not x["finite"]:
                failed += n
                correct = False
        if r["checks"].get("frames_ok", False):
            streams.append({k: v for k, v in r["checks"].items() if k != "frames_ok"})
        else:
            correct = False
    names = sorted(set().union(*streams)) if streams else []
    by_gap = {k: [c[k] for c in streams] for k in names}
    checks = {k: (statistic(k, by_gap), lim) for k, lim in limits.items()
              if k.partition(".")[0] in by_gap}
    if set(checks) != set(limits):
        correct = False
    over = set()
    for k, (v, lim) in checks.items():
        if not v <= lim:
            correct = False
            gap = k.partition(".")[0]
            over |= {(gap, i, j) for i, c in enumerate(streams)
                     for j, g in enumerate(c[gap]) if not g <= lim}
    failed += len(over)
    return correct, attempted, failed, checks, summary(by_gap)


def trace_context(results: list, cfg: dict, device_name: str) -> dict:
    """What the per-layer readers read: the traced sequences' kernel time by
    name, launches and frames, the union of every stream's device intervals
    over the stretch that all streams traced (each stream's second sequence), and the program's counters
    over the traced sequences and over the whole timed loop."""
    traced = [r["traced"] for r in results]
    ctx = {"config": cfg, "device_name": device_name, "streams": len(results)}

    def delta(pair):
        c0, c1 = pair
        return {k: c1[k] - c0[k] for k in c1}

    ctx["window_counters"] = _sum([delta(r["counters"]) for r in results])
    lo = max(t["t_start"] for t in traced)
    hi = min(t["t_stop"] for t in traced)
    if hi <= lo:
        raise WorkerFailed("the streams' traced sequences share no stretch of time")
    starts = np.concatenate([t["start"] for t in traced])
    ends = np.concatenate([t["end"] for t in traced])
    busy, gaps = trace.union(starts, ends, lo, hi)
    by_name = {}
    for t in traced:
        dur = (t["end"] - t["start"]) / 1e9
        for i, name in enumerate(t["names"]):
            m = t["name"] == i
            n, s = by_name.get(name, (0, 0.0))
            by_name[name] = (n + int(m.sum()), s + float(dur[m].sum()))
    ctx.update({
        "busy_ns": busy, "window_ns": hi - lo, "gaps": gaps, "kernels": by_name,
        "launches": int(sum(t["is_kernel"].sum() for t in traced)),
        "traced_frames": int(sum(t["frames"] for t in traced)),
        "traced_counters": _sum([delta(t["counters"]) for t in traced]),
        "samples": [t["samples"] for t in traced],
        "clocks": [t["clock"] for t in traced],
    })
    return ctx


def _sum(dicts: list) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def breakdown(ctx: dict) -> dict:
    ops = sorted(ctx["kernels"].items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    gaps = sorted(ctx["gaps"], key=lambda g: g[1] - g[0], reverse=True)[:10]
    return {"device_ops": [[name[:120], s] for name, (_n, s) in ops],
            "idle_gaps": [[trace.host_label(ctx["samples"], (a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps]}


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *, device: str = "cuda",
             root: Path = spec.ROOT, streams: int | None = None, fault: str | None = None,
             t_start_ns: int | None = None, check_frames: int | None = None):
    """One run of a cell. Returns (the result object, the lines of numbers
    compared, a dict of what else the run saw: streams, sequences, the
    reference's time, every statistic of every gap compared or not, the
    trace's clocks and the traced rate)."""
    t_start_ns = time.monotonic_ns() if t_start_ns is None else t_start_ns
    root = Path(root)
    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(cell["config"], root / "benchmark")
    traffic = spec.traffic(cell["traffic"], root / "benchmark")
    check_device(device, cell["chips"])
    if trace_on and device != "cuda":
        raise NoDevice("a traced run needs the card")
    prebuild(cfg, device)
    n = traffic["streams"] if streams is None else streams
    jobs = [{"root": str(root), "device": device, "config": cfg, "traffic": traffic,
             "seed": seed, "stream": s, "fault": fault, "trace": trace_on,
             "check_frames": check_frames} for s in range(n)]
    t0, t_end, results = run_workers(root, jobs, seconds)

    correct, attempted, failed, checks, gaps = judge(results, cfg["limits"])
    banned = sorted(set().union(*[r["banned"] for r in results]) | set(banned_modules()))
    device_name = results[0]["device_name"]
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": device_name,
           "count": cell["chips"],
           "memory_peak_bytes": int(sum(r["memory_peak_bytes"] for r in results))}
    out = {"correct": bool(correct and not banned), "attempted": attempted, "failed": failed}
    if not trace_on:
        metrics = {"frames_per_s": {"value": frames_per_s(results, t0, t_end), "unit": "frames/s"},
                   "setup_s": {"value": (t0 - t_start_ns) / 1e9, "unit": "s"}}
    else:
        ctx = trace_context(results, cfg, device_name)
        metrics = {}
        for m in spec.metrics_of(bench, workload, "per_layer"):
            v = spec.reader(m["name"], root / "benchmark")(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = ctx["busy_ns"] / 1e9
        dev["window_s"] = ctx["window_ns"] / 1e9
        out["breakdown"] = breakdown(ctx)
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in checks.items()]
    if banned:
        lines.append(f"forbidden modules loaded: {', '.join(banned)}")
    info = {"streams": n, "frames_per_s": frames_per_s(results, t0, t_end),
            "sequences": [len(r["records"]) for r in results],
            "check_s": max(r["check_s"] for r in results),
            "gaps": gaps,
            "sequence_s_median": statistics.median(
                (x["done"] - x["start"]) / 1e9 for r in results for x in r["records"]
                if not x.get("traced"))}
    if trace_on:
        # the profiler's cost: the traced sequences' time against the others'
        info["traced_sequence_s_median"] = statistics.median(
            (x["done"] - x["start"]) / 1e9 for r in results for x in r["records"]
            if x.get("traced"))
        info["clocks"] = ctx["clocks"]
    return out, lines, info

