"""One stream of a benchmark run, in a process of its own:
``python -m benchmark.worker <fd>``, started by ``benchmark/harness.py``.

The worker reads its job from standard input, renders its stream's sequence
on the device, warms the program up on the sequence's first chunk, reports
ready on file descriptor ``fd`` and waits for the window's start. In the
window it runs the sequence again and again, a fresh program object each
time (a closed loop), until a sequence completes after the window's end
(in a traced run, not before its second sequence, the profiled one, has
completed). Then it frees the program's state, checks one sequence drawn from the seed
against the plain reference and sends its records. Messages are pickled,
each preceded by its length."""

from __future__ import annotations

import gc
import importlib
import os
import pickle
import sys
import time
import traceback

BANNED = ("jax", "jaxlib", "flax", "lidar_visual_odometry_tpu")
# the sequence of the window that a traced run profiles: the second, whose
# starts are spread over the streams by their first sequences
TRACED_SEQUENCE = 1


def send(out, obj) -> None:
    data = pickle.dumps(obj)
    out.write(len(data).to_bytes(8, "little") + data)
    out.flush()


def recv(inp):
    n = int.from_bytes(inp.read(8), "little")
    return pickle.loads(inp.read(n))


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark forbids."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def check_frames(seed: int, stream: int, n_frames: int, k: int) -> list:
    """The frames of a sequence that the reference checks: frame 1 (the
    start: odometry from the identity, the first map insertion) and k − 1
    more drawn from the seed."""
    import numpy as np

    from benchmark import traffic_gen

    rng = traffic_gen.stream_rng(seed, stream, "check-frames")
    more = rng.choice(np.arange(2, n_frames), size=min(k - 1, n_frames - 2), replace=False)
    return [1] + sorted(more.tolist())


def _sleep_until(t_ns: int) -> None:
    while (left := (t_ns - time.monotonic_ns()) / 1e9) > 0:
        time.sleep(min(left, 0.05))


def run(job: dict, inp, out) -> dict:
    import torch

    from benchmark import traffic_gen
    from benchmark.reference import aloam

    device, config, traffic = job["device"], job["config"], job["traffic"]
    seed, stream = job["seed"], job["stream"]
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    entry = importlib.import_module(f"benchmark.entries.{config['entry']}")
    if job.get("fault"):
        mod, name = job["fault"].split(":")
        importlib.import_module(mod).apply(name)
    from lidar_visual_odometry_tpu_torch import kernels

    boxes, R, t = traffic_gen.sequence(traffic, seed, stream)
    scans = traffic_gen.render(traffic, boxes, R, t, seed, stream, device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    chunk = config["run"]["chunk"]
    entry.run(entry.build(config, device), scans[:1 + chunk], config)
    sync()
    if job.get("trace"):
        # the profiler's first use initialises it: in set-up, not in the window
        import warnings

        from torch.profiler import ProfilerActivity, profile

        warnings.filterwarnings("ignore", module="torch.profiler")
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            sync()
    send(out, ("ready", time.monotonic_ns()))
    _kind, t0, t_end = recv(inp)

    tracing = bool(job.get("trace"))
    prof = sampler = traced = None
    if tracing:
        from benchmark.trace import Profile, StackSampler
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sleep_until(t0)
    c0 = kernels.launch_counts()
    records, outs = [], []
    while True:
        if tracing and traced is None and len(records) == TRACED_SEQUENCE:
            sampler = StackSampler([os.path.join(job["root"], d) + os.sep
                                    for d in ("lidar_visual_odometry_tpu_torch", "benchmark")])
            sampler.start()
            cp = kernels.launch_counts()
            prof = Profile()
        ts = time.monotonic_ns()
        result = entry.run(entry.build(config, device), scans, config)
        td = time.monotonic_ns()
        frames = min(len(v) for v in result.values())
        records.append({"start": ts, "done": td, "frames": frames, "traced": prof is not None,
                        "finite": all(bool((v == v).all()) and bool(abs(v).max() < 1e30)
                                      for v in result.values())})
        outs.append(result)
        if prof is not None:
            counters = (cp, kernels.launch_counts())
            arrays = prof.stop()
            traced = {**arrays, "t_start": prof.anchors[0], "t_stop": td,
                      "frames": frames, "counters": counters, "samples": sampler.stop()}
            prof = None
        if td >= t_end and (traced is not None or not tracing):
            break
    c1 = kernels.launch_counts()
    peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # one sequence of those due in the window, drawn from the seed
    due = [i for i, r in enumerate(records) if r["done"] <= t_end] or [0]
    pick = due[int(traffic_gen.stream_rng(seed, stream, "check-sequence").integers(len(due)))]
    frames = check_frames(seed, stream, len(scans), job.get("check_frames") or config["check_frames"])
    tc = time.monotonic_ns()
    checks = entry.check(scans, outs[pick], config, aloam.Arith(torch.float64, device), frames)
    sync()
    return {"records": records, "checked": pick, "check_frames": frames, "checks": checks,
            "check_s": (time.monotonic_ns() - tc) / 1e9,
            "counters": (c0, c1), "traced": traced, "memory_peak_bytes": peak,
            "device_name": name, "frames_in_sequence": len(scans),
            "banned": banned_modules()}


def main() -> int:
    out = os.fdopen(int(sys.argv[1]), "wb")
    inp = sys.stdin.buffer
    try:
        job = recv(inp)
        sys.path.insert(0, job["root"])
        send(out, ("result", run(job, inp, out)))
        return 0
    except BaseException:
        send(out, ("error", traceback.format_exc()))
        return 1
    finally:
        out.close()


if __name__ == "__main__":
    sys.exit(main())
