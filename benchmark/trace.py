"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the card
in every stream worker for the stream's second sequence of the window (the
streams' first sequences end at different times, so the traced ones do not
all start together, as the first ones do at the window's start), kernel intervals moved onto the
host's monotonic clock, and the union of all workers' intervals.

The profiler is started and stopped on the worker's main thread, the one
that launches the program's work. A helper thread only samples the main
thread's Python stack every few milliseconds (what the host was doing). The
profile's raw events are read without building the profiler's event tree,
and nothing is written to disk: the kernels go to the parent as arrays.

The profiler's clock is tied to ``time.monotonic_ns`` by a call that the
worker makes and the profiler records (``cudaStreamQuery`` on a stream of its
own), once before and once after the profiled sequence."""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

import numpy as np

SAMPLE_S = 0.002
ANCHOR = "cudaStreamQuery"


def _label(frame, roots) -> str:
    """The innermost frame of the stack that lies in one of ``roots``:
    'module.function'."""
    while frame is not None:
        fn = frame.f_code.co_filename
        for r in roots:
            if fn.startswith(r):
                mod = os.path.splitext(os.path.relpath(fn, r))[0].replace(os.sep, ".")
                return f"{mod}.{frame.f_code.co_name}"
        frame = frame.f_back
    return "other"


class StackSampler(threading.Thread):
    """Samples the main thread's innermost frame in ``roots`` until stopped."""

    def __init__(self, roots):
        super().__init__(daemon=True)
        self.roots = roots
        self.main_ident = threading.main_thread().ident
        self.samples = []
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(SAMPLE_S):
            fr = sys._current_frames().get(self.main_ident)
            self.samples.append((time.monotonic_ns(), _label(fr, self.roots)))

    def stop(self) -> list:
        self.done.set()
        self.join(timeout=10)
        return self.samples


class Profile:
    """A CUDA-only profile of this process, started and stopped on the
    calling thread."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.stream = torch.cuda.Stream()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.anchors = [self._anchor()]

    def _anchor(self) -> int:
        t0 = time.monotonic_ns()
        self.stream.query()
        t1 = time.monotonic_ns()
        return (t0 + t1) // 2

    def stop(self) -> dict:
        self.anchors.append(self._anchor())
        self.prof.stop()
        return kernel_arrays(self.prof.profiler.kineto_results.events(), self.anchors)


def kernel_arrays(events, anchors) -> dict:
    """Device intervals of a profile's raw events on the monotonic clock:
    {'start', 'end' (int64 ns), 'name' (int32 index into 'names'),
    'is_kernel' (bool: False for copies and sets), 'names', 'clock'}."""
    marks = sorted(e.start_ns() for e in events if e.name() == ANCHOR)
    if len(marks) < 2 or marks[-1] <= marks[0]:
        raise RuntimeError(f"the profile holds {len(marks)} {ANCHOR} calls: no clock anchor")
    (m0, m1), (k0, k1) = (anchors[0], anchors[-1]), (marks[0], marks[-1])
    scale = (m1 - m0) / (k1 - k0)
    clock = f"{ANCHOR} anchors, scale {scale:.9f}"
    names, index = [], {}
    st, en, ni, kern = [], [], [], []
    for e in events:
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name = e.name()
        i = index.setdefault(name, len(index))
        if i == len(names):
            names.append(name)
        s = e.start_ns()
        st.append(s)
        en.append(s + e.duration_ns())
        ni.append(i)
        kern.append(not name.startswith(("Memcpy", "Memset")))

    def mono(x):
        return (m0 + (np.asarray(x, np.float64) - k0) * scale).astype(np.int64)

    return {"start": mono(st), "end": mono(en), "name": np.asarray(ni, np.int32),
            "is_kernel": np.asarray(kern, bool), "names": names, "clock": clock}


def union(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int):
    """Busy ns of the union of intervals clipped to [lo, hi), and the idle
    gaps inside it as (start, end) pairs."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    busy, gaps = 0, []
    cur_s, cur_e = None, lo
    for a, b in zip(s.tolist(), e.tolist()):
        if cur_s is None or a > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, hi))
    return busy, [(a, b) for a, b in gaps if b > a]


def host_label(samples_by_worker: list, t: int, tol_ns: int = 10_000_000) -> str:
    """What the streams' hosts were doing at ``t``: the most common label of
    each worker's nearest stack sample (within ``tol_ns``), with how many
    streams showed it."""
    labels = []
    for samples in samples_by_worker:
        if not samples:
            continue
        ts = np.fromiter((s[0] for s in samples), np.int64, len(samples))
        i = int(np.argmin(np.abs(ts - t)))
        if abs(int(ts[i]) - t) <= tol_ns:
            labels.append(samples[i][1])
    if not labels:
        # the sampler thread needs the GIL: a main thread inside a native
        # call that holds it looks the same as a thread the host did not run
        return "no sample within 10 ms (GIL held or thread not scheduled)"
    name, n = collections.Counter(labels).most_common(1)[0]
    return f"{name} ({n}/{len(samples_by_worker)} streams)"
