"""Spans, stage timing and budget alarms (≡ TicToc and the printf timing of
the reference), ported from ``lidar_visual_odometry_tpu/utils/profiler.py``.

Spans: ``start()`` makes a ``Recorder`` active and returns it; while it is
active, every ``span(name, **attrs)`` that the lidar chain enters on the
thread that started it appends (name, start ns, end ns, parent index) to
lists in memory, on ``time.monotonic_ns``; ``stop()`` deactivates it and
returns the spans as arrays (``Recorder.arrays``). With no recorder active,
``span`` returns one shared no-op context: nothing is allocated or timed. A
span never synchronises a device and never launches work. The chain's spans
(``models/pipeline.py``, ``models/lidar_odometry.py``,
``models/device_mapping.py``, ``models/lidar_mapping.py``):

* ``sequence``, ``chunk``: one ``run_chunked`` call, one chunk of it;
* ``pack``, ``upload``: the host packing of a chunk and its copy to the
  device;
* ``frame``: one frame of a chunk; ``features``: its decode and feature
  extraction (frame 0's registration too); ``odometry`` (with an
  ``odometry.round`` a re-association round); ``mapping`` (with
  ``mapping.filter``, ``mapping.round`` a round and ``mapping.merge``);
* ``sync`` (attribute ``site``): a blocking device read, the only kind of
  span inside which the host waits on the device: ``odometry.exit`` and
  ``mapping.exit`` (the solvers' early exits), ``readback`` (the
  trajectory) and ``checkpoint``.

The spans of one ``run_chunked`` share a sequence id (``seq``: the index of
the outermost span open). ``summarise`` reads a layer's host time as its
spans less the ``sync`` spans inside them.

The reference times every stage on the wall clock and warns past 100 ms
(``include/aloam_velodyne/tic_toc.h:10-32``, ``scanRegistration.cpp:456-458``,
``laserOdometry.cpp:665-667``). ``StageTimer`` keeps the same discipline as a
reading of its own recorder's spans: per-stage means, counts and budget
overruns, a summary dict and a text report.

CUDA work is asynchronous: a region that launches kernels ends before they
do. ``time_blocked`` synchronises the streams of the CUDA tensors its
function returns inside the timed region (where the JAX package calls
``jax.block_until_ready``), so it measures the work, not its launch.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger("lvo_torch")

_NULL = contextlib.nullcontext()


class Recorder:
    """Spans in memory, recorded on the thread that made the recorder."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self.name: list[int] = []
        self.start: list[int] = []
        self.end: list[int] = []
        self.parent: list[int] = []
        self.seq: list[int] = []
        self.attrs: dict[int, dict] = {}
        self._open: list[int] = []

    def span(self, name: str, **attrs) -> "_Span":
        return _Span(self, name, attrs)

    def _enter(self, name: str, attrs: dict) -> int:
        i = len(self.name)
        k = self._ids.get(name)
        if k is None:
            k = self._ids[name] = len(self.names)
            self.names.append(name)
        parent = self._open[-1] if self._open else -1
        self.name.append(k)
        self.parent.append(parent)
        self.seq.append(i if parent < 0 else self.seq[parent])
        if attrs:
            self.attrs[i] = attrs
        self.end.append(-1)
        self._open.append(i)
        self.start.append(time.monotonic_ns())
        return i

    def _exit(self, i: int) -> None:
        self.end[i] = time.monotonic_ns()
        self._open.pop()

    def arrays(self) -> dict:
        """{'names': the name table, 'name' (int32 index into it), 'start',
        'end' (int64 ns; a span still open ends now), 'parent' (int32, −1 at
        the top), 'seq' (int32), 'attrs' ({span index: attrs})}."""
        now = time.monotonic_ns()
        return {"names": list(self.names),
                "name": np.asarray(self.name, np.int32),
                "start": np.asarray(self.start, np.int64),
                "end": np.asarray([e if e >= 0 else now for e in self.end], np.int64),
                "parent": np.asarray(self.parent, np.int32),
                "seq": np.asarray(self.seq, np.int32),
                "attrs": dict(self.attrs)}


class _Span:
    __slots__ = ("rec", "name", "attrs", "i")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.i = self.rec._enter(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self.i)
        return False

    @property
    def ms(self) -> float:
        return (self.rec.end[self.i] - self.rec.start[self.i]) / 1e6


# the spans sit deep in the chain's layers, whose signatures follow the
# reference's: they find the recorder here rather than through an argument
_active: Recorder | None = None


def span(name: str, **attrs):
    """A span of the active recorder, or the shared no-op context."""
    rec = _active
    if rec is None or rec.thread != threading.get_ident():
        return _NULL
    return _Span(rec, name, attrs)


def start() -> Recorder:
    """Make a new recorder active on this thread and return it."""
    global _active
    if _active is not None:
        raise RuntimeError("a span recorder is already active")
    _active = Recorder()
    return _active


def stop() -> dict:
    """Deactivate the recorder and return its spans (``Recorder.arrays``)."""
    global _active
    rec, _active = _active, None
    if rec is None:
        raise RuntimeError("no span recorder is active")
    return rec.arrays()


def outermost(spans: dict, names) -> np.ndarray:
    """Mask of the spans named in ``names`` that lie inside no other span so
    named: their durations add up without counting a nested one twice."""
    ids = [spans["names"].index(n) for n in names if n in spans["names"]]
    hit = np.isin(spans["name"], ids)
    out = hit.copy()
    parent = spans["parent"]
    for i in np.flatnonzero(hit):
        p = parent[i]
        while p >= 0:
            if hit[p]:
                out[i] = False
                break
            p = parent[p]
    return out


def summarise(spans: dict) -> dict:
    """Per span name: ``count``, ``ms`` (total), ``self_ms`` (less the child
    spans) and ``host_ms``, the total less the outermost ``sync`` spans
    inside them (for a layer, the host's own time; for ``sync`` itself, its
    total)."""
    dur = spans["end"] - spans["start"]
    parent = spans["parent"]
    child = np.zeros(len(dur), np.int64)
    np.add.at(child, parent[parent >= 0], dur[parent >= 0])
    inside = np.zeros(len(dur), np.int64)
    for i in np.flatnonzero(outermost(spans, ["sync"])):
        p = parent[i]
        while p >= 0:
            inside[p] += dur[i]
            p = parent[p]
    out = {}
    for k, name in enumerate(spans["names"]):
        m = spans["name"] == k
        out[name] = {"count": int(m.sum()), "ms": float(dur[m].sum()) / 1e6,
                     "self_ms": float((dur[m] - child[m]).sum()) / 1e6,
                     "host_ms": float((dur[m] - inside[m]).sum()) / 1e6}
    return out


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the work that produces the CUDA tensors in ``tree`` (a
    pytree of tuples, lists, dicts and tensors): synchronise each one's
    device's current stream. Returns ``tree``."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.current_stream(dev).synchronize()
    return tree


@dataclass
class StageTimer:
    budget_ms: float = 100.0
    recorder: Recorder = field(default_factory=Recorder)

    @contextlib.contextmanager
    def stage(self, name: str):
        with self.recorder.span(name) as s:
            yield
        if s.ms > self.budget_ms:
            logger.warning("%s over %.0f ms budget: %.1f ms", name, self.budget_ms, s.ms)

    def time_blocked(self, name: str, fn, *args, **kw):
        """Run ``fn`` and wait for its CUDA outputs inside the timed region."""
        with self.stage(name):
            out = block_until_ready(fn(*args, **kw))
        return out

    def summary(self) -> dict:
        spans = self.recorder.arrays()
        dur_ms = (spans["end"] - spans["start"]) / 1e6
        out = {}
        for name, s in summarise(spans).items():
            mine = dur_ms[spans["name"] == spans["names"].index(name)]
            out[name] = {"mean_ms": s["ms"] / max(s["count"], 1), "count": s["count"],
                         "over_budget": int((mine > self.budget_ms).sum())}
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:30s} {s['mean_ms']:8.2f} ms × {s['count']:<5d}"
                         f"  over-budget: {s['over_budget']}")
        return "\n".join(lines)
