"""Stage timing and budget alarms (≡ TicToc and the printf timing of the
reference), ported from ``lidar_visual_odometry_tpu/utils/profiler.py``.

The reference times every stage on the wall clock and warns past 100 ms
(``include/aloam_velodyne/tic_toc.h:10-32``, ``scanRegistration.cpp:456-458``,
``laserOdometry.cpp:665-667``). ``StageTimer`` keeps the same discipline in
records: per-stage totals, counts and budget overruns, a summary dict and a
text report.

CUDA work is asynchronous: a region that launches kernels ends before they
do. ``time_blocked`` synchronises the streams of the CUDA tensors its
function returns inside the timed region (where the JAX package calls
``jax.block_until_ready``), so it measures the work, not its launch.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("lvo_torch")


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
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    violations: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.totals[name] += dt
            self.counts[name] += 1
            if dt > self.budget_ms:
                self.violations[name] += 1
                logger.warning("%s over %.0f ms budget: %.1f ms", name, self.budget_ms, dt)

    def time_blocked(self, name: str, fn, *args, **kw):
        """Run ``fn`` and wait for its CUDA outputs inside the timed region."""
        with self.stage(name):
            out = block_until_ready(fn(*args, **kw))
        return out

    def summary(self) -> dict:
        return {
            name: {
                "mean_ms": self.totals[name] / max(self.counts[name], 1),
                "count": self.counts[name],
                "over_budget": self.violations[name],
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:30s} {s['mean_ms']:8.2f} ms × {s['count']:<5d}"
                         f"  over-budget: {s['over_budget']}")
        return "\n".join(lines)
