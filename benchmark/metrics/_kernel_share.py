"""Shared by the ``*_roofline`` readers: a kernel's roofline share (%) in the
traced sequences, from its launches and device time (by CUDA kernel name) and
the bounds ``roofline.py`` counts from the configuration's shapes."""

import importlib.util
import re
from pathlib import Path


def _roofline():
    path = Path(__file__).resolve().parent.parent / "roofline.py"
    spec = importlib.util.spec_from_file_location("benchmark_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def share(ctx, calls_fn: str, count_name: str, time_names: tuple):
    """``count_name``: the kernel whose launches count the calls;
    ``time_names``: every kernel whose device time a call takes."""
    if "kernels" not in ctx:
        return None
    rl = _roofline()
    n = sum(c for name, (c, _s) in ctx["kernels"].items() if _is(name, count_name))
    s = sum(t for name, (_c, t) in ctx["kernels"].items()
            if any(_is(name, k) for k in time_names))
    return rl.share_pct(getattr(rl, calls_fn)(ctx["config"]["settings"]), n, 1, s,
                        ctx["device_name"])


def _is(kernel_name: str, base: str) -> bool:
    """Whether a profiler kernel name ('void (anonymous namespace)::f<12>(...)',
    'f(...)') is of the function ``base``."""
    return re.search(rf"(?<![\w]){re.escape(base)}\s*[<(]", kernel_name) is not None
