"""topk_windowed_roofline: K4 (the range pre-pass and the windowed 5-NN search, two a mapping round): its calls' least time at the card's peaks,
counted from the shapes in roofline.py, over its device time in the
traced sequences (%)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_kernel_share", Path(__file__).resolve().parent / "_kernel_share.py")
_ks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ks)


def read(ctx):
    return _ks.share(ctx, "topk_windowed_calls", "topk_windowed_kernel", ("topk_windowed_kernel", "topk_window_ranges_kernel"))
