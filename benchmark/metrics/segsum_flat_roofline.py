"""segsum_flat_roofline: K1 flat (the mapping voxel filters' sums, two a mapped frame): its calls' least time at the card's peaks,
counted from the shapes in roofline.py, over its device time in the
traced sequences (%)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_kernel_share", Path(__file__).resolve().parent / "_kernel_share.py")
_ks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ks)


def read(ctx):
    return _ks.share(ctx, "segsum_flat_calls", "segsum_flat_kernel", ("segsum_flat_kernel",))
