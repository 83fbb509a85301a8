"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

One module per TPU kernel it replaces:

* ``segsum`` — ``ops/pallas_segsum.py`` ``segment_sum_batched`` (K1)
* ``nn``     — ``ops/pallas_nn.py`` ``associate_kernel`` (K2)
* ``gn``     — ``ops/pallas_gn.py`` ``gn_inner_loop`` (K3)

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the kernel (built from
``csrc/`` on first use) or raises. Each counts its kernel launches.
"""

from __future__ import annotations

from . import gn, nn, segsum

_MODULES = {
    "segment_sum_batched": segsum,
    "associate_kernel": nn,
    "gn_inner_loop": gn,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
