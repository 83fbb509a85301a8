"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

One module per TPU kernel it replaces:

* ``segsum`` — ``ops/pallas_segsum.py`` ``segment_sum_batched`` and its flat
  ``segment_sum`` (K1)
* ``nn``     — ``ops/pallas_nn.py`` ``associate_kernel`` (K2) and
  ``ring_top2_pallas`` / ``ring_top2_coords`` (K7)
* ``gn``     — ``ops/pallas_gn.py`` ``gn_inner_loop`` (K3)
* ``topk``   — ``ops/pallas_nn.py`` ``block_topk_windowed`` (K4),
  ``block_topk`` (K5; K5p with ``packed=True``) and ``block_topk_coords`` (K8)
* ``lk``     — ``ops/pallas_lk.py`` ``lk_level`` (K6)

and one kernel that replaces no TPU kernel:

* ``features`` — the lidar front end's greedy feature selection (K9), which
  XLA compiled on the TPU and which ran as ~2,450 eager launches a frame

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the kernel (built from
``csrc/`` on first use) or raises. Each wrapper counts its kernel launches under its own name.
"""

from __future__ import annotations

from . import features, gn, lk, nn, segsum, topk

# wrapper name → (module, attribute that counts its launches)
_COUNTERS = {
    "segment_sum_batched": (segsum, "launches"),
    "segment_sum": (segsum, "flat_launches"),
    "associate_kernel": (nn, "launches"),
    "gn_inner_loop": (gn, "launches"),
    "block_topk_windowed": (topk, "windowed_launches"),
    "block_topk": (topk, "launches"),
    "block_topk_packed": (topk, "packed_launches"),
    "block_topk_coords": (topk, "coords_launches"),
    "ring_top2_pallas": (nn, "ring_top2_launches"),
    "ring_top2_coords": (nn, "ring_top2_coords_launches"),
    "lk_level": (lk, "launches"),
    "feature_select": (features, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
