"""Process-group initialisation and array placement, ported from
``lidar_visual_odometry_tpu/parallel/multihost.py``.

The JAX package joins a ``jax.distributed`` job whose devices form one global
mesh. The port runs one process a rank over ``torch.distributed``: every rank
holds the same host arrays and runs the same driver, and a sharded function
slices its own block (``sharded_odometry.Mesh``). Nothing here discovers a
cluster: the caller gives the store's address (``init_method``, e.g.
``file:///tmp/dir/store`` or ``tcp://localhost:<port>``), the world size and
the rank. ``parallel.launch`` starts the rank processes of one machine.

The backend defaults to NCCL on the card and gloo on the CPU. NCCL refuses two
ranks on one GPU ("Duplicate GPU detected"), so several ranks on one card pass
``backend="gloo"``: gloo then runs its collectives on the CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .sharded_odometry import DATA_AXIS, Mesh, make_mesh

_rank_device: torch.device | None = None


def initialize(init_method: str, world_size: int, rank: int, *, backend: str | None = None,
               device="cuda") -> torch.device:
    """Join the process group; returns the rank's device. ``device="cuda"``
    puts rank r on card r mod the card count (and raises without a card);
    ``backend`` None means NCCL for CUDA and gloo for the CPU."""
    global _rank_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _rank_device = dev
    return dev


def rank_device() -> torch.device | None:
    """The device ``initialize`` gave this rank, while its group lives."""
    return _rank_device if dist.is_available() and dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """The mesh of every rank in the job (one axis, ``DATA_AXIS``)."""
    if axis != DATA_AXIS:
        raise ValueError(f"the port's mesh has the one axis {DATA_AXIS!r}, got {axis!r}")
    return make_mesh()


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_device(mesh: Mesh, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    return torch.as_tensor(np.asarray(x)).to(mesh.device)


def host_local(mesh: Mesh, local, axis: int | None = None) -> torch.Tensor:
    """The whole array from each rank's part of it: ``local`` is this rank's
    block along ``axis`` (an all-gather joins them), or with ``axis`` None
    the whole array, identical on every rank. On the rank's device."""
    x = _to_device(mesh, local)
    return x if axis is None else mesh.gather_blocks(x, axis)


def replicate(mesh: Mesh, tree):
    """A pytree of host-identical arrays on the rank's device."""
    return _tree_map(lambda x: host_local(mesh, x), tree)


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """A pytree of FULL (host-identical) arrays, each rank contributing its
    own block along ``axis`` (``ValueError`` when the world size does not
    divide it) to the whole array on its device. The sharded functions take
    whole arrays and slice their own blocks, so this is the placement
    ``replicate`` makes, reached through one all-gather a leaf."""
    return _tree_map(lambda x: host_local(mesh, mesh.block(_to_device(mesh, x), axis), axis),
                     tree)
