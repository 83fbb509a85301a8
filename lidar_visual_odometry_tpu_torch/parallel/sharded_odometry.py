"""Data-parallel scan-to-scan odometry over ranks, ported from
``lidar_visual_odometry_tpu/parallel/sharded_odometry.py``.

The JAX package runs one process over a ``Mesh`` of devices (``shard_map``);
the port runs one process a rank over ``torch.distributed``, every rank the
same driver on the same inputs. ``Mesh`` holds what a sharded function needs:
the rank, the world size and the rank's device (the collectives run on the
default process group). A sharded
function takes the FULL arrays; each rank slices its own block of the sharded
axis, rank r rows r·n/D … (r+1)·n/D, as ``shard_map`` lays them out. Outputs
the JAX package returns sharded come back whole on every rank (an
all-gather). ``psum`` is ``all_reduce(SUM)``; the tensors one iteration sums
travel packed in one buffer, one collective an iteration.

The scan-to-scan Gauss-Newton is parallel over residual blocks: the current
frame's sharp and flat features shard, each rank associates its block (kernel
K2) against the replicated previous-frame clouds and accumulates its 6 × 6
normal equations, and one all-reduce sums H and g before the replicated
solve (42 floats an iteration). Under a reduction the solve is the plain GN
loop, not the fused kernel K3, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.lidar_odometry import scan_to_scan_impl
from ..ops import se3
from ..ops.features import FeatureCloud, ScanFeatures
from ..utils.config import OdometryConfig

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the job (the default process group): ``rank``,
    ``size`` (the world size) and the rank's ``device``."""

    rank: int
    size: int
    device: torch.device

    def block(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of ``x`` along ``axis``: rows r·n/D … (r+1)·n/D.
        Raises ``ValueError`` when D does not divide the axis (the JAX
        package asserts)."""
        n = x.shape[axis]
        if n % self.size:
            raise ValueError(f"axis {axis} of length {n} does not split over {self.size} ranks")
        per = n // self.size
        return x.narrow(axis, self.rank * per, per)

    def all_reduce_sum(self, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Each tensor summed over the ranks, all in one collective: they are
        packed into one float64 buffer and unpacked in their own shapes and
        dtypes. Every float32 and float64 value travels exactly, an integer
        one while its sums stay below 2^53. A sum is elementwise, so the
        packing changes no value but the rounding of float32 sums."""
        buf = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        out, at = [], 0
        for t in tensors:
            part = buf[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
            out.append(part.to(t.dtype) if t.is_floating_point() else part.round().to(t.dtype))
        return tuple(out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(D, *x.shape): every rank's ``x``, rank-major (the list form of
        ``all_gather``; booleans travel as bytes)."""
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y)
        out = torch.stack(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def gather_blocks(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The whole array from each rank's block along ``axis`` (the inverse
        of ``block``)."""
        return torch.cat(self.all_gather(x).unbind(0), dim=axis)


def make_mesh() -> Mesh:
    """The mesh of the initialised process group, on the rank's device that
    ``multihost.initialize`` chose (else the current CUDA device under NCCL
    and the CPU under gloo). Raises ``RuntimeError`` without a process
    group: it never makes a world of one on its own."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(multihost.initialize)")
    from . import multihost

    device = multihost.rank_device()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def _shard_cloud(mesh: Mesh, fc: FeatureCloud) -> FeatureCloud:
    return FeatureCloud(*(mesh.block(x) for x in fc))


def sharded_scan_to_scan(
    mesh: Mesh,
    curr: ScanFeatures,
    prev_less_sharp: FeatureCloud,
    prev_less_flat: FeatureCloud,
    init_rel: se3.Pose,
    cfg: OdometryConfig,
) -> se3.Pose:
    """The odometry step with the current frame's sharp and flat features
    sharded along their capacity (which the world size must divide); the
    less-sharp / less-flat clouds and the pose are replicated. The normal
    equations are all-reduced before each solve. Returns T_last_curr,
    replicated."""
    local = ScanFeatures(_shard_cloud(mesh, curr.sharp), curr.less_sharp,
                         _shard_cloud(mesh, curr.flat), curr.less_flat)

    def reduce(H, g):
        return mesh.all_reduce_sum(H, g)

    return scan_to_scan_impl(local, prev_less_sharp, prev_less_flat, init_rel, cfg,
                             reduce_fn=reduce)
