"""Checkpoint / resume of long runs, ported from
``lidar_visual_odometry_tpu/utils/checkpoint.py``.

One ``.npz`` holds the odometry feature state, the mapping state (the host
cube store, the device map of ``DeviceMapping``, or a chunk driver's raw map
state), the visual frontend's state (per frame or chunked), the direct-VO
window and the trajectories so far. The keys, dtypes and leaf orders are the
JAX package's, so a checkpoint written by either package resumes in the
other: ``frame_idx``, ``traj_q`` / ``traj_t``, ``pose_w_*``, ``pose_rel_*``,
``prev_ls_*`` / ``prev_lf_*``, ``map_*`` (host cube store), ``dmap_<i>`` and
``dmap_frame``, ``vis_*``, ``vchunk_levels`` and ``vchunk_<i>``,
``dchunk_levels`` and ``dchunk_<i>``, ``mapst_<i>``, and the caller's extra
arrays. A state's leaves are numbered in the order of its fields, nested
tuples depth first, as ``jax.tree.leaves`` numbers them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import se3
from ..utils.device import resolve_device


def _leaves(tree) -> list[np.ndarray]:
    """A state's leaves in field order, as host arrays. A host-side count
    (``DirectChunkState.count``) is the JAX package's int32 scalar."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [np.asarray(tree, np.int32)]


def _save_tree(prefix: str, tree, out: dict) -> None:
    for i, leaf in enumerate(_leaves(tree)):
        out[f"{prefix}_{i}"] = leaf


def _load_leaves(data, prefix: str, n: int, dev: torch.device) -> list[torch.Tensor]:
    """Leaves ``prefix_0`` … ``prefix_{n-1}`` on ``dev``, in their stored
    dtypes."""
    return [torch.from_numpy(np.array(data[f"{prefix}_{i}"])).to(dev) for i in range(n)]


def save_checkpoint(
    path: str,
    *,
    frame_idx: int,
    odom_state=None,
    trajectory_q: np.ndarray,
    trajectory_t: np.ndarray,
    mapper=None,
    device_mapper=None,
    visual=None,
    visual_chunk=None,
    direct_chunk=None,
    map_state=None,
    extra: dict | None = None,
) -> None:
    """Snapshot to one npz. ``odom_state``: ``lidar_odometry.OdometryState``;
    ``mapper``: ``LidarMapping`` (host cube store); ``device_mapper``:
    ``DeviceMapping``; ``visual``: ``VisualOdometry``; ``visual_chunk``:
    ``VisualChunkState``; ``direct_chunk``: ``DirectChunkState``;
    ``map_state``: a ``DeviceMapState`` carried by a chunk driver; ``extra``:
    named companion arrays (the other trajectories of a run)."""
    from ..models.lidar_odometry import odometry_state_to_numpy

    out: dict = {
        "frame_idx": np.asarray(frame_idx),
        "traj_q": np.asarray(trajectory_q),
        "traj_t": np.asarray(trajectory_t),
    }
    if odom_state is not None:
        out.update(odometry_state_to_numpy(odom_state))

    if mapper is not None:
        out["map_corr_q"] = mapper.correction.q.cpu().numpy()
        out["map_corr_t"] = mapper.correction.t.cpu().numpy()
        out["map_initialized"] = np.asarray(mapper.initialized)
        for name, store in (("corner", mapper.corner_map), ("surf", mapper.surf_map)):
            keys = np.asarray(sorted(store.cubes.keys()), np.int64).reshape(-1, 3)
            cubes = [store.cubes[k] for k in map(tuple, keys)]
            out[f"map_{name}_keys"] = keys
            out[f"map_{name}_sizes"] = np.asarray([c.shape[0] for c in cubes], np.int64)
            out[f"map_{name}_points"] = (np.concatenate(cubes) if cubes
                                         else np.zeros((0, 3), np.float32))

    if device_mapper is not None:
        _save_tree("dmap", device_mapper.state, out)
        out["dmap_frame"] = np.asarray(device_mapper._frame)

    if visual is not None:
        _save_tree("vis_table", visual.table, out)
        _save_tree("vis_pose_w", visual.pose_w, out)
        _save_tree("vis_warm", visual.warm_rel, out)
        out["vis_has_prev"] = np.asarray(visual.prev_pyr is not None)
        if visual.prev_pyr is not None:
            out["vis_pyr_levels"] = np.asarray(len(visual.prev_pyr))
            _save_tree("vis_pyr", tuple(visual.prev_pyr), out)
            _save_tree("vis_dc", visual.prev_dc, out)

    if visual_chunk is not None:
        out["vchunk_levels"] = np.asarray(len(visual_chunk.prev_pyr))
        _save_tree("vchunk", visual_chunk, out)

    if direct_chunk is not None:
        out["dchunk_levels"] = np.asarray(len(direct_chunk.pyrs))
        _save_tree("dchunk", direct_chunk, out)

    if map_state is not None:
        _save_tree("mapst", map_state, out)

    for k, v in (extra or {}).items():
        out[k] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, mapper=None, device_mapper=None, visual=None, device="cuda"):
    """Returns (frame_idx, OdometryState or None, traj_q, traj_t), the state
    on ``device``; restores ``mapper`` / ``device_mapper`` / ``visual`` in
    place (on their own devices) when given and present in the file."""
    from ..models.device_mapping import device_map_state_from_numpy
    from ..models.lidar_odometry import odometry_state_from_numpy
    from ..models.visual_frontend import DepthCloud, FeatureTable

    dev = resolve_device(device)
    data = np.load(path)
    state = odometry_state_from_numpy(data, dev) if "pose_w_q" in data else None

    if mapper is not None and "map_corr_q" in data:
        mdev = mapper.device
        mapper.correction = se3.Pose(torch.from_numpy(data["map_corr_q"]).to(mdev),
                                     torch.from_numpy(data["map_corr_t"]).to(mdev))
        mapper.initialized = bool(data["map_initialized"])
        for name, store in (("corner", mapper.corner_map), ("surf", mapper.surf_map)):
            store.cubes.clear()
            pts = data[f"map_{name}_points"]
            off = 0
            for k, n in zip(map(tuple, data[f"map_{name}_keys"]), data[f"map_{name}_sizes"]):
                store.cubes[k] = pts[off:off + n]
                off += n

    if device_mapper is not None and "dmap_0" in data:
        st = device_mapper.state
        device_mapper.state = device_map_state_from_numpy(
            {f"mapst_{i}": data[f"dmap_{i}"] for i in range(6)}, st.corner.device)
        device_mapper._frame = int(data["dmap_frame"])

    if visual is not None and "vis_table_0" in data:
        vdev = visual.table.uv.device
        visual.table = FeatureTable(*_load_leaves(data, "vis_table", 8, vdev))
        visual.pose_w = se3.Pose(*_load_leaves(data, "vis_pose_w", 2, vdev))
        visual.warm_rel = se3.Pose(*_load_leaves(data, "vis_warm", 2, vdev))
        if bool(data["vis_has_prev"]):
            levels = int(data["vis_pyr_levels"])
            visual.prev_pyr = tuple(_load_leaves(data, "vis_pyr", levels, vdev))
            visual.prev_dc = DepthCloud(*_load_leaves(data, "vis_dc", 3, vdev))
    return int(data["frame_idx"]), state, data["traj_q"], data["traj_t"]


def load_chunk_states(path: str, device="cuda"):
    """The chunked visual states of a checkpoint, on ``device``: returns
    (``VisualChunkState`` or None, ``DirectChunkState`` or None). The pyramid
    level counts are stored in the file."""
    from ..models.direct_vo import direct_chunk_state_from_numpy
    from ..models.visual_frontend import visual_chunk_state_from_numpy

    data = np.load(path)
    vchunk = dchunk = None
    if "vchunk_levels" in data:
        vchunk = visual_chunk_state_from_numpy(data, int(data["vchunk_levels"]), device)
    if "dchunk_levels" in data:
        dchunk = direct_chunk_state_from_numpy(data, int(data["dchunk_levels"]), device)
    return vchunk, dchunk


def load_map_state(path: str, device="cuda"):
    """The ``DeviceMapState`` a chunk driver saved (``map_state=``), on
    ``device``; None if the checkpoint carries none."""
    from ..models.device_mapping import device_map_state_from_numpy

    data = np.load(path)
    if "mapst_0" not in data:
        return None
    return device_map_state_from_numpy(data, device)


class RunRecord:
    """A chunk driver's trajectories and its snapshot schedule.

    Each trajectory is a list of chunks on the device after the rows it
    starts from (the frame-0 identity, or a resumed run's saved rows);
    ``host(name)`` returns the whole trajectory on the host and copies only
    the chunks added since its last call. A snapshot is due at a chunk
    boundary ``next_s`` (frames [0, next_s) done) once ``every`` frames have
    passed since the last one, or when the run stops there; the run stops at
    the first boundary past ``stop_after``, as the reference's drivers do."""

    def __init__(self, path: str | None, every: int, stop_after: int | None, start: int,
                 first: dict[str, np.ndarray]):
        self.path, self.every, self.stop_after = path, every, stop_after
        self.last_saved = start
        self._host = {k: [np.asarray(v, np.float32)] for k, v in first.items()}
        self._chunks = {k: [] for k in first}

    def append(self, **chunks: torch.Tensor) -> None:
        for k, v in chunks.items():
            self._chunks[k].append(v)

    def host(self, name: str) -> np.ndarray:
        got, chunks = self._host[name], self._chunks[name]
        got.extend(c.cpu().numpy() for c in chunks[len(got) - 1:])
        return np.concatenate(got)

    def stops(self, next_s: int) -> bool:
        return self.stop_after is not None and next_s > self.stop_after

    def snapshot_due(self, next_s: int) -> bool:
        if self.path and self.every > 0 and (next_s - self.last_saved >= self.every
                                             or self.stops(next_s)):
            self.last_saved = next_s
            return True
        return False
