"""ctypes binding of the native polar scan packer (``native/scanpack.cpp``),
ported from ``lidar_visual_odometry_tpu/data/native_pack.py``.

The host side of the polar ingests: ``lvo_pack_polar`` packs each raw scan of a
chunk into its (ring, azimuth) uint16 image of quantised range and packed
angular offsets, nearest return winning a cell, one frame a thread. It is the
compiled twin of the numpy ``ops.pointcloud.pack_polar_scan``. The two round
differently in a few cells (the C library's float32 ``atan2`` against numpy's,
a point on a ring or column boundary, an offset quantum), so this packer, and
not the numpy one, gives the JAX package's images.

The first use builds the library with ``g++`` into
``lidar_visual_odometry_tpu_torch/_build/`` with the JAX binding's own flags
(so both builds give the same bits on one host), named by a hash of the
source, the flags and the host CPU's model name (``-march=native`` ties the
library to the CPU). Unlike the JAX binding it never falls back to numpy: no
``g++``, a failed build or a failed pack raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .native_loader import build_library

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "scanpack.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None


def _cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo`` ("" where there is none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(_SRC, _FLAGS, "libscanpack",
                                            _cpu_model().encode())))
        lib.lvo_pack_polar.restype = ctypes.c_int32
        lib.lvo_pack_polar.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),   # the frames' row pointers
            ctypes.POINTER(ctypes.c_int64),    # points a frame
            ctypes.c_int32,                    # frames
            ctypes.c_int64,                    # floats a row
            ctypes.c_int32,                    # n_scans
            ctypes.c_int32,                    # width
            ctypes.c_float,                    # min_range
            ctypes.c_float,                    # max_range
            ctypes.POINTER(ctypes.c_uint16),   # out
        ]
        _lib = lib
    return _lib


def pack_polar_chunk(scans, *, n_scans: int, width: int, min_range: float, max_range: float,
                     n_frames: int | None = None, channels: int = 2) -> np.ndarray:
    """Raw (n_i, ≥3) float scans → (K, n_scans, width, channels) uint16 polar
    images. K = ``n_frames`` (≥ ``len(scans)``; the frames past the scans
    stay zero, that is empty). ``channels=1`` is the range plane alone, sliced
    from the two-channel pack. Every scan must have the same row width (xyz
    first)."""
    if channels == 1:
        full = pack_polar_chunk(scans, n_scans=n_scans, width=width, min_range=min_range,
                                max_range=max_range, n_frames=n_frames, channels=2)
        return np.ascontiguousarray(full[..., :1])
    if channels != 2:
        raise ValueError(f"channels must be 1 or 2, got {channels}")
    k = len(scans) if n_frames is None else n_frames
    if k < len(scans):
        raise ValueError(f"n_frames {n_frames} is fewer than the {len(scans)} scans")
    out = np.zeros((k, n_scans, width, 2), np.uint16)
    lib = _load()
    arrs = [np.ascontiguousarray(np.asarray(p, dtype=np.float32)) for p in scans]
    stride = arrs[0].shape[1] if arrs else 3
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != stride or stride < 3:
            raise ValueError(f"every scan must be (n, {stride}) with xyz first, got {a.shape}")
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    counts = (ctypes.c_int64 * len(arrs))(*[a.shape[0] for a in arrs])
    rc = lib.lvo_pack_polar(ptrs, counts, len(arrs), stride, n_scans, width, min_range,
                            max_range, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise RuntimeError(f"lvo_pack_polar failed ({rc}) for n_scans={n_scans}")
    return out
