"""ctypes binding of the native scan reader (``native/dataloader.cpp``), ported
from ``lidar_visual_odometry_tpu/data/native_loader.py``.

The C++ reader (the native form of kittiHelper's read-and-publish loop,
``kittiHelper.cpp:25-35``) reads KITTI ``.bin`` files on a thread pool, pads
each into fixed-capacity buffers and hands them over in order through a
bounded prefetch ring, so disk reads overlap the device's work. The first use
builds it with ``g++`` into ``lidar_visual_odometry_tpu_torch/_build/``
(named by a hash of the source and the flags; never beside the source);
without ``g++`` it raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "dataloader.cpp"
_BUILD = _PKG / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None


def build_library(src: Path, flags: tuple, stem: str, key: bytes = b"") -> Path:
    """``src`` compiled once by ``g++ flags`` into ``_build/<stem>_<hash>.so``,
    the hash over the source, the flags and ``key``. Raises ``RuntimeError``
    without ``g++`` or when the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be built")
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode() + key).hexdigest()[:16]
    out = _BUILD / f"{stem}_{digest}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *flags, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{res.stderr}")
        os.replace(tmp, out)
    return out


def _build() -> Path:
    return build_library(_SRC, _FLAGS, "libdataloader")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.lvo_reader_create.restype = ctypes.c_void_p
        lib.lvo_reader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.lvo_reader_next.restype = ctypes.c_int32
        lib.lvo_reader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.lvo_reader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeScanReader:
    """In-order iterator over the velodyne ``.bin`` files ``pattern % index``
    (a printf pattern, e.g. ``.../velodyne/%06ld.bin``) for index 0 …
    ``n_files`` − 1. Yields (xyz (capacity, 3) float32, mask (capacity,)
    bool, reflectance (capacity,) float32), padded with zeros and cut at
    ``capacity``, prefetched ``prefetch`` files ahead on ``threads``
    threads."""

    def __init__(self, pattern: str, n_files: int, capacity: int = 131072,
                 prefetch: int = 4, threads: int = 2):
        lib = _load()
        self._lib = lib
        self.capacity = capacity
        self.n_files = n_files
        self._handle = lib.lvo_reader_create(pattern.encode(), n_files, capacity, prefetch,
                                             threads)
        if not self._handle:
            raise RuntimeError("failed to create the native reader")

    def __iter__(self):
        for _ in range(self.n_files):
            out = self.next()
            if out is None:
                return
            yield out

    def next(self):
        """The next scan, or None after the last. Raises
        ``FileNotFoundError`` for a missing file."""
        xyz = np.empty((self.capacity, 3), np.float32)
        mask = np.empty((self.capacity,), np.uint8)
        refl = np.empty((self.capacity,), np.float32)
        n = self._lib.lvo_reader_next(
            self._handle,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            refl.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n == -2:
            return None
        if n < 0:
            raise FileNotFoundError("missing scan file in sequence")
        return xyz, mask.astype(bool), refl

    def close(self):
        if self._handle:
            self._lib.lvo_reader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
