"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds). Libraries land in
``lidar_visual_odometry_tpu_torch/_build/``, named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused. The
first call that needs a kernel builds it; ``build_all`` builds every kernel at
once, one ``nvcc`` process per source, all started together.

A failed build raises ``RuntimeError`` carrying nvcc's stderr. Set
``LVO_NVCC_VERBOSE=1`` to add ``-Xptxas -v`` and print what nvcc reports
(registers, shared memory, spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("segsum", "nn", "gn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def _verbose() -> bool:
    return os.environ.get("LVO_NVCC_VERBOSE", "") not in ("", "0")


def _flags() -> tuple[str, ...]:
    return NVCC_FLAGS + (("-Xptxas", "-v") if _verbose() else ())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags()).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every listed kernel library that is not built yet, in parallel.

    Returns seconds per source built (0.0 for a library already present)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                            f"{stdout}{stderr}")
            continue
        if _verbose():
            print(f"[nvcc {name}.cu]\n{stdout}{stderr}", flush=True)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
