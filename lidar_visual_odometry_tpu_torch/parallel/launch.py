"""Start the rank processes of one machine and collect their results.

    results = launch("package.module:function", world_size, inputs,
                     backend="gloo", device="cuda")

writes ``inputs`` (a dict of numpy arrays) to an npz in a new temporary
directory, starts ``world_size`` processes ``python -m
lidar_visual_odometry_tpu_torch.parallel.launch …`` (plain subprocesses: no
``multiprocessing`` helper process outlives the call), and in each one joins
the process group through a ``file://`` store in that directory
(``multihost.initialize``; no port to race for), calls ``function(mesh,
inputs)`` and saves the dict of arrays it returns. Returns each rank's dict,
in rank order, and removes the directory. A rank that fails, or a fleet that
outlasts ``timeout``, raises ``RuntimeError`` with the end of each rank's
output, after every rank has been stopped.

``target`` is ``module:function`` (imported from the working directory, the
repository root by default) or ``path/to/file.py:function``. The rank
processes import torch, numpy, the port and the target, nothing else.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(target: str, world_size: int, inputs: dict | None = None, *,
           backend: str | None = None, device: str = "cuda", timeout: float = 900.0,
           cwd: str | None = None, env: dict | None = None) -> list[dict[str, np.ndarray]]:
    """Run ``target`` on ``world_size`` ranks; returns each rank's results."""
    tmp = tempfile.mkdtemp(prefix="lvo_fleet_")
    procs, logs = [], []
    try:
        np.savez(os.path.join(tmp, "inputs.npz"), **(inputs or {}))
        child_env = dict(os.environ, **(env or {}))
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, child_env.get("PYTHONPATH")) if p)
        for rank in range(world_size):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, target, tmp, str(world_size), str(rank),
                 backend or "", device],
                stdout=log, stderr=subprocess.STDOUT, cwd=cwd or _REPO, env=child_env))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"the fleet outlasted {timeout} s"
            if failed:
                break
            time.sleep(0.05)
        if failed:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
            tails = []
            for rank in range(world_size):
                with open(os.path.join(tmp, f"rank{rank}.log"), errors="replace") as f:
                    tails.append(f"--- rank {rank} ---\n{f.read()[-3000:]}")
            raise RuntimeError(f"{target} on {world_size} ranks: {failed}\n" + "\n".join(tails))
        out = []
        for rank in range(world_size):
            with np.load(os.path.join(tmp, f"result{rank}.npz")) as data:
                out.append({k: data[k] for k in data.files})
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if not where or not name:
        raise ValueError(f"target must be 'module:function' or 'file.py:function', got {target!r}")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_lvo_rank_target", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _to_numpy(v) -> np.ndarray:
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _rank_main(argv: list[str]) -> int:
    target, tmp, world_size, rank, backend, device = argv
    rank, world_size = int(rank), int(world_size)
    sys.path.insert(0, os.getcwd())
    from . import multihost

    multihost.initialize(f"file://{os.path.join(tmp, 'store')}", world_size, rank,
                         backend=backend or None, device=device)
    try:
        with np.load(os.path.join(tmp, "inputs.npz")) as data:
            inputs = {k: data[k] for k in data.files}
        results = _resolve(target)(multihost.global_mesh(), inputs)
        np.savez(os.path.join(tmp, f"result{rank}.npz"),
                 **{k: _to_numpy(v) for k, v in results.items()})
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
