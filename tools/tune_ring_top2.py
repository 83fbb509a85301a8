"""Tune kernel K7's launch configuration on one GPU: queries a thread (QPT)
and segments a ring (S).

Builds ``csrc/nn.cu`` once for each fixed configuration (``-DLVO_K7_QPT``,
``-DLVO_K7_SEGMENTS``; one nvcc each, all started together) into
``lidar_visual_odometry_tpu_torch/_build/tune/``, beside the default build,
whose ``top2_config`` chooses at launch. Each build's ``lvo_ring_top2`` runs
in both output forms at the odometry association's shapes (edges Q 768
against (64, 120, 3), planes Q 1536 against (64, 512, 3); random inputs as
``chip_smoke.py`` makes them for K2: the kernel has no data-dependent branch),
must equal the plain version bit for bit, and is traced by ``torch.profiler``:
the median device time of 40 calls a build and form, the builds' calls
interleaved. Prints a table and writes ``<out>/tune_ring_top2.json``.

    python tools/tune_ring_top2.py [--out DIR] [--configs 2x4,2x2,...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CALLS = {"edges": (768, 64, 120), "planes": (1536, 64, 512)}
ROUNDS = 40


def _build_configs(configs):
    """One nvcc a fixed (QPT, S), all at once; their C launchers by name."""
    from lidar_visual_odometry_tpu_torch.kernels import _build, nn

    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for qpt, s in configs:
        lib = out_dir / f"libnn_k7_{qpt}x{s}.so"
        cmd = [_build._nvcc(), *_build._flags(), f"-DLVO_K7_QPT={qpt}",
               f"-DLVO_K7_SEGMENTS={s}", "-o", str(lib), str(_build.CSRC_DIR / "nn.cu")]
        procs[f"{qpt}x{s}"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True), lib)
    launchers = {"default": _build.launcher("nn", "lvo_ring_top2", nn._ARGTYPES["lvo_ring_top2"])}
    for name, (proc, lib) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{stdout}{stderr}")
        fn = ctypes.CDLL(str(lib)).lvo_ring_top2
        fn.argtypes = nn._ARGTYPES["lvo_ring_top2"]
        fn.restype = ctypes.c_int
        launchers[name] = fn
    return launchers


def _call(fn, q, c, coords):
    """One launch of ``fn`` (a ``lvo_ring_top2``) in one output form."""
    import torch

    from lidar_visual_odometry_tpu_torch.kernels import _build

    Q, (R, B, _) = q.shape[0], c.shape
    dist = torch.empty((Q, R, 2), dtype=torch.float32, device=q.device)
    if coords:
        out = (torch.empty((Q, R, 3), dtype=torch.float32, device=q.device),
               torch.empty((Q, R, 3), dtype=torch.float32, device=q.device))
        ptrs = (None, out[0].data_ptr(), out[1].data_ptr())
    else:
        out = (torch.empty((Q, R, 2), dtype=torch.int32, device=q.device),)
        ptrs = (out[0].data_ptr(), None, None)
    _build.check(fn(q.data_ptr(), c.data_ptr(), dist.data_ptr(), *ptrs, Q, R, B,
                    _build.stream(q)), "lvo_ring_top2")
    return (dist,) + out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--configs", default=",".join(f"{q}x{s}" for q in (1, 2, 4)
                                                  for s in (1, 2, 4, 8)))
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _assoc_inputs, _smi
    from lidar_visual_odometry_tpu_torch.kernels import nn

    if not torch.cuda.is_available():
        print("tune_ring_top2: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = _smi()
    print(smi, flush=True)
    configs = [tuple(int(v) for v in name.split("x")) for name in args.configs.split(",")]
    launchers = _build_configs(configs)
    rng = np.random.default_rng(0)
    result = {"card": smi, "rounds": ROUNDS, "median_device_ms": {}}
    for kind, (Q, R, B) in CALLS.items():
        q, c = _assoc_inputs(rng, Q, R, B, dev)
        want = (nn.ring_top2_pallas_plain(q, c), nn.ring_top2_coords_plain(q, c))
        runs = [(name, coords) for name in launchers for coords in (False, True)]
        for name, coords in runs:
            got = _call(launchers[name], q, c, coords)
            if not all(torch.equal(a, b) for a, b in zip(got, want[coords])):
                raise AssertionError(f"{name} ({kind}, coords={coords}) differs from the "
                                     "plain version")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ROUNDS):
                for name, coords in runs:
                    _call(launchers[name], q, c, coords)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                         and "ring_top2_kernel" in e.name), key=lambda e: e.time_range.start)
        if len(events) != ROUNDS * len(runs):
            raise AssertionError(f"{len(events)} kernel events for {ROUNDS * len(runs)} calls")
        per = result["median_device_ms"].setdefault(kind, {})
        for j, (name, coords) in enumerate(runs):
            us = [e.time_range.elapsed_us() for e in events[j::len(runs)]]
            per.setdefault(name, {})["coords" if coords else "index"] = float(np.median(us)) / 1e3
        print(f"{kind} Q={Q} vs ({R},{B},3), median device ms of {ROUNDS} calls (index, coords):")
        for name, t in sorted(per.items(), key=lambda kv: kv[1]["index"]):
            print(f"  {name:>8}  {t['index']:.4f}  {t['coords']:.4f}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "tune_ring_top2.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
