"""The JAX package's feature-VO drift diagnosis on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 13 gates ``scripts/diag_visual_torch.py``
on these numbers. Runs ``scripts/diag_visual.py``'s ``run_pass`` (the visual
frontend frame by frame, with ground-truth depth, flow or both swapped in)
for each of its four passes on the first ``--frames`` frames of the bench
corridor, with the tracker's levels on ``pallas_lk.lk_level`` in interpret
mode (``tools/jax_reference_camlidar.py``'s routing, as the TPU runs them).
Records each pass's ATE (camera frame, unaligned, as the script prints it)
and its per-frame stats.

A camera trajectory decides on rounding (one track's one-ulp sensitivity
parts two runs by centimetres), so for the passes that keep an estimated
quantity (``base``, ``gt_depth``, ``gt_flow``) it also runs the four one-ulp
members of ``tools/jax_reference_camlidar.py`` (``fx``, ``fy`` one float32
ulp up and down; a member whose ATE and stats equal the pass's is replaced
by ``cx`` up, then ``cy`` up) under ``ulp_members``. ``gt_both`` feeds the
solve exact tracks and depths and has no members.

Scans, images and ground-truth depth maps are rendered in threads with
numpy's BLAS held to one thread (ROADMAP C.5); ``inputs_sha256`` digests the
scans, then the images, then the depth maps of the frames run. A pass over
the 48-frame corridor takes about two minutes, sixteen runs with the
members about half an hour; or run one process a pass (``--passes base
--out A.json`` ...) and write the one file with ``--merge A.json B.json
...``. Writes ``tools/jax_reference_diag.json`` and prints it.

    python tools/jax_reference_diag.py [--frames 49] [--passes base,gt_depth,gt_flow,gt_both]
                                       [--out PATH] [--merge FILE ...]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from jax_reference_camlidar import (  # noqa: E402
    CAM, MEMBERS, SPARES, bench_config, inputs_sha256, lk_through_pallas_interpret, nudged,
)
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.ops import camera as cam_ops  # noqa: E402

N_FRAMES = 49
PASSES = ("base", "gt_depth", "gt_flow", "gt_both")
CHAOTIC = ("base", "gt_depth", "gt_flow")


def diag_script():
    """``scripts/diag_visual.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "diag_visual", os.path.join(ROOT, "scripts", "diag_visual.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corridor():
    return synthetic.SyntheticSequence(n_frames=N_FRAMES, width=1800, speed=1.0,
                                       yaw_rate=0.004, noise=0.01)


def _render_frame(seq, k):
    Rc, tc = synthetic.camera_from_velodyne_pose(*seq.pose(k))
    return synthetic.render_image(seq.scene, Rc, tc, **CAM)


def render(seq, n):
    """The first ``n`` scans, images and ground-truth depth maps, rendered in
    threads with one BLAS thread each."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        scans = list(ex.map(seq.scan, range(n)))
        rendered = list(ex.map(partial(_render_frame, seq), range(n)))
    return scans, [r[0] for r in rendered], [r[1] for r in rendered]


def run(dv, mode, inputs, seq, cfg, n):
    """One pass of ``run_pass`` with the tracker on the interpret-mode
    kernel: (ATE, per-frame stats, seconds)."""
    scans, images, depths = inputs
    cam = cam_ops.Pinhole.from_config(cfg.camera)
    t0 = time.time()
    with lk_through_pallas_interpret():
        ate, stats = dv.run_pass(mode, scans, images, depths, seq, cfg, cam, n, verbose=False)
    return float(ate), stats, time.time() - t0


def members(dv, mode, inputs, seq, cfg, n, ate, stats) -> list:
    """The pass with each camera intrinsic moved by one float32 ulp; a
    member that gives the pass's ATE and stats is replaced by the next
    spare."""
    out, spares = [], list(SPARES)
    for name, direction in MEMBERS:
        while True:
            mcfg = nudged(cfg, name, direction)
            m_ate, m_stats, secs = run(dv, mode, inputs, seq, mcfg, n)
            if not (m_ate == ate and m_stats == stats):
                break
            print(f"{mode} member {name} {direction}: the pass's figures bit for bit; replaced",
                  flush=True)
            if not spares:
                raise SystemExit("no spare member left")
            name, direction = spares.pop(0)
        out.append({"intrinsic": name, "direction": direction,
                    "value": getattr(mcfg.camera, name), "ate_m": m_ate, "run_s": secs})
        print(f"{mode} member {name} {direction}: ATE {m_ate:.5f} m ({secs:.1f} s)", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--passes", default=",".join(PASSES))
    ap.add_argument("--out", default=os.path.join(HERE, "jax_reference_diag.json"))
    ap.add_argument("--merge", nargs="+", metavar="FILE",
                    help="write the passes of these records (one run's inputs) as one")
    args = ap.parse_args()
    if args.merge:
        recs = []
        for path in args.merge:
            with open(path) as f:
                recs.append(json.load(f))
        if len({(r["frames"], r["inputs_sha256"]) for r in recs}) != 1:
            raise SystemExit("the records ran different inputs")
        out = dict(recs[0], passes={m: p for r in recs for m, p in r["passes"].items()})
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
        return
    n = args.frames
    seq = corridor()
    t0 = time.time()
    inputs = render(seq, n)
    render_s = time.time() - t0
    dv = diag_script()
    cfg = bench_config()
    out = {"backend": jax.default_backend(), "lk": "pallas_lk.lk_level, interpret mode",
           "frames": n, "inputs_sha256": inputs_sha256(*inputs[0], *inputs[1], *inputs[2]),
           "render_s": render_s, "passes": {}}
    for mode in args.passes.split(","):
        ate, stats, secs = run(dv, mode, inputs, seq, cfg, n)
        print(f"{mode}: ATE {ate:.5f} m ({secs:.1f} s)", flush=True)
        rec = {"ate_m": ate, "run_s": secs, "stats": stats}
        if mode in CHAOTIC:
            rec["ulp_members"] = members(dv, mode, inputs, seq, cfg, n, ate, stats)
        out["passes"][mode] = rec
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
