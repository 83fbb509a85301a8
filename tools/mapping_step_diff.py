"""How far one ulp moves the JAX package's mapped positions, beside the port's gap, on the CPU.

``tests/test_torch_eval_regimes.py`` compares the two eval scripts' mapped
positions on tiny regimes; this tool shows what bound such a comparison can
hold. On ``scripts/eval_regimes.py``'s high-noise regime cut as that test cuts
it (4 frames at 600 azimuth samples, the test's small mapping configuration
with the dense map search), the JAX ``FullPipeline.run_chunked`` stops after
frame ``s`` and writes a checkpoint (chunks of one frame); then, from that one
state, it resumes three times: as written, with the map's surface points
moved by one ulp, and with the map correction moved by one ulp; and the
port's ``FullPipeline`` resumes from it too. It prints, a frame, each run's
largest mapped-position difference from the unnudged JAX run, and the port's
largest odometry difference.

    python tools/mapping_step_diff.py [--frames 4] [--noise 0.05]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.models.pipeline import FullPipeline as JaxFull  # noqa: E402
from lidar_visual_odometry_tpu.utils import config as jcfg  # noqa: E402
from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline as PortFull  # noqa: E402
from lidar_visual_odometry_tpu_torch.utils import config as tcfg  # noqa: E402
from test_torch_eval_regimes import WIDTH, _small  # noqa: E402


def _nudged(path: str, key: str, out: str) -> str:
    arrays = dict(np.load(path))
    arrays[key] = np.nextafter(arrays[key], np.float32(np.inf)).astype(np.float32)
    np.savez(out, **arrays)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.05)
    args = ap.parse_args()
    seq = synthetic.SyntheticSequence(n_frames=args.frames, width=WIDTH, yaw_rate=0.01,
                                      noise=args.noise)
    scans = [seq.scan(k) for k in range(args.frames)]
    jc, tc = _small(jcfg)(), _small(tcfg)()
    with tempfile.TemporaryDirectory() as tmp:
        for stop in range(1, args.frames - 1):
            ckpt = os.path.join(tmp, f"jax_{stop}.npz")
            JaxFull(jc).run_chunked(scans, chunk=1, checkpoint_path=ckpt, checkpoint_every=1,
                                    stop_after=stop)
            starts = {
                "JAX": ckpt,
                # checkpoint leaves mapst_0..5: corner, corner mask, surf, surf
                # mask, correction q, correction t
                "JAX, surf map +1 ulp": _nudged(ckpt, "mapst_2", ckpt + ".surf.npz"),
                "JAX, correction t +1 ulp": _nudged(ckpt, "mapst_5", ckpt + ".corr.npz"),
            }
            runs = {name: JaxFull(jc).run_chunked(scans, chunk=1, checkpoint_path=path,
                                                  resume=True)
                    for name, path in starts.items()}
            runs["port"] = PortFull(tc, device="cpu").run_chunked(
                scans, chunk=1, checkpoint_path=ckpt, resume=True)
            odo0, map0 = runs["JAX"]
            for name, (odo, mapped) in runs.items():
                per_frame = np.abs(mapped.positions - map0.positions).max(axis=1)
                print(f"from the state after frame {stop}: {name}: mapped-position difference "
                      f"a frame (m) {[float(f'{d:.3g}') for d in per_frame]}, odometry "
                      f"{float(np.abs(odo.positions - odo0.positions).max()):.3g} m",
                      flush=True)


if __name__ == "__main__":
    main()
