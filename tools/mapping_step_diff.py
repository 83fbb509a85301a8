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

``--stress N`` does the same for ``tests/test_torch_stress_long.py``: the JAX
``scripts/stress_long.py`` on its lap cut to N frames (the test's small
configuration, whose 2048-point caps fill, so the map evicts), in chunks of
4; then its second chunk again from the first chunk's state with the map's
points moved one ulp up, one ulp down, and with the world translation moved
one ulp up and down: how far rounding alone moves JAX's own mapped positions
on the drive (a frame, from the first unnudged frame of the chunk).

    python tools/mapping_step_diff.py [--frames 4] [--noise 0.05] [--stress 9]
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


def stress(frames: int) -> None:
    import jax.numpy as jnp
    import pytest

    import lidar_visual_odometry_tpu.models.device_mapping as jdm
    import test_torch_stress_long as T

    mp = pytest.MonkeyPatch()
    calls = []
    slam = jdm.slam_chunk_polar

    def recording(*a, **k):
        out = slam(*a, **k)
        calls.append((a, k, out))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        os.mkdir(os.path.join(tmp, "scripts"))
        T.cut_drive(mp, synthetic, frames)
        script = T.load_script("stress_long")
        mp.setattr(script, "__file__", os.path.join(tmp, "scripts", "stress_long.py"))
        mp.setattr(jcfg, "SystemConfig", T.small(jcfg))
        mp.setattr(jdm, "slam_chunk_polar", recording)
        mp.setattr("sys.argv", ["stress_long.py", "--laps", "1", "--leg", "6", "--turn", "14",
                                "--width", str(T.WIDTH), "--chunk", "4", "--no-resume-check"])
        script.main()
        mp.undo()
    a, k, out = calls[1]
    base = np.asarray(out[3].t)
    odo, mst = a[0], a[1]
    for direction, sign in ((np.inf, "+"), (-np.inf, "-")):
        def ulp(x):
            return jnp.asarray(np.nextafter(np.asarray(x), np.float32(direction))
                               .astype(np.float32))
        for name, o, m in (("map points", odo, mst._replace(corner=ulp(mst.corner),
                                                            surf=ulp(mst.surf))),
                           ("world translation", odo._replace(
                               pose_w=odo.pose_w._replace(t=ulp(odo.pose_w.t))), mst)):
            moved = np.abs(np.asarray(slam(o, m, *a[2:], **k)[3].t) - base).max(axis=1)
            print(f"stress drive, frames {k['start_idx']}-"
                  f"{k['start_idx'] + len(base) - 1}, JAX from the state after the first "
                  f"chunk, {name} {sign}1 ulp: mapped-position difference a frame (m) "
                  f"{[float(f'{d:.3g}') for d in moved]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--stress", type=int, default=0, metavar="N",
                    help="instead: the stress drive cut to N frames")
    args = ap.parse_args()
    if args.stress:
        stress(args.stress)
        return
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
