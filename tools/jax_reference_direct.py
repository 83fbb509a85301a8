"""Direct-VO ATE of the JAX package on the bench's corridor, on the CPU.

The PyTorch port's ``chip_smoke.py`` phase 6 gates its ``ate_direct`` on this
number: the port must reach the JAX reference's accuracy on the same 48-frame
synthetic sequence and camera (``bench.py`` mode 4, "direct VO": clouds from
``CamLidarPipeline(cfg)._cam_cloud`` of each scan,
``DirectVOChunked(cam, cfg.visual, point_cap=2048).run_chunked(images, clouds,
masks, chunk=8)``, the camera poses mapped to the lidar frame, ATE against the
ground truth relative to frame 0 with ``align=False``), with ``bench.py``'s
``_config()`` (``tools/jax_reference_camlidar.py``'s ``bench_config``).

On the CPU the JAX package samples by float32 gathers, as the port does; the
TPU's one-hot MXU sampler (``ba_sample_precision="bf16"``) is not the gate.
The scans are rendered one after another: numpy's OpenBLAS (0.3.27) called
from several threads at once has returned a scan with points metres off, in
one try of three. The run is timed after a warm
run. For information it also runs the JAX package's per-frame host loop
(``DirectVO.process``, one jitted tracker and BA call at a time) on the
chunk's decoded inputs: the same algorithm under other fusion boundaries, so
other float32 rounding. Takes about two and a half minutes, most of it
rendering. Writes ``tools/jax_reference_direct.json`` (the ATE, the mapped
positions and quaternions, the host loop's ATE and positions, and a sha256 of
the inputs: images, clouds and masks), which ``chip_smoke.py`` reads, and
prints it.

    python tools/jax_reference_direct.py [--frames 49] [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jax_reference_camlidar import ate_visual, bench_config, render  # noqa: E402
from lidar_visual_odometry_tpu.data import synthetic  # noqa: E402
from lidar_visual_odometry_tpu.models.cam_lidar_pipeline import (  # noqa: E402
    CamLidarPipeline, _map_cam_poses_to_lidar,
)
from lidar_visual_odometry_tpu.models.direct_vo import DirectVO, DirectVOChunked  # noqa: E402
from lidar_visual_odometry_tpu.models.lidar_odometry import (  # noqa: E402
    QUANT_OFFSET, QUANT_SCALE,
)
from lidar_visual_odometry_tpu.ops import camera as cam_ops  # noqa: E402


def host_loop_positions(cam, cfg, images, clouds, masks):
    """``DirectVO.process`` frame by frame on what the chunk decodes on the
    device: frame 0 as given, later frames from uint8 images and uint16
    codes. Returns the camera positions (N, 3) and quaternions (N, 4)."""
    vo = DirectVO(cam, cfg.visual, point_cap=2048)
    qs, ts = [], []
    for k, (im, cloud, mask) in enumerate(zip(images, clouds, masks)):
        img, pts = np.asarray(im, np.float32), np.asarray(cloud)
        if k:
            img8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            img = jnp.asarray(img8).astype(jnp.float32) * (1.0 / 255.0)
            codes = (np.clip((pts - QUANT_OFFSET) / QUANT_SCALE, 0.0, 65535.0)
                     + 0.5).astype(np.uint16)
            pts = jnp.asarray(codes).astype(jnp.float32) * QUANT_SCALE + QUANT_OFFSET
        pose = vo.process(jnp.asarray(img), jnp.asarray(pts), jnp.asarray(mask))
        qs.append(np.asarray(pose.q))
        ts.append(np.asarray(pose.t))
    return np.stack(ts), np.stack(qs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "jax_reference_direct.json"))
    args = ap.parse_args()

    n = args.frames
    seq = synthetic.SyntheticSequence(n_frames=n, width=1800, speed=1.0, yaw_rate=0.004,
                                      noise=0.01)
    t0 = time.time()
    scans = [seq.scan(k) for k in range(n)]
    images = [render(seq, k) for k in range(n)]
    render_s = time.time() - t0
    cfg = bench_config()
    clp = CamLidarPipeline(cfg)
    clouds, masks = zip(*(clp._cam_cloud(np.asarray(s)[:, :3]) for s in scans))
    digest = hashlib.sha256()
    for arr in (*images, *clouds, *masks):
        digest.update(np.ascontiguousarray(arr).tobytes())
    cam = cam_ops.Pinhole.from_config(cfg.camera)
    dvo = DirectVOChunked(cam, cfg.visual, point_cap=2048)
    t0 = time.time()
    dvo.run_chunked(images, clouds, masks, chunk=8)
    warm_s = time.time() - t0
    ts, qs, wall = dvo.run_chunked(images, clouds, masks, chunk=8)
    vq, vt = _map_cam_poses_to_lidar(jnp.asarray(qs), jnp.asarray(ts), clp.T_lidar_cam,
                                     clp.T_cam_lidar)
    positions, quats = np.asarray(vt), np.asarray(vq)
    host_t, host_q = host_loop_positions(cam, cfg, images, clouds, masks)
    _, host_vt = _map_cam_poses_to_lidar(jnp.asarray(host_q), jnp.asarray(host_t),
                                         clp.T_lidar_cam, clp.T_cam_lidar)
    host_positions = np.asarray(host_vt)
    out = {
        "backend": jax.default_backend(),
        "frames": n,
        "ate_direct_m": ate_visual(seq, positions, n),
        "inputs_sha256": digest.hexdigest(),
        "render_s": render_s,
        "warm_run_s": warm_s,
        "run_s": wall,
        "positions": positions.tolist(),
        "quats": quats.tolist(),
        "host_loop_ate_direct_m": ate_visual(seq, host_positions, n),
        "host_loop_largest_position_difference_m": float(
            np.abs(host_positions - positions).max()),
        "host_loop_positions": host_positions.tolist(),
    }
    text = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
