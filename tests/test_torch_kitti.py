"""The port's A.14 modules against the JAX package's, on the CPU: the KITTI
readers (``data/kitti.py``), the native scan reader
(``data/native_loader.py``), ``utils/profiler.StageTimer``,
``eval/plot.plot_trajectory`` and the runner ``scripts/run_kitti_torch.py``.

A synthetic sequence is written in the KITTI odometry layout (velodyne
``.bin`` files, ``times.txt``, ``calib.txt``, ``poses/00.txt`` and one
``image_0`` PNG), as ``tests/test_run_kitti.py`` and
``tests/test_native_loader.py`` write them. The readers must give the JAX
package's arrays bit for bit; the runner's trajectory on 3 frames, in
odometry and in mapping mode, must lie within 0.01 m of
``scripts/run_kitti.py``'s on the same files.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import kitti as jkitti
from lidar_visual_odometry_tpu.data import synthetic
from lidar_visual_odometry_tpu.data.native_loader import NativeScanReader as JaxReader
from lidar_visual_odometry_tpu_torch.data import kitti as tkitti
from lidar_visual_odometry_tpu_torch.data import native_loader
from lidar_visual_odometry_tpu_torch.eval import plot
from lidar_visual_odometry_tpu_torch.utils.profiler import StageTimer, block_until_ready

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 3
# velodyne → cam0 rotation of the z-forward synthetic camera (test_run_kitti.py)
TR_VC = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return write_kitti(tmp_path_factory.mktemp("kitti"))


def write_kitti(root):
    """The synthetic sequence in the KITTI odometry layout under ``root``."""
    seq_dir = root / "sequences" / "00"
    (seq_dir / "velodyne").mkdir(parents=True)
    (seq_dir / "image_0").mkdir()
    (root / "poses").mkdir()
    seq = synthetic.SyntheticSequence(n_frames=N_FRAMES, width=600, noise=0.005)
    rng = np.random.default_rng(0)
    poses = []
    for k in range(N_FRAMES):
        pts = seq.scan(k)
        refl = rng.uniform(size=(pts.shape[0], 1)).astype(np.float32)
        np.concatenate([pts, refl], axis=1).astype(np.float32).tofile(
            seq_dir / "velodyne" / f"{k:06d}.bin")
        R, t = seq.pose(k)
        T = np.eye(4)
        T[:3, :3] = R @ TR_VC.T         # poses/00.txt holds cam0 poses
        T[:3, 3] = t
        poses.append(T)
    np.savetxt(seq_dir / "times.txt", np.arange(N_FRAMES) * 0.1)
    with open(seq_dir / "calib.txt", "w") as f:
        P = "7.070912e+02 0 6.018873e+02 0 0 7.070912e+02 1.831104e+02 0 0 0 1 0"
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: {P}\n")
        f.write("Tr: " + " ".join(f"{v:g}" for v in np.hstack(
            [TR_VC, np.zeros((3, 1))]).reshape(-1)) + "\n")
    with open(root / "poses" / "00.txt", "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3].reshape(-1)) + "\n")
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (24, 40), dtype=np.uint8)).save(
        seq_dir / "image_0" / "000000.png")
    return root


def test_readers_match_jax(kitti_root):
    seq_dir = os.path.join(kitti_root, "sequences", "00")
    for fn, path in (("read_velodyne_bin", os.path.join(seq_dir, "velodyne", "000001.bin")),
                     ("read_times", os.path.join(seq_dir, "times.txt")),
                     ("read_poses", os.path.join(kitti_root, "poses", "00.txt")),
                     ("read_image_gray", os.path.join(seq_dir, "image_0", "000000.png"))):
        got, want = getattr(tkitti, fn)(path), getattr(jkitti, fn)(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)
    got = tkitti.read_calib(os.path.join(seq_dir, "calib.txt"))
    want = jkitti.read_calib(os.path.join(seq_dir, "calib.txt"))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_sequence_matches_jax(kitti_root):
    got = tkitti.KittiOdometrySequence(str(kitti_root), 0)
    want = jkitti.KittiOdometrySequence(str(kitti_root), 0)
    assert len(got) == len(want) == N_FRAMES
    np.testing.assert_array_equal(got.Tr, want.Tr)
    np.testing.assert_array_equal(got.P0, want.P0)
    for k in range(N_FRAMES):
        np.testing.assert_array_equal(got.scan(k), want.scan(k))
        np.testing.assert_array_equal(got.gt_pose_velodyne(k), want.gt_pose_velodyne(k))


def test_native_reader_matches_jax(kitti_root):
    """The port's reader, built into the port's ``_build/``, gives the JAX
    binding's padded arrays bit for bit, then None after the last file."""
    pattern = os.path.join(kitti_root, "sequences", "00", "velodyne", "%06ld.bin")
    with native_loader.NativeScanReader(pattern, N_FRAMES, capacity=65536, prefetch=2,
                                        threads=2) as got:
        mine = list(got)
        assert got.next() is None
    ref = JaxReader(pattern, N_FRAMES, capacity=65536, prefetch=2, threads=2)
    theirs = list(ref)
    ref.close()
    assert len(mine) == len(theirs) == N_FRAMES
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert str(native_loader._build()).startswith(str(native_loader._BUILD))
    with pytest.raises(FileNotFoundError):
        with native_loader.NativeScanReader(pattern, N_FRAMES + 1) as r:
            list(r)


def test_native_reader_needs_gxx(monkeypatch):
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_loader._build()


def test_stage_timer():
    timer = StageTimer(budget_ms=50.0)
    with timer.stage("fast"):
        pass
    with timer.stage("slow"):
        import time

        time.sleep(0.06)
    x = timer.time_blocked("blocked", lambda a: {"y": (a * 2,)}, torch.ones(3))
    assert torch.equal(x["y"][0], torch.full((3,), 2.0))
    s = timer.summary()
    assert s["fast"]["count"] == 1 and s["fast"]["over_budget"] == 0
    assert s["slow"]["over_budget"] == 1 and s["slow"]["mean_ms"] >= 60.0
    assert s["blocked"]["count"] == 1
    assert "slow" in timer.report() and len(timer.report().splitlines()) == 3
    assert block_until_ready([1, (torch.zeros(2),)]) is not None


def test_plot_trajectory(tmp_path):
    est = np.cumsum(np.ones((5, 3)), axis=0)
    out = plot.plot_trajectory(est, est + 0.1, str(tmp_path / "t.png"), title="t")
    assert os.path.getsize(out) > 1000
    out = plot.plot_trajectory(est, None, str(tmp_path / "e.png"))
    assert os.path.getsize(out) > 1000


def _run_script(path: str, argv: list[str]) -> dict:
    """A runner's ``main`` in this process: its last stdout line (the JSON
    report)."""
    spec = importlib.util.spec_from_file_location(f"_runner_{os.path.basename(path)[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    import sys

    argv0 = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("mode", [[], ["--mapping"]], ids=["odometry", "mapping"])
def test_runner_matches_the_jax_runner(kitti_root, tmp_path, mode):
    common = ["--root", str(kitti_root), "--sequence", "0", "--chunk", "2", *mode]
    ours = _run_script(os.path.join(REPO, "scripts", "run_kitti_torch.py"),
                       [*common, "--out", str(tmp_path / "port.txt"), "--device", "cpu"])
    theirs = _run_script(os.path.join(REPO, "scripts", "run_kitti.py"),
                         [*common, "--out", str(tmp_path / "jax.txt"), "--cpu"])
    assert ours.keys() == theirs.keys()
    assert ours["frames"] == theirs["frames"] == N_FRAMES
    assert ours["mode"] == theirs["mode"] == ("mapping" if mode else "odometry")
    got = np.loadtxt(tmp_path / "port.txt").reshape(-1, 3, 4)
    want = np.loadtxt(tmp_path / "jax.txt").reshape(-1, 3, 4)
    assert got.shape == want.shape == (N_FRAMES, 3, 4)
    np.testing.assert_allclose(got[:, :, 3], want[:, :, 3], atol=0.01)
    assert abs(ours["ate_rmse_m"] - theirs["ate_rmse_m"]) < 0.01
