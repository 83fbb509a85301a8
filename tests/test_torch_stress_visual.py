"""``scripts/stress_visual_torch.py`` against ``scripts/stress_visual.py``, both
in this process on the CPU.

Each script's ``main`` runs its drive (``--laps 1 --leg 6 --turn 14``, the
lap of ``chip_smoke.py`` phase 12) cut to its first ``FRAMES`` frames, at
``WIDTH`` azimuth samples, in chunks of ``CHUNK`` (the drive and its cut of
``tests/test_torch_stress_long.py``): the coupled cam-lidar run
with mapping and the direct-VO run, each warm, timed, stopped after frame
``FRAMES // 2`` and resumed. Both packages run the camera configuration of
``tests/test_torch_camlidar.py`` (a 320 x 96 camera, 128 feature slots, 4096
depth points) with the small mapping configuration of
``tests/test_torch_stress_long.py``, the JAX tracker's levels on the Pallas
``lk_level`` in interpret mode (the TPU's semantics, which the port's kernel
K6 follows). The caches go to a temporary directory, where the port's script
reads the scans and images the JAX script rendered. Each package's
``CamLidarPipeline`` records what its ``run_chunked`` returns. The reports
must carry the same keys and frame count and both resumes must be bit-exact
in both scripts; the coupled run's lidar positions must lie within 2e-3 m of
the JAX run's and its mapped positions within 2e-2 m (the bounds of
``tests/test_torch_eval_regimes.py``)."""

import json
import os

import numpy as np

import lidar_visual_odometry_tpu.models.cam_lidar_pipeline as jcl
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.data import synthetic as tsyn
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_camlidar import CAM, EXT, VIS
from test_torch_eval_regimes import _recording as recording
from test_torch_stress_long import (DRIVE, FRAMES, POS_TOL_M, ROOT, WIDTH, cut_drive,
                                    load_script, small)
from test_torch_visual import lk_through_pallas_interpret

def last_line(capsys) -> str:
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")][-1]


def test_stress_visual_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    (tmp_path / "scripts").mkdir()
    cut_drive(monkeypatch, jsyn)
    cut_drive(monkeypatch, tsyn)

    ref = load_script("stress_visual")
    monkeypatch.setattr(ref, "__file__", str(tmp_path / "scripts" / "stress_visual.py"))
    monkeypatch.setattr(ref, "CAM", CAM)
    monkeypatch.setattr(jcfg, "SystemConfig", small(jcfg, visual=jcfg.VisualConfig(**VIS)))
    want_runs, got_runs = [], []
    monkeypatch.setattr(jcl, "CamLidarPipeline", recording(jcl.CamLidarPipeline, want_runs))
    monkeypatch.setattr("sys.argv", ["stress_visual.py", *DRIVE])
    with lk_through_pallas_interpret():
        ref.main()
    want = json.loads(last_line(capsys))

    port = load_script("stress_visual_torch")
    monkeypatch.setattr(port, "ROOT", str(tmp_path))
    monkeypatch.setattr(port, "CAM", CAM)
    monkeypatch.setattr(port, "camlidar_config", lambda: small(
        tcfg, visual=tcfg.VisualConfig(**VIS))(camera=tcfg.CameraConfig(**CAM),
                                               extrinsic=tcfg.ExtrinsicConfig(matrix=EXT)))
    monkeypatch.setattr(port, "CamLidarPipeline", recording(port.CamLidarPipeline, got_runs))
    got = port.main([*DRIVE, "--device", "cpu"])
    assert last_line(capsys) == json.dumps(got)

    assert list(got) == list(want)
    assert got["frames"] == want["frames"] == FRAMES
    for key in ("coupled_resume_bit_exact", "direct_resume_bit_exact"):
        assert got[key] is want[key] is True, key
    # the caches went to the temporary directory, the checkpoints were removed
    assert sorted(p.name for p in tmp_path.glob(".stress_*")) == [
        f".stress_imgs_1x6_14_{WIDTH}_{CAM['width']}x{CAM['height']}.npz",
        f".stress_scans_1x6_14_{WIDTH}.npz"]
    assert not os.path.exists(os.path.join(ROOT, f".stress_scans_1x6_14_{WIDTH}.npz"))
    # the warm run of each: the coupled lidar and mapped trajectories
    g, w = got_runs[0], want_runs[0]
    for name, key in (("odometry", "lidar_positions"), ("mapped", "mapped_positions")):
        gp, wp = getattr(g, key), np.asarray(getattr(w, key))
        assert gp.shape == wp.shape == (FRAMES, 3)
        diff = float(np.abs(gp - wp).max())
        assert diff <= POS_TOL_M[name], (name, diff)
