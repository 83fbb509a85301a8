"""``scripts/diag_visual_torch.py`` against ``scripts/diag_visual.py``, both in
this process on the CPU.

Each script's ``run_pass`` runs the ``base`` and ``gt_both`` passes over the
bench corridor's first ``FRAMES`` frames (rendered once, by the port's
script, into a temporary cache), the JAX tracker's levels on
``pallas_lk.lk_level`` in interpret mode (the kernel's semantics, which K6
reproduces). The per-frame stats must carry the same keys and frame for
frame the counts (tracked, lidar-depth, triangulated, with depth, epipolar
rows) within ``COUNT_MARGIN``; the relative-pose errors ``dt_*`` and the ATE
must agree within ``DT_TOL_M`` and ``ATE_TOL_M``.

Why those bounds. ``gt_both`` feeds both solves the exact tracks and depths
of the ground truth where it has them: the counts are equal, the steps lie
within 6.1e-6 m and the ATEs 1.7e-6 m apart (measured). ``base`` keeps the
estimated tracks and lidar depths. ``associate_depth``'s determinant cancels
heavily and the packages round it otherwise (the port as the operations are
written, XLA with fused multiply-adds): frame 1's step already differs by
8.6e-4 m laterally. At frame 3 one track whose ok flag a one-ulp nudge flips
in either package (``tools/camera_step_diff.py``'s sensitive features) ends
on one side only; the tables then differ, and the depth gates with them (up
to 3 rows at frame 4). Measured: the ATEs 4.5e-4 m apart. The bounds are
the camera step gate of ``chip_smoke.py`` (2e-3 m) and a margin of 4 rows a
count."""

import importlib.util
import os

import numpy as np
import pytest

from lidar_visual_odometry_tpu.ops import camera as jcam
from lidar_visual_odometry_tpu_torch.ops import camera as tcam
from lidar_visual_odometry_tpu_torch.utils.bench_config import camlidar_config
from test_torch_visual import lk_through_pallas_interpret

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 5
PASSES = ("base", "gt_both")
COUNTS = ("n_trk", "n_lidar", "n_tri", "n_depth", "n_epi")
COUNT_MARGIN = {"base": 4, "gt_both": 0}
DT_TOL_M = {"base": 2e-3, "gt_both": 1e-4}
ATE_TOL_M = {"base": 2e-3, "gt_both": 1e-4}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each pass of both scripts on the same inputs: {mode: (JAX, port)},
    each (ATE, stats)."""
    port, jax_script = _script("diag_visual_torch"), _script("diag_visual")
    port.ROOT = str(tmp_path_factory.mktemp("diag"))
    seq = port.corridor()
    scans, images, depths = port.load_or_render(seq, FRAMES)
    jcfg = jax_script.bench._config()
    tcfg = camlidar_config()
    out = {}
    for mode in PASSES:
        with lk_through_pallas_interpret():
            want = jax_script.run_pass(mode, scans, images, depths, seq, jcfg,
                                       jcam.Pinhole.from_config(jcfg.camera), FRAMES,
                                       verbose=False)
        got = port.run_pass(mode, scans, images, depths, seq, tcfg,
                            tcam.Pinhole.from_config(tcfg.camera, "cpu"), FRAMES, "cpu",
                            verbose=False)
        out[mode] = want, got
    return out


@pytest.mark.parametrize("mode", PASSES)
def test_counts_match(runs, mode):
    (_, want), (_, got) = runs[mode]
    assert len(got) == len(want) == FRAMES - 1
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        assert g["k"] == w["k"]
        apart = {c: abs(g[c] - w[c]) for c in COUNTS}
        assert max(apart.values()) <= COUNT_MARGIN[mode], (g["k"], apart)


@pytest.mark.parametrize("mode", PASSES)
def test_pose_errors_match(runs, mode):
    (want_ate, want), (got_ate, got) = runs[mode]
    for w, g in zip(want, got):
        for key in ("dt_fwd", "dt_lat", "dt_vert"):
            assert abs(g[key] - w[key]) <= DT_TOL_M[mode], (g["k"], key, g[key], w[key])
    assert abs(got_ate - want_ate) <= ATE_TOL_M[mode], (got_ate, want_ate)
    assert np.isfinite(got_ate)
