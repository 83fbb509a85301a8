"""``scripts/stress_long_torch.py`` against ``scripts/stress_long.py``, both in
this process on the CPU.

Each script's ``main`` runs its drive (``--laps 1 --leg 6 --turn 14``, the
lap of ``chip_smoke.py`` phase 12) cut to its first ``FRAMES`` frames, at
``WIDTH`` azimuth samples, in chunks of ``CHUNK`` (so the mid-run snapshot
falls after the first chunk and the second resumes from it), with its
package's ``SystemConfig`` cut to the small mapping configuration of
``tests/test_torch_eval_regimes.py`` (2048-point map caps, which these frames
fill, so eviction runs; the dense map search on both sides). The caches go to
a temporary directory, where the port's script reads the scans the JAX script
rendered. Each package's ``slam_chunk_polar`` records what it returns. The
reports must carry the same keys, the same frame count and a bit-exact
resume; every odometry position must lie within 2e-3 m of the JAX script's
and every mapped position within 2e-2 m (the eval test's bounds).

The drive stops before the U-turn. Into it, with the map full, rounding
alone moves the JAX package's own mapped positions by more than that bound:
cut to 9 frames in chunks of 4, the JAX run resumed from its first chunk's
state with the map's points one ulp up moves its mapped positions by up to
4.1e-2 m at frames 7-8 (``python tools/mapping_step_diff.py --stress 9``),
and the port, 2.4e-2 m from JAX there, lies within that spread."""

import json
import os

import numpy as np

import lidar_visual_odometry_tpu.models.device_mapping as jdm
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.data import synthetic as tsyn
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from test_torch_eval_regimes import _script as load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, WIDTH, CHUNK = 5, 600, 2
DRIVE = ["--laps", "1", "--leg", "6", "--turn", "14", "--width", str(WIDTH),
         "--chunk", str(CHUNK)]
POS_TOL_M = {"odometry": 2e-3, "mapped": 2e-2}


def cut_drive(monkeypatch, syn, frames: int = FRAMES) -> None:
    """``syn.PiecewiseArcSequence`` cut to its first ``frames`` frames."""
    full = syn.PiecewiseArcSequence

    class Cut(full):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.n_frames = min(self.n_frames, frames)

    monkeypatch.setattr(syn, "PiecewiseArcSequence", Cut)


def small(m, **forced):
    """``m.SystemConfig`` cut to the small mapping configuration, the
    caller's keywords on top and ``forced`` on top of those."""
    make = m.SystemConfig

    def config(**kw):
        return make(**{**dict(lidar=m.LidarConfig(azimuth_bins=1024),
                              odometry=m.OdometryConfig(outer_iters=4),
                              mapping=m.MappingConfig(outer_iters=2, gn_iters=4,
                                                      corner_slot=1024, surf_slot=1024,
                                                      map_corner_cap=2048, map_surf_cap=2048,
                                                      windowed_nn=False)),
                          **kw, **forced})
    return config


def last_line(capsys) -> str:
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")][-1]


def recording(fn, calls):
    """``fn`` that appends what it returns to ``calls``."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out
    return wrapped


def test_stress_long_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    (tmp_path / "scripts").mkdir()
    cut_drive(monkeypatch, jsyn)
    cut_drive(monkeypatch, tsyn)

    ref = load_script("stress_long")
    monkeypatch.setattr(ref, "__file__", str(tmp_path / "scripts" / "stress_long.py"))
    monkeypatch.setattr(jcfg, "SystemConfig", small(jcfg))
    want_calls, got_calls = [], []
    monkeypatch.setattr(jdm, "slam_chunk_polar", recording(jdm.slam_chunk_polar, want_calls))
    monkeypatch.setattr("sys.argv", ["stress_long.py", *DRIVE])
    ref.main()
    want = json.loads(last_line(capsys))

    port = load_script("stress_long_torch")
    monkeypatch.setattr(port, "ROOT", str(tmp_path))
    monkeypatch.setattr(port, "SystemConfig", small(tcfg))
    monkeypatch.setattr(port.dm, "slam_chunk_polar",
                        recording(port.dm.slam_chunk_polar, got_calls))
    got = port.main([*DRIVE, "--device", "cpu"])
    assert last_line(capsys) == json.dumps(got)

    assert list(got) == list(want)
    assert got["frames"] == want["frames"] == FRAMES
    assert got["resume_bit_exact"] is want["resume_bit_exact"] is True
    assert got["resume_max_diff"] == 0.0
    # the cut drive fills the small caps, so the map evicts
    assert got["map_occupancy_corner"] == want["map_occupancy_corner"] == 1.0
    # the caches and the snapshot went to the temporary directory
    assert sorted(p.name for p in tmp_path.glob(".stress_*.npz")) == [
        ".stress_ckpt.npz", f".stress_scans_1x6_14_{WIDTH}.npz"]
    assert not os.path.exists(os.path.join(ROOT, f".stress_scans_1x6_14_{WIDTH}.npz"))
    # the uninterrupted run's chunks: odometry and mapped poses
    n_chunks = len(range(1, FRAMES, CHUNK))
    assert len(got_calls) == len(want_calls)
    for g, w in zip(got_calls[:n_chunks], want_calls[:n_chunks]):
        for name, gp, wp in (("odometry", g[2], w[2]), ("mapped", g[3], w[3])):
            diff = float(np.abs(gp.t.numpy() - np.asarray(wp.t)).max())
            assert diff <= POS_TOL_M[name], (name, diff)
