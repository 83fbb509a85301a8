"""``scripts/eval_regimes_torch.py`` against ``scripts/eval_regimes.py``, both
in this process on the CPU.

Each script's ``main`` runs its lidar rows (``FullPipeline.run_chunked(scans,
chunk=8)`` a regime, the ``"uint16"`` ingest) with its package's synthetic
module cut to tiny regimes (every sequence to its first ``FRAMES`` frames at
``WIDTH`` azimuth samples, the S-curve to legs of ``LEG`` frames, so that its
turn reverses) and its ``SystemConfig`` to the small mapping configuration of
``tests/test_torch_drivers.py``, with the dense map search on both sides
(``windowed_nn=False``: on the CPU the JAX package always searches densely).
The caches go to a temporary directory, where the port's script reads the
scans the JAX script rendered (the two packages render the same bits). Each
script's ``FullPipeline`` records what its ``run_chunked`` returns. The rows
must carry the same keys, regimes and frame counts; every odometry position
of every regime must lie within 2e-3 m of the JAX script's (the bound the
driver tests hold lidar positions to; 6.8e-4 m measured), every mapped
position within 2e-2 m: 2.3e-3 to 4.0e-3 m measured on the three regimes
with 1 cm noise, 1.25e-2 m on the high-noise one, where the JAX package's
own mapped positions move by 1.1e-2 m within two frames when its map moves
by one ulp (``tools/mapping_step_diff.py``). The four JAX regimes
share one compilation: the JAX package pads every chunk to 8 frames."""

import importlib.util
import json
import os
from unittest import mock

import numpy as np

import lidar_visual_odometry_tpu.data as jdata
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu.models import pipeline as jpipe
from lidar_visual_odometry_tpu.utils import config as jcfg
from lidar_visual_odometry_tpu_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, WIDTH, LEG = 4, 600, 2
POS_TOL_M = {"odometry": 2e-3, "mapped": 2e-2}
ARGV = ["--frames", str(FRAMES), "--width", str(WIDTH)]


class _Tiny:
    """A package's ``synthetic`` module whose sequences are cut short."""

    def __init__(self, mod):
        self._mod = mod
        tiny = self

        class PiecewiseArcSequence:
            @staticmethod
            def s_curve(leg, **kw):
                return mod.PiecewiseArcSequence.s_curve(leg=LEG, **kw)

            @staticmethod
            def out_and_back(**kw):
                return tiny._cut(mod.PiecewiseArcSequence.out_and_back(**kw))

        self.PiecewiseArcSequence = PiecewiseArcSequence

    def __getattr__(self, name):
        return getattr(self._mod, name)

    @staticmethod
    def _cut(seq):
        seq.n_frames = min(seq.n_frames, FRAMES)
        return seq

    def SyntheticSequence(self, **kw):
        return self._cut(self._mod.SyntheticSequence(**kw))


def _small(m):
    make = m.SystemConfig

    def small():
        return make(lidar=m.LidarConfig(azimuth_bins=1024),
                    odometry=m.OdometryConfig(outer_iters=4),
                    mapping=m.MappingConfig(outer_iters=2, gn_iters=4, corner_slot=1024,
                                            surf_slot=1024, map_corner_cap=2048,
                                            map_surf_cap=2048, windowed_nn=False))
    return small


def _recording(cls, runs):
    """``cls`` whose ``run_chunked`` appends its (odometry, mapped) results
    to ``runs``."""
    class Recording(cls):
        def run_chunked(self, *args, **kwargs):
            out = super().run_chunked(*args, **kwargs)
            runs.append(out)
            return out
    return Recording


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):   # the port's script pins BLAS threads on import
        spec.loader.exec_module(mod)
    return mod


def _table(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return json.loads(lines[-1])["table"]


def test_lidar_rows_match_the_jax_script(tmp_path, monkeypatch, capsys):
    (tmp_path / "scripts").mkdir()
    ref = _script("eval_regimes")
    monkeypatch.setattr(ref, "__file__", str(tmp_path / "scripts" / "eval_regimes.py"))
    monkeypatch.setattr(jdata, "synthetic", _Tiny(jsyn))
    monkeypatch.setattr(jcfg, "SystemConfig", _small(jcfg))
    want_runs, got_runs = [], []
    monkeypatch.setattr(jpipe, "FullPipeline", _recording(jpipe.FullPipeline, want_runs))
    monkeypatch.setattr("sys.argv", ["eval_regimes.py", *ARGV])
    ref.main()
    want = _table(capsys)

    port = _script("eval_regimes_torch")
    monkeypatch.setattr(port, "ROOT", str(tmp_path))
    monkeypatch.setattr(port, "synthetic", _Tiny(port.synthetic))
    monkeypatch.setattr(port, "SystemConfig", _small(tcfg))
    monkeypatch.setattr(port, "FullPipeline", _recording(port.FullPipeline, got_runs))
    port.main([*ARGV, "--device", "cpu"])
    got = _table(capsys)

    assert [r["regime"] for r in got] == [r["regime"] for r in want] == [
        f"corridor_{FRAMES}f", "rotation_heavy", "revisit_out_and_back", "high_noise"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["frames"] == w["frames"]
    assert len(got_runs) == len(want_runs) == len(got)
    for row, g, w in zip(got, got_runs, want_runs):
        for name, gr, wr in zip(("odometry", "mapped"), g, w):
            assert gr.positions.shape == wr.positions.shape == (row["frames"], 3)
            diff = float(np.abs(gr.positions - np.asarray(wr.positions)).max())
            assert diff <= POS_TOL_M[name], (row["regime"], name, diff)
