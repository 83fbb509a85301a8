"""``scripts/bench_scaling_torch.py`` against ``scripts/bench_scaling.py`` on the CPU.

The port's ``main`` runs its fleets of one and two gloo ranks on the CPU
(``--reps 0``: one cold call a stage, two threads a rank), beside the JAX
script's ``main`` on the first two of conftest's eight virtual devices (one
timed call a stage). Each row must carry the JAX script's keys, with the
port's own beside them; the ranks of a fleet must agree, and each stage on
two ranks must give one rank's result: odometry and mapping bit for bit (each
rank sums its rows in float64 and the sums round to float32 after the
all-reduce, and a pair's 5-NN distance does not depend on the rank's block;
``tests/test_torch_parallel.py`` holds the sharded functions so), the BA
within ``BA_VS_1_RANK`` (its χ² and normal equations sum in float32 over the
rank's points first: measured 8.2e-8 here)."""

import importlib.util
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_VS_1_RANK = 1e-6
RANKS_AGREE = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows():
    """(the JAX script's rows on 1 and 2 devices, the port's on 1 and 2 ranks)."""
    port, jax_script = _script("bench_scaling_torch"), _script("bench_scaling")
    devices = jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "2")      # the rank processes' torch threads
    mp.setattr(jax, "devices", lambda *a: devices[:2])
    mp.setattr(sys, "argv", ["bench_scaling.py", "--reps", "1"])
    printed = []
    jax_script.print = lambda *a, **k: printed.append(" ".join(map(str, a)))
    try:
        with ThreadPoolExecutor(1) as ex:
            fleets = ex.submit(port.main, ["--device", "cpu", "--reps", "0"])
            jax_script.main()
            got = fleets.result()
    finally:
        mp.undo()
    return json.loads(printed[-1]), got


def test_rows_carry_the_jax_scripts_keys(rows):
    want, got = rows
    assert [r["devices"] for r in got] == [r["devices"] for r in want] == [1, 2]
    for w, g in zip(want, got):
        assert set(w) <= set(g), set(w) - set(g)
        assert g["backend"] == "gloo"
        for key in ("odometry_ms", "mapping_ms", "ba_ms", "ba_weak_ms", "odometry_eff",
                    "mapping_eff", "ba_eff"):
            assert np.isfinite(g[key]) and g[key] > 0, key


@pytest.mark.parametrize("stage,bound", [("odometry", 0.0), ("mapping", 0.0),
                                         ("ba", BA_VS_1_RANK)])
def test_two_ranks_give_one_ranks_result(rows, stage, bound):
    _, got = rows
    assert got[0][f"{stage}_vs_1_rank"] == 0.0
    assert got[1][f"{stage}_vs_1_rank"] <= bound, got[1]
    assert got[1]["ranks_agree"] <= RANKS_AGREE


def test_stages_did_work(rows):
    """Each stage moved its pose off the start: the fixtures are the JAX
    script's, so a stage that did no work would show here."""
    _, got = rows
    for r in got:
        assert np.linalg.norm(r["odometry_t"]) > 0.1
        assert np.linalg.norm(r["mapping_t"]) > 1e-4
        assert np.abs(np.subtract(r["ba_t"], r["ba_weak_t"])).max() > 0   # other points
