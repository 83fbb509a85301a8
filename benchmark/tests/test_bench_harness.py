"""The benchmark's harness on the CPU: data found by name, the contract's
shape, the imports it forbids, no fallback to the CPU, the arithmetic of the
trace, and whole small runs, sound and with faults planted under the timed
path. Run: ``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, roofline, spec, trace
from benchmark.tests.small import ROOT, make_root

BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "lidar_visual_odometry_tpu"}


def _tree_hash(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_cells_configs_traffic_metrics_found_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(BENCH, w["name"])
        cfg = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
        assert (ROOT / "benchmark" / "entries" / f"{cfg['entry']}.py").exists()
        assert traffic["streams"] >= 1 and cfg["limits"]
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert spec.config(c["name"]) == json.loads((ROOT / c["file"]).read_text())


def test_added_files_are_picked_up_with_no_edit(tmp_path):
    before = _tree_hash(ROOT / "benchmark")
    root = make_root(tmp_path)
    (root / "benchmark" / "metrics" / "probe_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "probe_metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "frames_per_s", "workloads": ["small_odom"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    here = root / "benchmark"
    bench = spec.benchmark(root)
    cell = spec.cell(bench, "small_odom")
    assert spec.config(cell["config"], here)["settings"]["lidar"]["azimuth_bins"] == 512
    assert spec.traffic(cell["traffic"], here)["streams"] == 2
    names = [m["name"] for m in spec.metrics_of(bench, "small_odom", "per_layer")]
    assert "probe_metric" in names and "map_rounds_per_frame" not in names
    assert spec.reader("probe_metric", here)({}) == 42.0
    for file in before:       # every file that was there is unchanged
        assert _tree_hash(here).get(file) == before[file], file


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 + 60 * 2
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "numpy", "torch"}, (path, tops)


def test_run_fails_without_a_card():
    """No card: a non-zero exit and no result, never a run on the CPU."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "odom_city_x8",
                           "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_union_of_intervals():
    busy, gaps = trace.union(np.array([0, 5, 6, 20]), np.array([4, 8, 7, 30]), 2, 25)
    assert busy == (4 - 2) + (8 - 5) + (25 - 20)
    assert gaps == [(4, 5), (8, 20)]


def test_roofline_share_counts_shapes_not_time():
    s = spec.config("aloam_hdl64_slam")["settings"]
    calls = roofline.associate_calls(s)
    b0 = roofline.bound_s(*calls[0], "NVIDIA H100 80GB HBM3")
    b1 = roofline.bound_s(*calls[1], "NVIDIA H100 80GB HBM3")
    assert roofline.share_pct(calls, 4, 1, 2 * (b0 + b1), "NVIDIA H100 80GB HBM3") == \
        pytest.approx(100.0)
    assert roofline.share_pct(calls, 4, 1, 1.0, "some other card") is None
    assert roofline.share_pct(calls, 0, 1, 1.0, "NVIDIA H100 80GB HBM3") is None


def _stream(gaps: list, n_frames: int = 64) -> dict:
    """A worker's result with one sound sequence and these checked gaps."""
    return {"frames_in_sequence": n_frames,
            "records": [{"frames": n_frames, "finite": True, "done": 0}],
            "checks": {"frames_ok": True, "odom_dt_m": gaps}}


@pytest.mark.parametrize("k", [0, 2, 3, 8])
def test_one_frame_altered_in_a_few_of_the_cells_streams(k):
    """One frame's motion moved 2 cm in k of the cell's streams, as when the
    altered frame is among the checked frames of only some streams: the
    median over the streams misses it where k is under half, the
    second-widest stream catches it from two streams on."""
    cfg = spec.config("aloam_hdl64_odom", ROOT / "benchmark")
    n = spec.traffic("city_x8", ROOT / "benchmark")["streams"]
    sound = [1e-3] * 31 + [2e-3]
    results = [_stream(sound[:5] + [0.02 + 1e-3] + sound[6:] if i < k else sound)
               for i in range(n)]
    limits = {k: v for k, v in cfg["limits"].items() if k.partition(".")[0] == "odom_dt_m"}
    median_only = {"odom_dt_m": limits["odom_dt_m"]}
    assert harness.judge(results, median_only)[0] is (k < n // 2)
    correct, _attempted, failed, checks, _gaps = harness.judge(results, limits)
    assert "odom_dt_m.second" in checks
    assert correct is (k == 0)
    assert failed == (k if k >= 2 else 0)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def test_small_run_on_the_cpu_is_correct(small_root):
    out, lines, info = harness.run_cell("small_odom", 2147483690, 1.0, False, device="cpu",
                                        root=small_root, streams=1, check_frames=5)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 6
    assert list(out)[-1] == "checks" and lines[0].startswith("check odom_dt_m")
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(small_root, fault):
    out, _lines, _info = harness.run_cell(
        "small_odom", 2147483690, 1.0, False, device="cpu", root=small_root, streams=1,
        check_frames=5, fault=f"benchmark.tests.faults:{fault}")
    assert out["correct"] is False
    assert out["failed"] > 0


def test_altered_frame_checked_by_three_of_eight_streams_is_not_correct(small_root):
    """The ``altered`` fault at the cell's stream count and the cell's share
    of checked frames (half): on this seed the altered frame is among the
    checked frames of 3 of the 8 streams, so the median over the streams
    stays under its limit and the second-widest stream fails the run."""
    from benchmark.worker import check_frames
    from benchmark.tests.faults import ALTERED_FRAME

    n = spec.traffic("city_x8", ROOT / "benchmark")["streams"]
    seed, frames = 2147483691, json.loads((small_root / "benchmark" / "traffic" / "small.json")
                                          .read_text())["frames_per_sequence"]
    hit = sum(ALTERED_FRAME in check_frames(seed, s, frames, frames // 2) for s in range(n))
    assert hit == 3
    out, _lines, _info = harness.run_cell(
        "small_odom", seed, 1.0, False, device="cpu", root=small_root, streams=n,
        check_frames=frames // 2, fault="benchmark.tests.faults:altered")
    checks = out["checks"]
    assert checks["odom_dt_m"]["value"] <= checks["odom_dt_m"]["limit"]
    assert checks["odom_dt_m.second"]["value"] > checks["odom_dt_m.second"]["limit"]
    assert out["correct"] is False and out["failed"] == 3
