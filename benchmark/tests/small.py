"""A checkout-shaped directory for CPU tests: the benchmark's files with a
small cell added as data (a 512-column grid, short sequences, two streams),
the program linked in. Shapes shrink only in these tests; the cells the
benchmark runs keep their configuration's sizes."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def small_config(name: str) -> dict:
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c["settings"]["lidar"].update(azimuth_bins=512, max_less_flat=64 * 128)
    if "mapping" in c["settings"]:
        c["settings"]["mapping"].update(corner_slot=1024, surf_slot=1024,
                                        map_corner_cap=4096, map_surf_cap=8192)
    c["run"]["capacity"] = 32768
    c["run"]["chunk"] = 4
    return c


def small_traffic() -> dict:
    with open(ROOT / "benchmark" / "traffic" / "city_x8.json") as f:
        t = json.load(f)
    t["streams"] = 2
    t["frames_per_sequence"] = 6
    t["sensor"]["azimuth_steps"] = 450
    return t


def make_root(tmp: Path, entries=("odom", "slam")) -> Path:
    """tmp/ holding BENCHMARK.json with the small cells ``small_<entry>``,
    a copy of benchmark/ with their files, and links to the program."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("lidar_visual_odometry_tpu_torch", "native"):
        (tmp / name).symlink_to(ROOT / name)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for e in entries:
        cfg = small_config(f"aloam_hdl64_{e}")
        (tmp / "benchmark" / "configs" / f"small_{e}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": f"small_{e}", "source": "test",
                                 "file": f"benchmark/configs/small_{e}.json",
                                 "reduced": ["azimuth_bins"], "why": "test"})
        bench["workloads"].append({"name": f"small_{e}", "config": f"small_{e}",
                                   "traffic": "small", "chips": 1, "why": "test"})
    (tmp / "benchmark" / "traffic" / "small.json").write_text(json.dumps(small_traffic()))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
