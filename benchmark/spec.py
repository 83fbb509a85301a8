"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, ``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``,
``benchmark/entries/<entry>.py`` and one reader a per-layer metric,
``benchmark/metrics/<metric>.py``. A later cell, configuration, traffic mix or
metric is a new file and a new entry; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that a cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
