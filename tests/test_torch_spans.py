"""The span recorder (``utils/profiler.py``) on the port's lidar chain, and the
readings of ``tools/span_trace.py``.

``OdometryPipeline.run_chunked`` and ``FullPipeline.run_chunked`` (polar2, a
1024-column grid, 5 frames in 2 chunks of 2) run on the CPU once under the
recorder and once without: the spans must nest in time and by parent index,
one ``sequence`` holds the chunks, every ``frame`` one ``features`` and one
``odometry``, every ``sync`` lies inside the span of its site, the rounds a
frame lie within the solver's schedule, and the recorder changes no bit of
the poses. The readers are held to a hand-built context of two streams and
one idle gap, value for value."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu_torch.data import synthetic
from lidar_visual_odometry_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
from lidar_visual_odometry_tpu_torch.utils import config as tcfg
from lidar_visual_odometry_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, CHUNK = 5, 2
ODOM_ROUNDS, MAP_ROUNDS = 4, 3
SITE_SPAN = {"odometry.exit": "odometry", "mapping.exit": "mapping", "readback": "sequence",
             "checkpoint": "sequence"}


def _span_trace():
    spec = importlib.util.spec_from_file_location(
        "span_trace", os.path.join(ROOT, "tools", "span_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scans():
    seq = synthetic.SyntheticSequence(n_frames=N_FRAMES, width=600, noise=0.005)
    return [seq.scan(k) for k in range(N_FRAMES)]


def _cfg():
    return tcfg.SystemConfig(
        lidar=tcfg.LidarConfig(azimuth_bins=1024, max_less_flat=8192),
        odometry=tcfg.OdometryConfig(outer_iters=ODOM_ROUNDS),
        mapping=tcfg.MappingConfig(outer_iters=MAP_ROUNDS, gn_iters=4, corner_slot=1024,
                                   surf_slot=1024, map_corner_cap=2048, map_surf_cap=2048))


def _run(name, scans):
    torch.set_num_threads(2)
    if name == "odometry":
        res = OdometryPipeline(_cfg(), capacity=65536, device="cpu").run_chunked(
            scans, chunk=CHUNK, ingest="polar2")
        return [res.positions, res.quaternions]
    odo, mp = FullPipeline(_cfg(), capacity=65536, device="cpu").run_chunked(
        scans, chunk=CHUNK, map_skip=1, ingest="polar2")
    return [odo.positions, odo.quaternions, mp.positions, mp.quaternions]


@pytest.fixture(scope="module", params=["odometry", "slam"])
def runs(request, scans):
    """(path, spans of the recorded run, its poses, the unrecorded run's
    poses, what ``span`` gave with the recorder off)."""
    assert profiler._active is None
    off_span = profiler.span("sequence")
    plain = _run(request.param, scans)
    profiler.start()
    try:
        recorded = _run(request.param, scans)
    finally:
        spans = profiler.stop()
    return request.param, spans, recorded, plain, off_span


def _named(spans, name):
    return np.flatnonzero(spans["name"] == spans["names"].index(name)) \
        if name in spans["names"] else np.zeros(0, np.int64)


def _children(spans, i, name):
    return [j for j in _named(spans, name) if spans["parent"][j] == i]


def _ancestors(spans, i):
    p = spans["parent"][i]
    while p >= 0:
        yield p
        p = spans["parent"][p]


def test_spans_nest_in_time_and_by_parent(runs):
    _, spans, *_ = runs
    start, end, parent = spans["start"], spans["end"], spans["parent"]
    assert (end >= start).all()
    for i, p in enumerate(parent):
        assert p < i
        if p >= 0:
            assert start[p] <= start[i] and end[i] <= end[p]
    # siblings follow one another
    for p in set(parent.tolist()):
        kids = np.flatnonzero(parent == p)
        assert (start[kids[1:]] >= end[kids[:-1]]).all()


def test_one_sequence_of_chunks_and_frames(runs):
    path, spans, *_ = runs
    (seq,) = _named(spans, "sequence")
    assert spans["parent"][seq] == -1 and (spans["seq"] == seq).all()
    chunks = _named(spans, "chunk")
    assert len(chunks) == -(-(N_FRAMES - 1) // CHUNK)
    assert all(spans["parent"][c] == seq for c in chunks)
    frames = _named(spans, "frame")
    assert len(frames) == N_FRAMES - 1
    assert all(spans["parent"][f] in chunks for f in frames)
    for c in chunks:
        assert len(_children(spans, c, "pack")) == 1 and len(_children(spans, c, "upload")) == 1
    # frame 0's registration, outside every chunk
    assert len(_children(spans, seq, "features")) == 1
    assert len(_named(spans, "mapping")) == (N_FRAMES - 1 if path == "slam" else 0)


def test_every_frame_holds_features_and_odometry(runs):
    path, spans, *_ = runs
    for f in _named(spans, "frame"):
        assert len(_children(spans, f, "features")) == 1
        assert len(_children(spans, f, "odometry")) == 1
        assert len(_children(spans, f, "mapping")) == (1 if path == "slam" else 0)


def test_every_sync_lies_inside_its_site(runs):
    path, spans, *_ = runs
    syncs = _named(spans, "sync")
    sites = [spans["attrs"][int(i)]["site"] for i in syncs]
    assert sites.count("readback") == 1
    assert "odometry.exit" in sites and (("mapping.exit" in sites) == (path == "slam"))
    for i, site in zip(syncs, sites):
        names = [spans["names"][spans["name"][a]] for a in _ancestors(spans, i)]
        assert SITE_SPAN[site] in names and "sync" not in names


def test_rounds_within_the_schedule(runs):
    path, spans, *_ = runs
    for o in _named(spans, "odometry"):
        assert 2 <= len(_children(spans, o, "odometry.round")) <= ODOM_ROUNDS
        exits = len(_children(spans, o, "sync"))
        assert exits == len(_children(spans, o, "odometry.round")) - 1 or exits == ODOM_ROUNDS - 2
    for m in _named(spans, "mapping"):
        assert len(_children(spans, m, "mapping.filter")) == 1
        assert len(_children(spans, m, "mapping.merge")) == 1
        assert 2 <= len(_children(spans, m, "mapping.round")) <= MAP_ROUNDS


def test_recorder_off_records_nothing_and_changes_no_bit(runs):
    _, spans, recorded, plain, off_span = runs
    assert off_span is profiler._NULL and profiler.span("frame") is profiler._NULL
    assert profiler._active is None
    for a, b in zip(recorded, plain):
        assert np.array_equal(a, b)
    s = profiler.summarise(spans)
    assert s["frame"]["count"] == N_FRAMES - 1
    assert s["sequence"]["host_ms"] == pytest.approx(s["sequence"]["ms"] - s["sync"]["ms"])


def test_recorder_api():
    with pytest.raises(RuntimeError):
        profiler.stop()
    rec = profiler.start()
    try:
        with pytest.raises(RuntimeError):
            profiler.start()
        with profiler.span("a"):
            with profiler.span("sync", site="x"):
                pass
        assert len(rec.name) == 2
    finally:
        spans = profiler.stop()
    assert spans["names"] == ["a", "sync"] and spans["parent"].tolist() == [-1, 0]
    assert spans["attrs"] == {1: {"site": "x"}} and spans["seq"].tolist() == [0, 0]


MS = 1_000_000


def _stream(rows):
    """Spans from (name, start ms, end ms, parent, site) rows."""
    names = sorted({r[0] for r in rows})
    return {"names": names,
            "name": np.asarray([names.index(r[0]) for r in rows], np.int32),
            "start": np.asarray([r[1] * MS for r in rows], np.int64),
            "end": np.asarray([r[2] * MS for r in rows], np.int64),
            "parent": np.asarray([r[3] for r in rows], np.int32),
            "seq": np.zeros(len(rows), np.int32),
            "attrs": {i: {"site": r[4]} for i, r in enumerate(rows) if r[4]}}


STREAM_A = _stream([
    ("sequence", 0, 100, -1, None), ("chunk", 0, 100, 0, None), ("pack", 0, 10, 1, None),
    ("upload", 10, 15, 1, None), ("frame", 15, 100, 1, None), ("features", 15, 40, 4, None),
    ("odometry", 40, 80, 4, None), ("odometry.round", 40, 50, 6, None),
    ("sync", 50, 60, 6, "odometry.exit"), ("odometry.round", 60, 70, 6, None),
    ("mapping", 80, 95, 4, None), ("sync", 85, 90, 10, "mapping.exit")])
STREAM_B = _stream([
    ("sequence", 20, 120, -1, None), ("chunk", 20, 120, 0, None), ("pack", 20, 30, 1, None),
    ("frame", 30, 120, 1, None), ("features", 30, 50, 3, None), ("odometry", 50, 110, 3, None),
    ("sync", 70, 100, 5, "odometry.exit")])
GAP = (45 * MS, 65 * MS)


@pytest.mark.parametrize("metric,want", [
    ("pack_ms_per_frame", (10 + 5 + 10) / 2),
    ("features_host_ms_per_frame", (25 + 20) / 2),
    ("odometry_host_ms_per_frame", ((40 - 10) + (60 - 30)) / 2),
    ("mapping_host_ms_per_frame", (15 - 5) / 2),
    ("syncs_per_frame", 3 / 2),
    ("sync_wait_pct", 100.0 * (10 + 5 + 30) / (100 + 100)),
    # the gap's 20 ms: stream A dispatches 10 of them (10 in its exit
    # read), stream B all 20
    ("idle_host_dispatch_pct", 100.0 * (10 / 20 + 20 / 20) / 2),
])
def test_span_readers_on_a_hand_built_context(metric, want):
    st = _span_trace()
    ctx = {"spans": [STREAM_A, STREAM_B], "gaps": [GAP]}
    assert st.METRICS[metric](ctx) == pytest.approx(want, rel=1e-12)


def test_span_readers_split_and_gaps():
    st = _span_trace()
    ctx = {"spans": [STREAM_A, STREAM_B], "gaps": [GAP]}
    split = st.idle_split(ctx)
    assert split["idle_s"] == pytest.approx(0.02)
    assert split["mean_over_streams_pct"] == pytest.approx(
        {"dispatch": 75.0, "sync": 25.0, "outside": 0.0})
    assert split["longest_gaps"] == [{"s": 0.02, "streams": ["sync:odometry.exit", "odometry"]}]
    assert st.uncovered(ctx)["pct"] == pytest.approx(100.0 * (5 + 10) / 200)
    got = st.read(ctx)
    assert got["rounds_per_frame"] == {"odometry": 1.0, "mapping": None}
    assert got["syncs_per_frame_by_site"] == {"mapping.exit": 0.5, "odometry.exit": 1.0}
    assert got["host_ms_per_frame"]["odometry.round"] == pytest.approx((10 + 10) / 2)
    assert got["host_ms_per_frame"]["frame"] == pytest.approx(((85 - 15) + (90 - 30)) / 2)
    # no mapping spans, no mapping metric; a stream outside the program in the gap
    only_b = {"spans": [STREAM_B], "gaps": [(0, 10 * MS), GAP]}
    assert st.METRICS["mapping_host_ms_per_frame"](only_b) is None
    assert st.idle_split(only_b)["mean_over_streams_s"] == pytest.approx(
        {"dispatch": 0.02, "sync": 0.0, "outside": 0.01})
