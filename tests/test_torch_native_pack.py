"""The port's native polar packer (``data/native_pack.py``) against the JAX
package's binding of the same ``native/scanpack.cpp``, on the CPU.

Built with the same flags on the same host, the two give the same bits: at
1024 and 2048 azimuth bins, with one and two channels, on a ragged chunk
(more frames than scans) that holds an empty scan, NaN and infinite points,
points nearer than ``min_range`` and farther than ``max_range``, and rows of
3 and of 4 floats (x, y, z, intensity). Against the numpy packer the port
keeps the JAX package's rule (``tests/test_pointcloud.py``): the range plane
exact, the offsets within one quantum, 99% of cells alike. Without ``g++``, on
a failed build and on a failed pack the port raises; it builds into its
``_build/`` and never writes ``native/libscanpack.so``. The distributed
cam-lidar driver and the ``run_chunked`` polar ingests of
``models/pipeline.py`` upload the JAX package's native pack bit for bit."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidar_visual_odometry_tpu.data import native_pack as jnp_pack
from lidar_visual_odometry_tpu.data import synthetic as jsyn
from lidar_visual_odometry_tpu_torch.data import native_loader, native_pack
from lidar_visual_odometry_tpu_torch.models import pipeline as tpipe
from lidar_visual_odometry_tpu_torch.ops import pointcloud as pc
from lidar_visual_odometry_tpu_torch.utils.config import SystemConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(n_scans=64, min_range=0.1, max_range=120.0)


def make_scan(k=0):
    seq = jsyn.SyntheticSequence(n_frames=k + 1, width=900)
    return seq.scan(k)


@pytest.fixture(scope="module")
def clean():
    return [make_scan(0), make_scan(1)[::2]]


def _spoil(scan, rng):
    """A scan with NaN and infinite coordinates, points inside ``min_range``
    and beyond ``max_range``, in random rows."""
    out = scan.astype(np.float32).copy()
    rows = rng.permutation(len(out))
    nan, inf, near, far = np.array_split(rows[:800], 4)
    out[nan, rng.integers(0, 3, len(nan))] = np.nan
    out[inf, rng.integers(0, 3, len(inf))] = np.inf * rng.choice([-1.0, 1.0], len(inf))
    out[near] *= (0.05 / np.linalg.norm(out[near], axis=1))[:, None]
    out[far] *= (rng.uniform(121.0, 400.0, len(far)) / np.linalg.norm(out[far], axis=1))[:, None]
    return out


@pytest.fixture(scope="module")
def chunks(clean):
    """The test's chunks, by row width: a spoilt scan, an empty one and a
    clean one; the stride-4 rows carry an intensity column."""
    rng = np.random.default_rng(0)
    spoilt = _spoil(make_scan(2), rng)
    three = [spoilt, np.zeros((0, 3), np.float32), clean[0]]
    four = [np.concatenate([s, rng.uniform(0, 1, (len(s), 1)).astype(np.float32)], axis=1)
            for s in three]
    return {3: three, 4: four}


@pytest.mark.parametrize("stride", [3, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1024, 2048])
def test_matches_the_jax_binding_bit_for_bit(chunks, width, channels, stride):
    scans = chunks[stride]
    want = jnp_pack.pack_polar_chunk(scans, width=width, n_frames=5, channels=channels, **GEOM)
    got = native_pack.pack_polar_chunk(scans, width=width, n_frames=5, channels=channels,
                                       **GEOM)
    assert got.dtype == np.uint16 and got.shape == (5, 64, width, channels)
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and not got[3:].any()   # the empty scan, the ragged tail
    assert got[0, ..., 0].any() and got[2, ..., 0].any()


def test_drops_the_points_it_must(chunks):
    """The spoilt scan packs as its clean rows alone."""
    spoilt = chunks[3][0]
    keep = np.isfinite(spoilt).all(axis=1)
    rng_ = np.linalg.norm(np.where(keep[:, None], spoilt, 0.0), axis=1)
    keep &= (rng_ > 0.1) & (rng_ < 120.0)
    assert (~keep).sum() >= 700
    got = native_pack.pack_polar_chunk([spoilt], width=1024, **GEOM)
    want = native_pack.pack_polar_chunk([spoilt[keep]], width=1024, **GEOM)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1024, 2048])
def test_against_the_numpy_packer(clean, width):
    """``tests/test_pointcloud.py``'s rule for the JAX packers."""
    out = native_pack.pack_polar_chunk(clean, width=width, n_frames=3, **GEOM)
    ref = pc.pack_polar_chunk(clean, width=width, **GEOM)
    assert not out[2].any()
    np.testing.assert_array_equal(out[:2, ..., 0], ref[..., 0])
    off, off_ref = out[:2, ..., 1].astype(np.int32), ref[..., 1].astype(np.int32)
    assert np.abs((off & 0xFF) - (off_ref & 0xFF)).max() <= 1
    assert np.abs((off >> 8) - (off_ref >> 8)).max() <= 1
    assert (out[:2] == ref).all(axis=-1).mean() > 0.99


def test_builds_into_its_own_directory(clean, tmp_path, monkeypatch):
    """A fresh build goes to ``_build/`` (here a temporary one), named by the
    source, the flags and the CPU; ``native/`` is left as it was."""
    native = os.path.join(ROOT, "native")

    def listing():
        return {name: os.stat(os.path.join(native, name)).st_mtime_ns
                for name in os.listdir(native)}

    before = listing()
    monkeypatch.setattr(native_loader, "_BUILD", tmp_path)
    monkeypatch.setattr(native_pack, "_lib", None)
    got = native_pack.pack_polar_chunk(clean, width=1024, **GEOM)
    built = [p.name for p in tmp_path.iterdir()]
    assert len(built) == 1 and built[0].startswith("libscanpack_") and built[0].endswith(".so")
    assert listing() == before
    np.testing.assert_array_equal(
        got, jnp_pack.pack_polar_chunk(clean, width=1024, **GEOM))


def test_raises_without_gxx_or_on_failure(clean, tmp_path, monkeypatch):
    monkeypatch.setattr(native_pack, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_pack.pack_polar_chunk(clean, width=1024, **GEOM)
    monkeypatch.undo()

    bad = tmp_path / "scanpack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_pack, "_lib", None)
    monkeypatch.setattr(native_pack, "_SRC", bad)
    monkeypatch.setattr(native_loader, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native_pack.pack_polar_chunk(clean, width=1024, **GEOM)
    monkeypatch.undo()

    with pytest.raises(RuntimeError, match="lvo_pack_polar failed"):
        native_pack.pack_polar_chunk(clean, width=1024, n_scans=20, min_range=0.1,
                                     max_range=120.0)


@pytest.mark.parametrize("ingest", ["polar", "polar2"])
def test_pipeline_uploads_the_numpy_images(clean, chunks, ingest):
    """``_pack_polar`` (every ``run_chunked`` polar ingest) uploads the JAX
    pipelines' native pack of the real frames bit for bit (the name is from
    the time it packed with the numpy packer, held until ROADMAP C.7 was
    settled): a clean scan, a spoilt one and another clean one."""
    lcfg = SystemConfig().lidar
    batch = [clean[0], chunks[3][0], clean[1]]
    geom = dict(n_scans=lcfg.n_scans, width=lcfg.azimuth_bins, min_range=lcfg.min_range,
                max_range=lcfg.max_range, channels=1 if ingest == "polar2" else 2)
    got = tpipe._pack_polar(batch, lcfg, ingest, torch.device("cpu"))
    assert got.dtype == torch.int32
    native = jnp_pack.pack_polar_chunk(batch, n_frames=len(batch), **geom).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), native)
    # the numpy packer would not have given these bits
    assert not np.array_equal(pc.pack_polar_chunk(batch, **geom).astype(np.int32), native)


def test_distributed_pack_scan_uploads_the_native_images(chunks):
    """``DistributedCamLidarPipeline._pack_scan`` (one tracked frame at a
    time, the polar ingest) uploads the JAX driver's native pack bit for bit,
    for a spoilt scan, an empty one and a clean one, with and without an
    intensity column."""
    from lidar_visual_odometry_tpu.parallel.distributed_camlidar import (
        DistributedCamLidarPipeline as JaxDistributed,
    )
    from lidar_visual_odometry_tpu.utils.config import SystemConfig as JaxSystemConfig
    from lidar_visual_odometry_tpu_torch.parallel.distributed_camlidar import (
        DistributedCamLidarPipeline,
    )

    port = SimpleNamespace(cfg=SystemConfig(), device=torch.device("cpu"))
    ref = SimpleNamespace(cfg=JaxSystemConfig())
    for scan in (*chunks[3], *chunks[4]):
        got = DistributedCamLidarPipeline._pack_scan(port, scan)
        want = JaxDistributed._pack_scan(ref, scan)
        assert got.dtype == torch.int32 and got.shape == (1, *want.shape)
        np.testing.assert_array_equal(got[0].numpy(), want.astype(np.int32))
