"""PyTorch port of the host map compile against the JAX package.

Every comparison here is exact: both packages compile maps on the host,
each through its own native library where that is built (the EDT is the
same arithmetic in both bodies; the float64 native sector membership
equals the float32 NumPy body on these maps, tests/test_native.py and
tests/test_torch_native.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu.maps import loader as jloader
from pyracecarsimulator_tpu.maps.edt import edt_numpy as jax_edt_numpy
from pyracecarsimulator_tpu.maps.sectors import (build_sector_map as
                                                 jax_build_sector_map)
from pyracecarsimulator_tpu.maps.segments import (extract_segments as
                                                  jax_extract_segments)

from pyracecarsimulator_tpu_torch.maps.edt import edt, edt_numpy
from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.maps.sectors import (SectorSegmentMap,
                                                       build_sector_map)
from pyracecarsimulator_tpu_torch.maps.segments import extract_segments

STATICS = ("n_segments", "ns", "kv_sec", "block_half", "tile_size",
           "tiles_shape", "tile_origin", "extent", "rt", "reach")


def _occ(track):
    return np.asarray(track.occupancy)


@pytest.fixture(scope="module")
def levine_pair():
    return (jloader.load_builtin("levine"),
            ploader.load_builtin("levine", device="cpu"))


def test_edt_exact(rng):
    occ = rng.rand(40, 57) > 0.93
    np.testing.assert_array_equal(edt_numpy(occ), jax_edt_numpy(occ))
    np.testing.assert_array_equal(edt(occ, 0.05),
                                  jax_edt_numpy(occ) * np.float32(0.05))


def test_extract_segments_exact(small_track):
    occ = _occ(small_track)
    org = (small_track.origin_x, small_track.origin_y)
    got = extract_segments(occ, small_track.resolution, org)
    np.testing.assert_array_equal(
        got, jax_extract_segments(occ, small_track.resolution, org))
    assert got.shape[1] == 4 and len(got) > 0


@pytest.mark.parametrize("kw", [dict(), dict(headroom=8),
                                dict(tile_size=4.0, ns=8, block_half=0.4)])
def test_build_sector_map_exact(small_track, kw):
    """table, meta and every static field equal the JAX build."""
    t = small_track
    args = (_occ(t), t.resolution, (t.origin_x, t.origin_y))
    hw = dict(real_hw=(t.height, t.width))
    jmap = jax_build_sector_map(*args, **hw, **kw)
    pmap = build_sector_map(*args, **hw, **kw, device="cpu")
    assert pmap.table.dtype == torch.float32 and pmap.meta.dtype == torch.int32
    np.testing.assert_array_equal(pmap.table.numpy(), np.asarray(jmap.table))
    np.testing.assert_array_equal(pmap.meta.numpy(), np.asarray(jmap.meta))
    for f in STATICS:
        assert getattr(pmap, f) == getattr(jmap, f), f
    # sentinel slots and the meta layout [n_v, kv, kv + n_h]
    meta = pmap.meta.numpy()
    assert np.all(meta[:, 1] == pmap.kv_sec)
    row = int(np.argmin(meta[:, 0]))
    pad = pmap.table.numpy()[row, :3, meta[row, 0]:pmap.kv_sec]
    assert np.all(pad == np.array([[1e9], [1.0], [-1.0]], np.float32))


def test_sector_map_from_numpy_roundtrip(small_track):
    t = small_track
    jmap = jax_build_sector_map(_occ(t), t.resolution,
                                (t.origin_x, t.origin_y))
    pmap = SectorSegmentMap.from_numpy(
        np.asarray(jmap.table), np.asarray(jmap.meta),
        **{f: getattr(jmap, f) for f in STATICS}, device="cpu")
    np.testing.assert_array_equal(pmap.table.numpy(), np.asarray(jmap.table))
    assert pmap.to("cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="meta"):
        SectorSegmentMap.from_numpy(np.asarray(jmap.table),
                                    np.asarray(jmap.meta)[:-1],
                                    n_segments=1, device="cpu")


def test_load_builtin_matches_jax(levine_pair):
    """The port reads the bundled asset by path and builds the same padded
    occupancy and EDF."""
    jt, pt = levine_pair
    assert (pt.height, pt.width, pt.resolution, pt.origin_x, pt.origin_y,
            pt.name) == (jt.height, jt.width, jt.resolution, jt.origin_x,
                         jt.origin_y, jt.name)
    np.testing.assert_array_equal(pt.occupancy.numpy(),
                                  np.asarray(jt.occupancy))
    np.testing.assert_array_equal(pt.edf.numpy(), np.asarray(jt.edf))
    assert pt.padded_shape == jt.padded_shape
    assert pt.world_extent() == jt.world_extent()


def test_sample_free_poses_match(levine_pair):
    jt, pt = levine_pair
    np.testing.assert_array_equal(ploader.sample_free_poses(pt, 64, 3),
                                  jloader.sample_free_poses(jt, 64, 3))


def test_map_yaml_parser():
    for name in ("levine", "berlin"):
        path = os.path.join(ploader.ASSETS_DIR, f"{name}.yaml")
        with open(path) as f:
            got = ploader.parse_map_yaml(f.read())
        import yaml
        with open(path) as f:
            assert got == yaml.safe_load(f)
    assert ploader.parse_map_yaml("a: 1  # c\n\nb: [0.5, -2, x]\n") == \
        {"a": 1, "b": [0.5, -2, "x"]}


def test_read_pgm_and_occupancy(tmp_path):
    img = (np.arange(12, dtype=np.uint8).reshape(3, 4) * 21)
    path = tmp_path / "m.pgm"
    jloader.write_pgm(str(path), img)
    got = ploader.read_pgm(str(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(ploader.occupancy_from_image(got),
                                  jloader.occupancy_from_image(got))


def test_track_map_from_numpy_and_missing_asset(small_track):
    t = small_track
    pt = ploader.TrackMap.from_numpy(
        np.asarray(t.occupancy), np.asarray(t.edf), resolution=t.resolution,
        origin_x=t.origin_x, origin_y=t.origin_y, height=t.height,
        width=t.width, name=t.name, device="cpu")
    np.testing.assert_array_equal(pt.to("cpu").edf.numpy(),
                                  np.asarray(t.edf))
    with pytest.raises(FileNotFoundError):
        ploader.load_builtin("no_such_track", device="cpu")


def test_assets_dir_lies_inside_the_port():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        ploader.__file__)))
    assert os.path.basename(pkg) == "pyracecarsimulator_tpu_torch"
    assert os.path.realpath(ploader.ASSETS_DIR) == os.path.realpath(
        os.path.join(pkg, "maps", "assets"))


@pytest.mark.parametrize("asset", ["levine.pgm", "levine.yaml",
                                   "berlin.pgm", "berlin.yaml"])
def test_bundled_asset_equals_the_jax_packages(asset):
    jdir = os.path.join(os.path.dirname(os.path.abspath(jloader.__file__)),
                        "assets")
    with open(os.path.join(ploader.ASSETS_DIR, asset), "rb") as f, \
            open(os.path.join(jdir, asset), "rb") as g:
        assert f.read() == g.read()


def _builders_without_device():
    from pyracecarsimulator_tpu_torch.maps import contours, sectors, segments
    from pyracecarsimulator_tpu_torch.models.ttc import ttc_tables
    from pyracecarsimulator_tpu_torch.ops import common
    from pyracecarsimulator_tpu_torch.ops.raycast_pallas import (
        sweep_meta_mixed, sweep_meta_split)
    from pyracecarsimulator_tpu_torch.config import CarParams
    occ = np.zeros((16, 16), np.float32)
    occ[4:8, 4:8] = 1.0
    table, meta = np.zeros((2, 4, 8), np.float32), np.zeros((2, 3), np.int32)
    return {
        "SegmentMap.from_numpy": lambda: segments.SegmentMap.from_numpy(
            np.zeros((4, 128), np.float32), np.zeros(3, np.int32)),
        "build_segment_map": lambda: segments.build_segment_map(occ, 0.05),
        "SectorSegmentMap.from_numpy":
            lambda: sectors.SectorSegmentMap.from_numpy(table, meta,
                                                        n_segments=1),
        "build_sector_map": lambda: sectors.build_sector_map(occ, 0.05),
        "StackedSectorMap.from_numpy":
            lambda: sectors.StackedSectorMap.from_numpy(
                table, meta, [0], [[1, 1, 0, 0]], [[0, 1, 0, 1]]),
        "GeneralSegmentMap.from_numpy":
            lambda: contours.GeneralSegmentMap.from_numpy(
                np.zeros((6, 128), np.float32)),
        "build_general_segment_map":
            lambda: contours.build_general_segment_map(occ, 0.05),
        "TrackMap.from_numpy": lambda: ploader.TrackMap.from_numpy(
            occ, occ, resolution=0.05, origin_x=0.0, origin_y=0.0,
            height=16, width=16),
        "ttc_tables": lambda: ttc_tables(90, 4.7, CarParams()),
        "beam_angles": lambda: common.beam_angles(90, 4.7),
        "_padded_offsets": lambda: common._padded_offsets(90, 4.7, 128),
        "sweep_meta_mixed": lambda: sweep_meta_mixed(41, 82),
        "sweep_meta_split": lambda: sweep_meta_split(48, 41, 82),
    }


@pytest.mark.parametrize("builder", [
    "SegmentMap.from_numpy", "build_segment_map",
    "SectorSegmentMap.from_numpy", "build_sector_map",
    "StackedSectorMap.from_numpy", "GeneralSegmentMap.from_numpy",
    "build_general_segment_map", "TrackMap.from_numpy", "ttc_tables",
    "beam_angles", "_padded_offsets", "sweep_meta_mixed",
    "sweep_meta_split"])
def test_builder_without_a_device_needs_the_card(builder):
    """No builder falls back to the CPU in silence: without ``device`` each
    builds on the card, and on a machine without one raises the error that
    names ``device="cpu"``."""
    call = _builders_without_device()[builder]
    if torch.cuda.is_available():
        out = call()
        leaf = out if torch.is_tensor(out) else (
            out[0] if isinstance(out, tuple) else next(
                v for v in vars(out).values() if torch.is_tensor(v)))
        assert leaf.is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
