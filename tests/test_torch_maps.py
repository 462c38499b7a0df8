"""PyTorch port of the host map compile against the JAX package.

Every comparison here is exact: the map compile is host NumPy on both
sides (the port's sector membership is the JAX package's NumPy body, which
equals its native library on these maps, tests/test_native.py).
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
    return jloader.load_builtin("levine"), ploader.load_builtin("levine")


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
    pmap = build_sector_map(*args, **hw, **kw)
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
        **{f: getattr(jmap, f) for f in STATICS})
    np.testing.assert_array_equal(pmap.table.numpy(), np.asarray(jmap.table))
    assert pmap.to("cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="meta"):
        SectorSegmentMap.from_numpy(np.asarray(jmap.table),
                                    np.asarray(jmap.meta)[:-1],
                                    n_segments=1)


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
        width=t.width, name=t.name)
    np.testing.assert_array_equal(pt.to("cpu").edf.numpy(),
                                  np.asarray(t.edf))
    with pytest.raises(FileNotFoundError):
        ploader.load_builtin("no_such_track")
