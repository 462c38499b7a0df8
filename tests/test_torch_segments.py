"""PyTorch port of the dense segment backend against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the map compile is host NumPy on both sides and must be equal
bit for bit. Sweeps given the same rays agree on the clamped range, on
``hit`` and on ``isv`` where hit, bit for bit (the JAX kernels and XLA
sweeps also visit padded sentinel slots, whose "hits" land near 1e9 m and
change only unclamped minima). A scan given the JAX package's beam fan
equals the JAX scan bit for bit; with its own fan it is held to 1e-4 m on
at least 99.5% of the beams (ROADMAP.md fault 3.1).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pyracecarsimulator_tpu.maps import loader as jloader
from pyracecarsimulator_tpu.maps import segments as jseg
from pyracecarsimulator_tpu.ops import raycast_segments as jrs
from pyracecarsimulator_tpu.ops.common import rays_from_poses as jax_rays
from pyracecarsimulator_tpu.ops.raycast_segments import (
    _ray_invs as jax_ray_invs)

# the JAX ops package exports a function of the module's name
jrp = importlib.import_module("pyracecarsimulator_tpu.ops.raycast_pallas")

from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.maps import segments as pseg
from pyracecarsimulator_tpu_torch.ops import raycast_pallas as prp
from pyracecarsimulator_tpu_torch.ops import raycast_segments as prs
from pyracecarsimulator_tpu_torch.ops import sweeps
from pyracecarsimulator_tpu_torch.ops.common import _ray_invs

FOV = 4.712388980384690
MAXR = 4.0
STATICS = ("n_segments", "tile_size", "tiles_shape", "tile_origin",
           "extent", "kv", "kv_tile")


def blobby(seed, n_blocks):
    """tests/test_sectors.py's blobby geometry: a walled square with random
    blocks. (occupancy, origin)."""
    rng = np.random.RandomState(seed)
    h = w = 220
    occ = np.zeros((h, w), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(n_blocks):
        r, c = rng.randint(10, h - 12), rng.randint(10, w - 12)
        bh, bw = rng.randint(2, 9, 2)
        occ[r:r + bh, c:c + bw] = 1
    return occ, (-h * 0.025, -w * 0.025)


def _occ(small_track, name):
    if name == "small":
        t = small_track
        return np.asarray(t.occupancy), (t.origin_x, t.origin_y)
    return blobby(*{"blobby": (7, 40), "dense": (3, 400)}[name])


def _assert_maps_equal(pmap, jmap):
    np.testing.assert_array_equal(pmap.params.numpy(),
                                  np.asarray(jmap.params))
    np.testing.assert_array_equal(pmap.sweep_meta.numpy(),
                                  np.asarray(jmap.sweep_meta))
    assert (pmap.tiles is None) == (jmap.tiles is None)
    if jmap.tiles is not None:
        np.testing.assert_array_equal(pmap.tiles.numpy(),
                                      np.asarray(jmap.tiles))
        np.testing.assert_array_equal(pmap.tile_sweep_meta.numpy(),
                                      np.asarray(jmap.tile_sweep_meta))
    for f in STATICS:
        assert getattr(pmap, f) == getattr(jmap, f), f
    assert pmap.params.dtype == torch.float32
    assert pmap.sweep_meta.dtype == torch.int32


# (map, build kwargs, layout of params, layout of tiles)
BUILDS = [
    ("small", dict(), "mixed", None),
    ("small", dict(tile_size=4.0), "mixed", None),       # tiles dropped
    ("blobby", dict(), "split", None),
    ("blobby", dict(tile_size=1.0, max_range=2.0), "split", "mixed"),
    ("blobby", dict(tile_size=1.0, max_range=2.0, k_tile=512), "split",
     "mixed"),
    ("dense", dict(tile_size=2.0, max_range=4.0), "split", "split"),
    ("dense", dict(tile_size=2.0, max_range=4.0, k_tile=1280), "split",
     "split"),
]


@pytest.mark.parametrize("name, kw, layout, tile_layout", BUILDS)
def test_build_segment_map_exact(small_track, name, kw, layout,
                                 tile_layout):
    """params, sweep_meta, tiles, tile_sweep_meta and every static field
    equal the JAX build, in each layout, with and without tiles."""
    occ, org = _occ(small_track, name)
    args = (occ, 0.05, org)
    hw = dict(real_hw=occ.shape)
    jmap = jseg.build_segment_map(*args, **hw, **kw)
    pmap = pseg.build_segment_map(*args, **hw, **kw, device="cpu")
    _assert_maps_equal(pmap, jmap)
    assert (pmap.kv > 0) == (layout == "split")
    if tile_layout is None:
        assert pmap.tiles is None
    else:
        assert (pmap.kv_tile > 0) == (tile_layout == "split")


def test_k_tile_overflow_raises_like_jax(small_track):
    occ, org = _occ(small_track, "dense")
    kw = dict(tile_size=2.0, max_range=4.0, k_tile=768)
    for build, dev in ((jseg.build_segment_map, {}),
                       (pseg.build_segment_map, dict(device="cpu"))):
        with pytest.raises(ValueError, match="k_tile too small"):
            build(occ, 0.05, org, **kw, **dev)


@pytest.mark.parametrize("name, tile_size, tiled, split", [
    ("levine", 4.0, False, False), ("berlin", 4.0, True, True),
    ("berlin", 0.0, False, True)])
def test_builtin_maps_exact(name, tile_size, tiled, split):
    """The host builds of the bundled maps at the backend's defaults:
    levine drops its tiles (dense kernel, mixed layout), berlin keeps them
    (tile-routed kernel, split layout)."""
    jt = jloader.load_builtin(name)
    pt = ploader.load_builtin(name, device="cpu")
    np.testing.assert_array_equal(pt.occupancy.numpy(),
                                  np.asarray(jt.occupancy))
    kw = dict(max_range=10.0, tile_size=tile_size,
              real_hw=(jt.height, jt.width))
    org = (jt.origin_x, jt.origin_y)
    jmap = jseg.build_segment_map(np.asarray(jt.occupancy), jt.resolution,
                                  org, **kw)
    pmap = pseg.build_segment_map(pt.occupancy.numpy(), pt.resolution, org,
                                  **kw, device="cpu")
    _assert_maps_equal(pmap, jmap)
    assert (pmap.tiles is not None) == tiled and (pmap.kv > 0) == split


def test_from_numpy_roundtrip(small_track):
    occ, org = _occ(small_track, "blobby")
    kw = dict(tile_size=1.0, max_range=2.0)
    jmap = jseg.build_segment_map(occ, 0.05, org, **kw)
    pmap = pseg.SegmentMap.from_numpy(
        np.asarray(jmap.params), np.asarray(jmap.sweep_meta),
        np.asarray(jmap.tiles), np.asarray(jmap.tile_sweep_meta),
        **{f: getattr(jmap, f) for f in STATICS}, device="cpu")
    _assert_maps_equal(pmap, jmap)
    moved = pmap.to("cpu")
    assert moved.device.type == "cpu" and moved.kv == pmap.kv
    with pytest.raises(ValueError, match="tiles and tile_sweep_meta"):
        pseg.SegmentMap.from_numpy(np.asarray(jmap.params),
                                   np.asarray(jmap.sweep_meta),
                                   tiles=np.asarray(jmap.tiles), device="cpu")


def test_numpy_oracle_exact(small_track, rng):
    occ, org = _occ(small_track, "blobby")
    segs = pseg.extract_segments(occ, 0.05, org)
    x, y = rng.uniform(-5, 5, 50), rng.uniform(-5, 5, 50)
    th = rng.uniform(-np.pi, np.pi, 50)
    got = pseg.raycast_segments_numpy(segs, x, y, np.cos(th), np.sin(th),
                                      MAXR)
    ref = jseg.raycast_segments_numpy(segs, x, y, np.cos(th), np.sin(th),
                                      MAXR)
    np.testing.assert_array_equal(got, ref)


def _rays(rng, n, lo=-5.0, hi=5.0):
    x = rng.uniform(lo, hi, n).astype(np.float32)
    y = rng.uniform(lo, hi, n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ct, st = np.cos(th), np.sin(th)
    ct[:4] = 0.0                     # axis-parallel rays: NaN reciprocals
    st[4:8] = 0.0
    return x, y, ct, st


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable host copy


def _assert_same_result(bv_ref, bh_ref, bv, bh, max_range=MAXR):
    """Clamped range and hit bit-exact, isv equal where hit."""
    bv_ref, bh_ref = np.asarray(bv_ref), np.asarray(bh_ref)
    bv, bh = bv.numpy(), bh.numpy()
    m_ref, m = np.minimum(bv_ref, bh_ref), np.minimum(bv, bh)
    np.testing.assert_array_equal(np.minimum(m, max_range),
                                  np.minimum(m_ref, max_range))
    hit = m < max_range
    np.testing.assert_array_equal(hit, m_ref < max_range)
    np.testing.assert_array_equal((bv <= bh)[hit], (bv_ref <= bh_ref)[hit])
    assert hit.mean() > 0.25


@pytest.mark.parametrize("name", ["small", "blobby"])
def test_dense_plain_matches_pallas_kernel(small_track, rng, name):
    """dense_sweep_plain == _raycast_pallas_raw (interpret mode), the TPU
    kernel csrc/dense_sweep.cu replaces, and == raycast_all, on the same
    300 rays (mixed layout on small_track, split on blobby)."""
    occ, org = _occ(small_track, name)
    jmap = jseg.build_segment_map(occ, 0.05, org)
    pmap = pseg.build_segment_map(occ, 0.05, org, device="cpu")
    x, y, ct, st = _rays(rng, 300)
    ic, is_ = (np.asarray(v) for v in jax_ray_invs(ct, st))
    pad = lambda a: jnp.asarray(np.pad(a, (0, 4096 - 300)).reshape(32, 128))
    bv_ref, bh_ref = jrp._raycast_pallas_raw(
        jmap.sweep_meta, jmap.params, *map(pad, (x, y, ct, st, ic, is_)),
        interpret=True)
    bv, bh = sweeps.dense_sweep_plain(pmap.params, pmap.sweep_meta,
                                      *map(_t, (x, y, ct, st, ic, is_)))
    _assert_same_result(np.asarray(bv_ref).ravel()[:300],
                        np.asarray(bh_ref).ravel()[:300], bv, bh)
    ref = np.asarray(jrs.raycast_all(jmap.params, x, y, ct, st, MAXR,
                                     kv=jmap.kv))
    got = prs.raycast_all(pmap.params, pmap.sweep_meta, *map(_t, (x, y, ct,
                                                                  st)), MAXR)
    np.testing.assert_array_equal(got.numpy(), ref)


def _tile_case(small_track, name):
    occ, org = _occ(small_track, name)
    kw = (dict(tile_size=1.0, max_range=2.0) if name == "blobby"
          else dict(tile_size=2.0, max_range=4.0))
    jmap = jseg.build_segment_map(occ, 0.05, org, **kw)
    pmap = pseg.build_segment_map(occ, 0.05, org, **kw, device="cpu")
    return jmap, pmap, kw["max_range"]


@pytest.mark.parametrize("name", ["blobby", "dense"])
def test_tile_plain_matches_pallas_kernel(small_track, rng, name):
    """The tile-routed plain sweep == _raycast_pallas_ids_raw (interpret
    mode), the TPU kernel the list kernel replaces on map tiles, and
    raycast_tiled == the JAX raycast_tiled (mixed tiles on blobby, split on
    the dense map). Rays are 128-beam rows from 6 agents."""
    jmap, pmap, maxr = _tile_case(small_track, name)
    a_n, nblk = 6, 2
    x0, y0, _, _ = _rays(rng, a_n, -4.5, 4.5)
    th = rng.uniform(-np.pi, np.pi, (a_n, nblk * 128)).astype(np.float32)
    ct, st = np.cos(th), np.sin(th)
    ic, is_ = (np.asarray(v) for v in jax_ray_invs(ct, st))
    tid = np.asarray(jnp.clip(
        ((jnp.asarray(x0) - jmap.tile_origin[0]) / jmap.tile_size)
        .astype(jnp.int32), 0, jmap.tiles_shape[1] - 1)
        + jmap.tiles_shape[1] * jnp.clip(
            ((jnp.asarray(y0) - jmap.tile_origin[1]) / jmap.tile_size)
            .astype(jnp.int32), 0, jmap.tiles_shape[0] - 1))
    xb = np.repeat(x0[:, None], nblk * 128, 1)
    yb = np.repeat(y0[:, None], nblk * 128, 1)
    blk = lambda a: jnp.asarray(a.reshape(a_n, nblk, 128))
    bv_ref, bh_ref = jrp._raycast_pallas_ids_raw(
        jnp.asarray(tid), jmap.tile_sweep_meta, jmap.tiles,
        *map(blk, (xb, yb, ct, st, ic, is_)), interpret=True)
    rows = lambda a: _t(a.reshape(a_n * nblk, 128))
    bv, bh = sweeps.list_sweep(
        pmap.tiles, pmap.tile_sweep_meta,
        _t(np.repeat(tid, nblk).astype(np.int32)),
        _t(np.repeat(x0, nblk)), _t(np.repeat(y0, nblk)),
        *map(rows, (ct, st, ic, is_)))
    _assert_same_result(np.asarray(bv_ref).reshape(-1, 128),
                        np.asarray(bh_ref).reshape(-1, 128), bv, bh, maxr)
    ref = np.asarray(jrs.raycast_tiled(
        jmap.tiles, jmap.tiles_shape, jmap.tile_size, jmap.tile_origin,
        jnp.asarray(x0), jnp.asarray(y0), xb, yb, ct, st, maxr,
        kv_tile=jmap.kv_tile))
    got = prs.raycast_tiled(pmap.tiles, pmap.tile_sweep_meta,
                            pmap.tiles_shape, pmap.tile_size,
                            pmap.tile_origin, _t(x0), _t(y0),
                            *map(_t, (xb, yb, ct, st)), maxr)
    np.testing.assert_array_equal(got.numpy(), ref)


def _jax_fan(poses, num_beams, pad_to=None):
    """The JAX package's beam fan, optionally padded (last beam repeated)
    to the port's 128-beam rows."""
    _, _, _, _, ct, st = jax_rays(jnp.asarray(poses), num_beams, FOV)
    ct, st = np.asarray(ct), np.asarray(st)
    if pad_to:
        p = pad_to - num_beams
        ct, st = (np.concatenate([v, np.repeat(v[:, -1:], p, 1)], 1)
                  for v in (ct, st))
    return _t(ct), _t(st)


@pytest.mark.parametrize("name, num_beams", [
    ("small", 1080), ("blobby_tiled", 270), ("dense_tiled", 1080)])
def test_scans_with_jax_fan_are_bit_identical(small_track, rng, name,
                                              num_beams):
    """scan_poses_segments and scan_poses_pallas, given the JAX package's
    beam fan, equal the JAX scans bit for bit (one pose outside the map
    checks the extent mask)."""
    if name == "small":
        occ, org = _occ(small_track, "small")
        jmap = jseg.build_segment_map(occ, 0.05, org, real_hw=occ.shape)
        pmap = pseg.build_segment_map(occ, 0.05, org, real_hw=occ.shape,
                                      device="cpu")
        maxr = 10.0
    else:
        jmap, pmap, maxr = _tile_case(small_track, name.split("_")[0])
    x, y, _, _ = _rays(rng, 8, -4.5, 4.5)
    poses = np.stack([x, y, rng.uniform(-np.pi, np.pi, 8)], -1).astype(
        np.float32)
    poses[0, 0] = 50.0
    kw = dict(num_beams=num_beams, fov=FOV, max_range=maxr)
    ref = np.asarray(jrs.scan_poses_segments(jmap, jnp.asarray(poses), **kw))
    ref_pl = np.asarray(jrp.scan_poses_pallas(jmap, jnp.asarray(poses),
                                              interpret=True, **kw))
    np.testing.assert_array_equal(ref_pl, ref)
    pad_to = -(-num_beams // 128) * 128 if pmap.tiles is not None else None
    ct, st = _jax_fan(poses, num_beams, pad_to)
    got = prs._scan_rays(pmap, _t(poses), ct, st, num_beams, maxr)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(ref[0] == maxr)
    free = prp.scan_poses_pallas(pmap, _t(poses), **kw).numpy()
    assert free.shape == ref.shape
    assert np.mean(np.abs(free - ref) <= 1e-4) >= 0.995
    np.testing.assert_array_equal(
        free, prs.scan_poses_segments(pmap, _t(poses), **kw).numpy())


def test_untiled_scan_of_a_tiled_map(small_track, rng):
    """use_tiles=False sweeps the full set: same ranges as the tiles."""
    _, pmap, maxr = _tile_case(small_track, "blobby")
    x, y, _, _ = _rays(rng, 5, -4.5, 4.5)
    poses = _t(np.stack([x, y, np.zeros(5, np.float32)], -1))
    kw = dict(num_beams=300, fov=FOV, max_range=maxr)
    np.testing.assert_array_equal(
        prs.scan_poses_segments(pmap, poses, **kw).numpy(),
        prs.scan_poses_segments(pmap, poses, use_tiles=False, **kw).numpy())


def test_sweep_meta_helpers_match_jax():
    np.testing.assert_array_equal(prp.sweep_meta_mixed(41, 82,
                                                       device="cpu").numpy(),
                                  np.asarray(jrp.sweep_meta_mixed(41, 82)))
    np.testing.assert_array_equal(
        prp.sweep_meta_split(2304, 2221, 4442, device="cpu").numpy(),
        np.asarray(jrp.sweep_meta_split(2304, 2221, 4442)))


def test_cpu_tensors_take_the_plain_sweeps(small_track, rng):
    """On CPU tensors the wrappers return the plain versions' values and
    the kernels' launch counters do not move."""
    occ, org = _occ(small_track, "blobby")
    pmap = pseg.build_segment_map(occ, 0.05, org, tile_size=1.0,
                                  max_range=2.0, device="cpu")
    x, y, ct, st = map(_t, _rays(rng, 200))
    ic, is_ = _ray_invs(ct, st)
    args = (pmap.params, pmap.sweep_meta, x, y, ct, st, ic, is_)
    before = (sweeps.dense_sweep.launches, sweeps.list_sweep.launches)
    for a, b in zip(sweeps.dense_sweep(*args),
                    sweeps.dense_sweep_plain(*args)):
        assert torch.equal(a, b)
    prs.scan_poses_segments(pmap, torch.zeros(3, 3), num_beams=64)
    assert (sweeps.dense_sweep.launches, sweeps.list_sweep.launches) == \
        before == (0, 0)


def test_sweeps_reject_other_devices():
    meta_dev = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="device"):
        sweeps.dense_sweep(meta_dev(4, 128), meta_dev(3),
                           *(meta_dev(8) for _ in range(6)))
    with pytest.raises(ValueError, match="device"):
        sweeps.list_sweep(meta_dev(4, 4, 128), meta_dev(4, 3), meta_dev(2),
                          meta_dev(2), meta_dev(2),
                          *(meta_dev(2, 128) for _ in range(4)))


# -- ScanParams.use_theta_table on the "segments" backend ------------------
# (tests/test_torch_scan_modes.py states the tolerances)

def test_theta_table_quantizes_directions(small_track):
    import test_torch_scan_modes as checks
    checks.check_one_bucket(small_track, "segments")


def test_theta_table_matches_oracle_buckets(small_track):
    import test_torch_scan_modes as checks
    checks.check_oracle_buckets(small_track, "segments")


def test_theta_table_scan_matches_jax(small_track):
    import test_torch_scan_modes as checks
    checks.check_against_jax(small_track, "segments")
