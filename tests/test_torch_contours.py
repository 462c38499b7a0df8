"""PyTorch port of the simplified geometry ("segments_simplified":
``maps/contours.py``, ``ops/raycast_general.py``) against the JAX
package, mirroring tests/test_contours.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- contours, general-segment tables and tile lists: the same host NumPy,
  equal bit for bit;
- general raycast values: within 2e-5 m (XLA's CPU backend may fuse the
  per-pair products into multiply-adds, PyTorch rounds each product);
- the closed-form pose gradients: within 1e-4 + 1e-4 relative (they
  multiply the range by the winner's 1/(u.n), up to ~1e3 at grazing
  incidence);
- the "segments_simplified" step: poses within 1e-5, ranges within 2e-5.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu import state as jstate
from pyracecarsimulator_tpu.maps import contours as jc

# the JAX ops package exports a function of the module's name
jg = importlib.import_module("pyracecarsimulator_tpu.ops.raycast_general")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps import contours as pc
from pyracecarsimulator_tpu_torch.maps.loader import TrackMap
from pyracecarsimulator_tpu_torch.maps.segments import (
    extract_segments, pad_segments, raycast_segments_numpy)
from pyracecarsimulator_tpu_torch.ops import raycast_general as pg

RES = 0.05
T = lambda a: torch.tensor(np.asarray(a))      # an own, writable copy
STATICS = ("n_segments", "tol_cells", "tile_size", "tiles_shape",
           "tile_origin", "extent")


def disks(seed=0, n=14, size=240):
    """A walled square with random disks: curved boundaries that simplify
    to 134 general segments at tol 1 cell. (occupancy, origin)."""
    rng = np.random.RandomState(seed)
    occ = np.zeros((size, size), np.float32)
    occ[:3] = 1; occ[-3:] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    yy, xx = np.mgrid[:size, :size]
    for _ in range(n):
        cy, cx = rng.randint(20, size - 20, 2)
        r = rng.uniform(4, 12)
        occ[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return occ, (-size * RES / 2, -size * RES / 2)


def _free_poses(occ, org, n, seed, margin=0.4):
    from pyracecarsimulator_tpu_torch.maps.edt import edt
    e = edt(occ >= 0.5, RES)
    rng = np.random.RandomState(seed)
    ys, xs = np.where(e > margin)
    k = rng.randint(len(ys), size=n)
    return np.stack([org[0] + (xs[k] + .5) * RES, org[1] + (ys[k] + .5) * RES,
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


@pytest.mark.parametrize("case, n_loops", [("cell", 1), ("ring", 2),
                                            ("disks", 15)])
def test_trace_contours_equal_jax(case, n_loops):
    if case == "disks":
        occ = disks()[0] >= 0.5
    else:
        occ = np.zeros((16, 16), bool)
        if case == "cell":
            occ[3, 5] = True
        else:                   # a ring around a 4x4 hole
            occ[4:12, 4:12] = True
            occ[6:10, 6:10] = False
    got, ref = pc.trace_contours(occ), jc.trace_contours(occ)
    assert len(got) == len(ref) == n_loops
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile_size, max_range", [(0.0, 10.0), (1.0, 1.5),
                                                  (2.0, 2.0)])
def test_general_map_equals_jax(tile_size, max_range):
    occ, org = disks()
    kw = dict(tol_cells=1.0, max_range=max_range, tile_size=tile_size,
              real_hw=occ.shape)
    jm = jc.build_general_segment_map(occ, RES, org, **kw)
    pm = pc.build_general_segment_map(occ, RES, org, **kw)
    np.testing.assert_array_equal(pm.params.numpy(), np.asarray(jm.params))
    assert (pm.tiles is None) == (jm.tiles is None) == (tile_size == 0.0)
    if jm.tiles is not None:
        np.testing.assert_array_equal(pm.tiles.numpy(),
                                      np.asarray(jm.tiles))
    for f in STATICS:
        assert getattr(pm, f) == getattr(jm, f), f
    assert pm.params.dtype == torch.float32 and pm.device.type == "cpu"
    back = pc.GeneralSegmentMap.from_numpy(
        np.asarray(jm.params), None if jm.tiles is None
        else np.asarray(jm.tiles), **{f: getattr(jm, f) for f in STATICS})
    assert torch.equal(back.params, pm.params)


@pytest.mark.parametrize("tiled", [False, True])
def test_general_scan_values_and_grads_match_jax(tiled):
    occ, org = disks()
    kw = dict(tol_cells=1.0, max_range=1.5,
              tile_size=1.0 if tiled else 0.0, real_hw=occ.shape)
    jm = jc.build_general_segment_map(occ, RES, org, **kw)
    pm = pc.build_general_segment_map(occ, RES, org, **kw)
    assert (pm.tiles is not None) == tiled
    poses = _free_poses(occ, org, 12, 1)
    w = np.random.RandomState(2).randn(12, 96).astype(np.float32)
    sc = dict(num_beams=96, max_range=1.5)
    r_ref = np.asarray(jg.scan_poses_general(jm, jnp.asarray(poses), **sc))
    g_ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jg.scan_poses_general(jm, p, **sc) * w))(jnp.asarray(poses)))
    p = T(poses).requires_grad_(True)
    r = pg.scan_poses_general(pm, p, **sc)
    (r * T(w)).sum().backward()
    np.testing.assert_allclose(r.detach().numpy(), r_ref, atol=2e-5, rtol=0)
    assert 0.05 < np.mean(r_ref < 1.5) < 1.0       # hits and misses
    np.testing.assert_allclose(p.grad.numpy(), g_ref, atol=1e-4, rtol=1e-4)
    with torch.no_grad():                           # the min-only forward
        assert torch.equal(pg.scan_poses_general(pm, p, **sc), r.detach())


def test_tiled_equals_full_and_numpy_oracle():
    occ, org = disks()
    pm = pc.build_general_segment_map(occ, RES, org, tol_cells=1.0,
                                      max_range=1.5, tile_size=1.0,
                                      real_hw=occ.shape)
    poses = T(_free_poses(occ, org, 16, 3))
    rt = pg.scan_poses_general(pm, poses, num_beams=32, max_range=1.5)
    rf = pg.scan_poses_general(pm, poses, num_beams=32, max_range=1.5,
                               use_tiles=False)
    assert torch.equal(rt, rf)
    segs = pc.extract_general_segments(occ, RES, org, 1.0)
    x = np.random.RandomState(4).uniform(-3, 3, 64)
    y = np.random.RandomState(5).uniform(-3, 3, 64)
    th = np.random.RandomState(6).uniform(-np.pi, np.pi, 64)
    padded = pc.pad_general_segments(segs)
    ref = pg.raycast_general_numpy(padded, x, y, np.cos(th), np.sin(th),
                                   10.0)
    np.testing.assert_array_equal(ref, jg.raycast_general_numpy(
        padded, x, y, np.cos(th), np.sin(th), 10.0))
    got = pg.raycast_general(T(padded.T).float(), *(
        T(v).float() for v in (x, y, np.cos(th), np.sin(th))), 10.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_unsimplified_matches_axis_segments(small_track):
    """tol 0: the general segments describe the axis-aligned geometry."""
    occ = np.asarray(small_track.occupancy)
    org = (small_track.origin_x, small_track.origin_y)
    g = pc.contours_to_general_segments(
        pc.trace_contours(occ >= 0.5), small_track.resolution, org, 0.0)
    a = pad_segments(extract_segments(occ, small_track.resolution, org))
    poses = _free_poses(occ[:192, :192], org, 64, 7)
    x, y, th = poses.T.astype(np.float64)
    np.testing.assert_allclose(
        pg.raycast_general_numpy(pc.pad_general_segments(g), x, y,
                                 np.cos(th), np.sin(th), 10.0),
        raycast_segments_numpy(a, x, y, np.cos(th), np.sin(th), 10.0),
        atol=1e-9)


def test_simplified_step_matches_jax(small_track):
    t = small_track
    pt = TrackMap.from_numpy(np.asarray(t.occupancy), np.asarray(t.edf),
                             resolution=t.resolution, origin_x=t.origin_x,
                             origin_y=t.origin_y, height=t.height,
                             width=t.width)
    jb = jsim.build_sim(t, scan=jsim.ScanParams(num_beams=64),
                        backend="segments_simplified")
    pb = psim.build_sim(pt, scan=P.ScanParams(num_beams=64),
                        backend="segments_simplified", device="cpu")
    assert isinstance(pb.segmap, pc.GeneralSegmentMap)
    np.testing.assert_array_equal(pb.segmap.params.numpy(),
                                  np.asarray(jb.segmap.params))
    poses = _free_poses(np.asarray(t.occupancy)[:192, :192],
                        (t.origin_x, t.origin_y), 6, 8, margin=0.3)
    js = jstate.state_from_pose(*map(jnp.asarray, poses.T))
    ps = P.state_from_pose(*map(T, poses.T))
    act = np.full(6, 2.0, np.float32), np.zeros(6, np.float32)
    jo = jsim.make_step_fn(jb, with_noise=False)(
        js, tuple(map(jnp.asarray, act)))
    po = psim.make_step_fn(pb, with_noise=False)(ps, tuple(map(T, act)))
    assert po.ranges.shape == (6, 64)
    np.testing.assert_allclose(po.state.pose.numpy(),
                               np.asarray(jo.state.pose), atol=1e-5)
    np.testing.assert_allclose(po.ranges.numpy(), np.asarray(jo.ranges),
                               atol=2e-5, rtol=0)
