"""PyTorch port of the obstacle edits (``maps.loader.add_obstacle``,
``maps.sectors.add_segments``, the facade's ``add_obstacle`` /
``clear_obstacles``) against the JAX package, mirroring
tests/test_sectors.py's obstacle tests.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: none. The edits are host NumPy on both sides: the edited
occupancy and EDF, the sector table and meta after ``add_segments``, and
every backend's rebuilt geometry equal the JAX package's bit for bit;
incremental sector ranges equal the full rebuild's bit for bit; and
``clear_obstacles`` gives back the scan from before ``add_obstacle`` bit
for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyracecarsimulator_tpu import simulator as jsim
from pyracecarsimulator_tpu.maps import loader as jloader
from pyracecarsimulator_tpu.maps import sectors as jsec

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch.maps import loader as ploader
from pyracecarsimulator_tpu_torch.maps import sectors as psec
from pyracecarsimulator_tpu_torch.ops.raycast_sectors import (
    scan_poses_sectors)

FOV = 4.712388980384690
BACKENDS = ("segments", "segments_pallas", "sectors", "segments_simplified",
            "edf", "edf_bilinear", "edf_implicit")


def _port_track(t):
    return ploader.TrackMap.from_numpy(
        np.asarray(t.occupancy), np.asarray(t.edf), resolution=t.resolution,
        origin_x=t.origin_x, origin_y=t.origin_y, height=t.height,
        width=t.width, name=t.name, device="cpu")


def _open_cell(t):
    """World coords of the small track's most open cell."""
    edf = np.asarray(t.edf)[: t.height, : t.width]
    iy, ix = np.unravel_index(np.argmax(edf), edf.shape)
    return (t.origin_x + (ix + 0.5) * t.resolution,
            t.origin_y + (iy + 0.5) * t.resolution)


def _map_leaves(m):
    """The tensors/arrays that describe a map of any backend."""
    names = ("occupancy", "edf", "params", "sweep_meta", "tiles",
             "tile_sweep_meta", "table", "meta")
    return {k: np.asarray(getattr(m, k)) for k in names
            if getattr(m, k, None) is not None}


def test_add_obstacle_map_equals_jax(small_track):
    x, y = _open_cell(small_track)
    pt = _port_track(small_track)
    before = pt.occupancy.clone()
    got = ploader.add_obstacle(pt, x, y, size=0.4)
    ref = jloader.add_obstacle(small_track, x, y, size=0.4)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    np.testing.assert_array_equal(got.edf.numpy(), np.asarray(ref.edf))
    assert torch.equal(pt.occupancy, before)       # the input is untouched
    assert float((got.occupancy - before).sum()) > 0
    assert ploader.clear_obstacles(got, pt) is pt


def test_add_segments_equals_jax_and_full_rebuild(small_track):
    """add_segments: table and meta equal JAX's, the pristine map is left
    as it was, and the incremental ranges equal a full rebuild's."""
    t = small_track
    x, y = _open_cell(t)
    occ = np.asarray(t.occupancy)[: t.height, : t.width]
    kw = dict(max_range=10.0, tile_size=2.0, ns=16,
              real_hw=(t.height, t.width))
    org = (t.origin_x, t.origin_y)
    j0 = jsec.build_sector_map(occ, t.resolution, org, headroom=8, **kw)
    p0 = psec.build_sector_map(occ, t.resolution, org, headroom=8, **kw,
                               device="cpu")
    table0 = p0.table.clone()
    box = P.RacecarSimulator(
        _port_track(t), scan_params=P.ScanParams(num_beams=64),
        backend="sectors", device="cpu")._obstacle_box_segments(
            _port_track(t), x, y, 0.4)
    jsim_box = jsim.RacecarSimulator(
        t, scan_params=jsim.ScanParams(num_beams=64), backend="sectors",
        with_noise=False)._obstacle_box_segments(t, x, y, 0.4)
    np.testing.assert_array_equal(box, jsim_box)
    inc = psec.add_segments(p0, box)
    ref = jsec.add_segments(j0, jsim_box)
    np.testing.assert_array_equal(inc.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(inc.meta.numpy(), np.asarray(ref.meta))
    assert inc.n_segments == ref.n_segments == p0.n_segments + 4
    assert torch.equal(p0.table, table0)           # pristine untouched
    assert inc.table.shape == p0.table.shape
    occ2 = ploader.add_obstacle(_port_track(t), x, y, 0.4)
    full = psec.build_sector_map(
        occ2.occupancy.numpy()[: t.height, : t.width], t.resolution, org,
        **kw, device="cpu")
    rng = np.random.RandomState(5)
    e = np.asarray(t.edf)[: t.height, : t.width]
    ys, xs = np.where(e > 0.8)
    k = rng.randint(len(ys), size=16)
    poses = torch.tensor(np.stack(
        [t.origin_x + (xs[k] + .5) * t.resolution,
         t.origin_y + (ys[k] + .5) * t.resolution,
         rng.uniform(-np.pi, np.pi, 16)], -1), dtype=torch.float32)
    scan = lambda m: scan_poses_sectors(m, poses, num_beams=540, fov=FOV,
                                        max_range=10.0)
    assert torch.equal(scan(inc), scan(full))
    with pytest.raises(ValueError, match="headroom"):
        psec.add_segments(psec.build_sector_map(
            occ, t.resolution, org, **kw,
            device="cpu"), np.repeat(box, 40, axis=0))


@pytest.mark.parametrize("backend", BACKENDS)
def test_facade_obstacle_cycle(small_track, backend):
    """The facade's add/clear cycle on every backend: the edited maps equal
    the JAX facade's, a box in front of the car shortens its beams, and
    clear_obstacles restores the earlier scan bit for bit."""
    t = small_track
    x, y = _open_cell(t)
    scan = dict(num_beams=64)
    sim = P.RacecarSimulator(_port_track(t), scan_params=P.ScanParams(
        **scan), backend=backend, with_noise=False, device="cpu")
    jfac = jsim.RacecarSimulator(t, scan_params=jsim.ScanParams(**scan),
                                 backend=backend, with_noise=False)
    sim.set_pose(x + 1.2, y, np.pi)                # looking at the box
    before = sim.run_scan()
    seg0, track0 = sim.bundle.segmap, sim.bundle.track
    sim.add_obstacle(x, y, size=0.4)
    jfac.add_obstacle(x, y, size=0.4)
    for got, ref in ((sim.bundle.track, jfac.bundle.track),
                     (sim.bundle.segmap, jfac.bundle.segmap)):
        assert (got is None) == (ref is None)
        if got is not None:
            g, r = _map_leaves(got), _map_leaves(ref)
            assert g.keys() == r.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    with_box = sim.run_scan()
    assert float(with_box.min()) < float(before.min()) - 0.1
    assert float(with_box[32]) < 1.0               # the beam straight ahead
    out = sim.update_pose()                        # the step reads it too
    assert float(out.ranges[32]) < 1.0
    sim.set_pose(x + 1.2, y, np.pi)
    sim.clear_obstacles()
    assert sim.bundle.segmap is seg0 and sim.bundle.track is track0
    assert torch.equal(sim.run_scan(), before)


def test_facade_sector_rebuild_when_headroom_runs_out(small_track):
    """Boxes added until the cull lists' headroom overflows: the facade
    falls back to a full rebuild (the capacity split carried over while it
    fits, auto-sized after), and its scans stay those of a fresh build
    from the edited occupancy."""
    t = small_track
    x, y = _open_cell(t)
    sim = P.RacecarSimulator(_port_track(t), scan_params=P.ScanParams(
        num_beams=128), backend="sectors", with_noise=False, device="cpu")
    n0 = sim._pristine_segmap.n_segments
    for k in range(20):
        sim.add_obstacle(x + 0.1 * (k % 5), y + 0.1 * (k // 5), size=0.2)
    edited = sim.bundle.segmap
    assert edited.n_segments != n0 + 4 * 20        # a rebuild happened
    fresh = P.build_sim(sim.bundle.track, scan=P.ScanParams(num_beams=128),
                        backend="sectors", device="cpu").segmap
    poses = torch.tensor([[x - 1.0, y, 0.0], [x + 2.0, y + 0.2, np.pi],
                          [x, y - 1.2, np.pi / 2]])
    scan = lambda m: scan_poses_sectors(m, poses, num_beams=128,
                                        max_range=10.0)
    assert torch.equal(scan(edited), scan(fresh))
    sim.set_pose(x - 1.0 - 0.275, y, 0.0)
    assert torch.equal(sim.run_scan(), scan(fresh)[0])
    sim.clear_obstacles()
    assert sim.bundle.segmap is sim._pristine_segmap
