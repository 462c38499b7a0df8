"""The ``berlin-segments_simplified`` configuration and its reference scan.

``reference/scans/simplified.py`` rebuilds the simplified walls from the
rules that the port's ``maps/contours.py`` states, without its code: here
its segments are held to the port's ``extract_general_segments`` exactly
(float64, as sets) on the tiny track, levine and berlin, and its hit to
the port's float64 oracle ``raycast_general_numpy``. The configuration
loads through the registry with nothing cut and compiles berlin into 4 m
tiles of general segments. The cell's run against the reference on the
CPU is in ``tests/test_torch_berlin_simplified.py``, the reader of
``general_pairs_per_ray`` in ``tests/test_torch_sweep_counts.py``."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import tiny  # noqa: E402
from benchmark.core import spec  # noqa: E402
from benchmark.reference.maps import GridMap, load_map  # noqa: E402
from benchmark.reference.scans import simplified  # noqa: E402

CONFIG = "berlin-segments_simplified"
CELL = "berlin-segments_simplified.bptt"
SEGMENTS = {"tiny": 20, "levine": 82, "berlin": 533}


def _grid(name):
    if name == "tiny":
        img = tiny.track_image()
        return GridMap(occupied=img[::-1] < 128, resolution=0.05,
                       origin=(-2.0, -3.0), name="tiny")
    return load_map(os.path.join(spec.BENCH_DIR, "maps", f"{name}.yaml"))


def _port_segments(grid):
    from pyracecarsimulator_tpu_torch.maps import contours
    return contours.extract_general_segments(
        grid.occupied.astype(np.float32), grid.resolution, grid.origin,
        simplified.TOL_CELLS)


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_the_reference_segments_are_the_ports(name):
    grid = _grid(name)
    ref = simplified.segments(grid.occupied, grid.resolution, grid.origin)
    port = _port_segments(grid)
    assert len(ref) == len(port) == SEGMENTS[name]
    assert set(map(tuple, ref)) == set(map(tuple, port[:, :5]))


@pytest.mark.parametrize("name", ["tiny", "berlin"])
def test_the_reference_hit_is_the_ports_oracle(name):
    """Seeded rays from anywhere in the map: the reference's range within
    1e-9 m of ``raycast_general_numpy``'s on the same segments, a hit
    wherever that is under ``max_range``, and a unit normal there."""
    from pyracecarsimulator_tpu_torch.ops.raycast_general import (
        raycast_general_numpy)
    grid = _grid(name)

    class World:
        pass
    world = World()
    world.grid, world.device = grid, torch.device("cpu")
    simplified.prepare(world)
    rng = np.random.default_rng(23)
    n, max_range = 4096, 10.0
    h, w = grid.shape
    x = grid.origin[0] + rng.uniform(0, w * grid.resolution, n)
    y = grid.origin[1] + rng.uniform(0, h * grid.resolution, n)
    th = rng.uniform(-np.pi, np.pi, n)
    rays = [torch.as_tensor(v) for v in (x, y, np.cos(th), np.sin(th))]
    r, hit, nx, ny = simplified.hit(world, *rays, max_range)
    segs = _port_segments(grid)
    want = raycast_general_numpy(segs, x, y, np.cos(th), np.sin(th),
                                 max_range)
    assert np.abs(r.numpy() - want).max() <= 1e-9
    assert torch.equal(hit, torch.as_tensor(want < max_range))
    assert 0.2 < float(hit.double().mean()) < 1.0
    norm = torch.hypot(nx, ny)
    assert torch.allclose(norm[hit], torch.ones(()).double())
    assert not norm[~hit].any()


def test_the_configuration_is_the_simplified_backend_in_4m_tiles():
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == []
    cfg = spec.config(CONFIG)
    assert (cfg["backend"], cfg["reference_scan"]) == (
        "segments_simplified", "simplified")
    assert cfg["agents"] == 4096 and cfg["scan"]["num_beams"] == 1080
    assert spec.cell(bench, CELL)["config"] == CONFIG
    from benchmark.core.sides import Program
    from pyracecarsimulator_tpu_torch.maps.contours import GeneralSegmentMap
    grid = load_map(os.path.join(spec.BENCH_DIR, cfg["map"]))
    side = Program(grid, cfg, "smooth", "cpu")
    gmap = side.bundle.segmap
    assert side.bundle.backend == "segments_simplified"
    assert isinstance(gmap, GeneralSegmentMap)
    assert gmap.n_segments == 533 and gmap.tol_cells == 1.0
    # the grid the port compiles is padded with free cells to 1280 x 1280
    assert gmap.tile_size == 4.0 and gmap.tiles_shape == (16, 16)
    assert tuple(gmap.tiles.shape) == (256, 6, 256)
    assert int((gmap.tiles[:, 4] >= 0).sum(dim=1).max()) == 146
