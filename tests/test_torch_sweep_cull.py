"""The list kernel's wedge cull, on the CPU.

``list_sweep_kernel`` (``csrc/sector_sweep.cu``) drops, row by row, the
slots of a list that lie wholly outside the row's own wedge of rays and
sweeps the rest; ``ops/sweeps.wedge_edges`` and ``outside_wedge`` are the
same cull in the same float32 operations, which ``list_sweep_plain``
counts (``SWEEP_COUNTS["kept"]``) while it still sweeps every real slot.
Here the cull is held to what makes it safe: on berlin's tables and on
built rows, no slot it drops is hit by any ray of its row under the
kernel's float32 test, so the kept slots alone give the minima of the
whole list bit for bit. The card's side (the kernel's kept count, its
minima): ``tests/test_torch_kernels.py``.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch.maps import sample_free_poses
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
from pyracecarsimulator_tpu_torch.ops import sweeps
from pyracecarsimulator_tpu_torch.ops.common import (_padded_offsets,
                                                     fan_cos_sin, tile_ids)
from torch_cull_cases import (BUILT_CASES, built_case, cull_masks,
                              fan_args, only_slots, row_args, rows_of)

FOV = 4.712388980384690
BEAMS = 1080
BIG = 3.0e38


def _check_cull(args):
    """The cull drops nothing hit: the dropped slots alone give no hit and
    the kept ones alone the minima of the whole list, bit for bit; the
    plain version counts exactly the kept slots. Returns (real, kept)
    slots a row, (G,) each."""
    real, keep = cull_masks(args)
    before = dict(sweeps.SWEEP_COUNTS.host)
    bv, bh = sweeps.list_sweep_plain(*args)
    grown = {c: sweeps.SWEEP_COUNTS.host[c] - before[c] for c in before}
    assert grown == {"rows": args[2].numel(), "slots": int(real.sum()),
                     "kept": int(keep.sum()), "fanned": 0}
    kv, kh = sweeps.list_sweep_plain(*only_slots(args, keep))
    assert torch.equal(kv, bv) and torch.equal(kh, bh)
    dropped = real & ~keep
    if dropped.any():
        dv, dh = sweeps.list_sweep_plain(*only_slots(args, dropped))
        assert bool((dv == BIG).all()) and bool((dh == BIG).all())
    n_real, n_kept = real.sum(1), keep.sum(1)
    assert bool((n_kept <= n_real).all())
    return n_real, n_kept


@pytest.fixture(scope="module")
def berlin():
    bundles = {b: P.build_sim("berlin", backend=b, device="cpu")
               for b in ("sectors", "segments")}
    poses = torch.as_tensor(sample_free_poses(
        bundles["sectors"].track, 512, np.random.RandomState(0)))
    return bundles, poses


@pytest.mark.parametrize("table, kept_band", [("sectors", (50, 85)),
                                              ("tiles", (60, 100))])
def test_cull_on_berlin_drops_no_slot_a_ray_hits(berlin, table, kept_band):
    """On berlin's sector and 4 m tile tables, 512 seeded free poses, every
    row of the padded fans the two routes build: no dropped slot is hit by
    a ray of its row, the minima are unchanged, and a row keeps about a
    tenth (tiles) to a third (sectors) of its list."""
    bundles, p = berlin
    if table == "sectors":
        smap = bundles["sectors"].segmap
        bb = rs.sector_block_width(smap, BEAMS, FOV)
        ct, st = fan_cos_sin(p[:, 2], _padded_offsets(BEAMS, FOV, bb, "cpu"))
        ids = rs._list_ids(smap.tiles_shape, smap.tile_size,
                           smap.tile_origin, smap.ns, p[:, 0], p[:, 1], ct,
                           st, bb)
        args = fan_args(smap.table, smap.meta, ids, p, bb)
    else:
        segmap = bundles["segments"].segmap
        nblk = -(-BEAMS // 128)
        tid = tile_ids(segmap.tiles_shape, segmap.tile_size,
                       segmap.tile_origin, p[:, 0], p[:, 1])
        args = fan_args(segmap.tiles, segmap.tile_sweep_meta,
                         tid[:, None].expand(-1, nblk), p, 128)
    n_real, n_kept = _check_cull(args)
    lo, hi = kept_band
    assert lo <= float(n_kept.double().mean()) <= hi
    assert float(n_kept.sum()) < 0.4 * float(n_real.sum())


@pytest.mark.parametrize("name", BUILT_CASES)
def test_cull_on_built_rows(name):
    """Built rows over a list of random segments all around the origin:
    the cull drops nothing a ray hits, and keeps every slot of a row it
    cannot bound (120 degrees or more, a non-finite or non-unit
    direction) or whose list is short."""
    table, meta, (x0, y0, ct, st), culls = built_case(name)
    args = row_args(torch.tensor(table), torch.tensor(meta),
                     torch.zeros(1, dtype=torch.int32), x0, y0, ct, st)
    n = torch.tensor([int(meta[0, 2])])
    assert bool(sweeps.wedge_edges(ct, st, n)[0][0]) == culls
    n_real, n_kept = _check_cull(args)
    if culls:
        assert 0 < int(n_kept[0]) < int(n_real[0])
    else:
        assert int(n_kept[0]) == int(n_real[0])
    if name == "endpoint_on_edge_ray":
        # both added slots are kept, and the low edge ray hits the first
        _, keep = cull_masks(args)
        n_v = int(meta[0, 0])
        assert bool(keep[0, n_v - 1]) and bool(keep[0, -1])
        alone = torch.zeros_like(keep)
        alone[0, n_v - 1] = True
        bv = sweeps.list_sweep_plain(*only_slots(args, alone))[0]
        assert float(bv[0, 0]) == 3.0
    if name == "segment_through_origin":
        _, keep = cull_masks(args)
        assert bool(keep[0, int(meta[0, 0]) - 1]) and bool(keep[0, -1])


def test_edge_rays_are_the_least_and_greatest_sine_with_ties_outward():
    """The edge rays are the rays of least and greatest signed sine
    against the middle ray; among equal rays the lowest beam is the low
    edge and the highest the high edge."""
    x0, y0, ct, st = rows_of([0.3, 0.1, 0.1, 0.2, 0.5, 0.5, 0.4])
    cull, lx, ly, hx, hy = sweeps.wedge_edges(ct, st, torch.tensor([64]))
    assert bool(cull[0])
    assert (float(lx[0]), float(ly[0])) == (float(ct[0, 1]), float(st[0, 1]))
    assert (float(hx[0]), float(hy[0])) == (float(ct[0, 5]), float(st[0, 5]))
    key = sweeps._order_key(torch.tensor([-1.0, -0.0, 0.0, 1e-30, 2.0]))
    assert bool((key[1:] > key[:-1]).all())


def test_the_cull_constants_are_the_kernels():
    """The plain version culls with the kernel's constants."""
    src = (pathlib.Path(sweeps.__file__).parent.parent / "csrc"
           / "sector_sweep.cu").read_text()

    def const(name):
        return float(re.search(rf"{name} = ([0-9.e+-]+)f?;", src).group(1))

    assert const("kCullMinSlots") == sweeps.CULL_MIN_SLOTS
    assert np.float32(const("kCullAbs")) == np.float32(sweeps.CULL_ABS)
    assert const("kCullRel") == sweeps.CULL_REL
    assert const("kUnitTol") == sweeps.UNIT_TOL
    assert const("kMinDot") == sweeps.MIN_DOT
