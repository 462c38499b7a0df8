"""The sweeps' work counts and the scan's spans, on the CPU.

``ops/sweeps.SWEEP_COUNTS`` (read through ``profiling.counters()["sweep"]``)
counts the rows a list sweep runs, the real slots of their lists,
n_v + h_end - h_lo a row, and the slots the kernel's wedge cull keeps of
them; the plain version counts on the host, the kernel on the device
(``tests/test_torch_kernels.py`` holds the two equal on the card).
``scan.route`` spans the routing of rows to cull lists inside
``step.scan``. ``ops/sweeps.DENSE_COUNTS`` (``counters()["dense"]``)
counts the dense sweep's rays and the pairs they test, v_hi + h_end - h_lo
a ray, and ``scan.fan`` spans the fan, reciprocals and flat rays that the
dense route builds outside its kernel. The card's side of the counts:
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch.maps import sample_free_poses
from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
from pyracecarsimulator_tpu_torch.maps.sectors import build_sector_map
from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
from pyracecarsimulator_tpu_torch.ops import _kernels
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg
from pyracecarsimulator_tpu_torch.ops import sweeps
from pyracecarsimulator_tpu_torch.ops.common import tile_ids
from pyracecarsimulator_tpu_torch.utils import profiling
from torch_cull_cases import cull_masks, fan_args

FOV = 4.712388980384690
BEAMS = 300
MAX_RANGE = 2.0
RES, ORIGIN = 0.05, (-5.5, -5.5)


def _occupancy():
    """tests/test_torch_sectors.py's blobby geometry: 168 wall segments,
    enough that 1 m tiles at a 2 m range cull (the segment build keeps
    tiles only where their lists are narrower than the whole set)."""
    rng = np.random.RandomState(7)
    occ = np.zeros((220, 220), np.float32)
    occ[:3, :] = 1; occ[-3:, :] = 1; occ[:, :3] = 1; occ[:, -3:] = 1
    for _ in range(40):
        r, c = rng.randint(10, 208, 2)
        h, w = rng.randint(2, 9, 2)
        occ[r:r + h, c:c + w] = 1
    return occ


@pytest.fixture(scope="module")
def track():
    return build_track_map(_occupancy(), RES, ORIGIN, device="cpu")


@pytest.fixture(scope="module")
def maps(track):
    occ = _occupancy()
    kw = dict(max_range=MAX_RANGE, tile_size=1.0, real_hw=occ.shape,
              device="cpu")
    smap = build_sector_map(occ, RES, ORIGIN, **kw)
    segmap = build_segment_map(occ, RES, ORIGIN, **kw)
    assert segmap.tiles is not None
    return smap, segmap


def _poses(track, n, seed):
    return torch.as_tensor(sample_free_poses(track, n,
                                             np.random.RandomState(seed)))


def _real_slots(meta, ids):
    """The sum over rows of n_v + h_end - h_lo, from ``meta[ids]``."""
    m = meta.numpy().astype(np.int64)[ids.reshape(-1).numpy()]
    return int((m[:, 0] + m[:, 2] - m[:, 1]).sum())


def _sector_rows(smap, p):
    bb = rs.sector_block_width(smap, BEAMS, FOV)
    ct, st = rs.fan_cos_sin(p[:, 2], rs._padded_offsets(BEAMS, FOV, bb,
                                                        "cpu"))
    ids = rs._list_ids(smap.tiles_shape, smap.tile_size, smap.tile_origin,
                       smap.ns, p[:, 0], p[:, 1], ct, st, bb)
    return fan_args(smap.table, smap.meta, ids, p, bb, BEAMS, FOV)


def _tile_rows(segmap, p):
    nblk = -(-BEAMS // 128)
    tid = tile_ids(segmap.tiles_shape, segmap.tile_size, segmap.tile_origin,
                   p[:, 0], p[:, 1])
    return fan_args(segmap.tiles, segmap.tile_sweep_meta,
                    tid[:, None].expand(-1, nblk), p, 128, BEAMS, FOV)


@pytest.mark.parametrize("kind", ["sectors", "tiles"])
def test_sweep_counts_rows_and_real_slots_of_a_scan(track, maps, kind):
    """After a sector scan and after a tile scan, ``counters()["sweep"]``
    has grown by the scan's rows, by the sum of their real slots and by
    the slots the wedge cull keeps of them, counted apart from the sweep
    from ``meta[ids]`` and the rows' rays; a scan differentiated in the
    poses counts its one forward sweep. A scan whose poses take no
    gradient builds its rows from the poses (``list_scan``: every row
    ``fanned``), one differentiated in the poses from its rays (none)."""
    smap, segmap = maps
    p = _poses(track, 24, 3)
    if kind == "sectors":
        scan = lambda q: rs.scan_poses_sectors(smap, q, BEAMS, FOV,
                                               MAX_RANGE)
        args, k = _sector_rows(smap, p), smap.table.shape[2]
    else:
        scan = lambda q: rseg.scan_poses_segments(segmap, q, BEAMS, FOV,
                                                  MAX_RANGE)
        args, k = _tile_rows(segmap, p), segmap.tiles.shape[2]
    ids = args[2]
    real, kept = cull_masks(args)
    want = {"rows": ids.numel(), "slots": _real_slots(args[1], ids),
            "kept": int(kept.sum())}
    assert 0 < want["slots"] < ids.numel() * k
    assert want["slots"] == int(real.sum()) and want["kept"] <= want["slots"]
    for grad in (False, True):
        q = p.clone().requires_grad_(grad)
        before = profiling.counters()["sweep"]
        r = scan(q)
        if grad:
            r.sum().backward()
            assert q.grad is not None
        after = profiling.counters()["sweep"]
        assert {k: after[k] - before[k] for k in after} == {
            **want, "fanned": 0 if grad else want["rows"]}


def test_sweep_counts_add_the_device_counters_lanes():
    """``SWEEP_COUNTS`` is the plain version's host counts plus every
    device's (lanes, 4) counter of [slots, rows, kept, fanned], summed over
    its lanes at each lookup; a CPU tensor stands in for a device's
    counter here."""
    counts = _kernels.DeviceCounts(("slots", "rows", "kept", "fanned"),
                                   sweeps.COUNT_LANES)
    counts.host.update(rows=5, slots=900, kept=70, fanned=2)
    c = counts.counter(torch.device("cpu"))
    assert c.dtype == torch.int64
    assert tuple(c.shape) == (sweeps.COUNT_LANES, 4) and not c.any()
    c[0] = torch.tensor([100, 1, 9, 1])
    c[-1] = torch.tensor([2 ** 40, 3, 2 ** 33, 0])
    assert dict(counts) == {"slots": 1000 + 2 ** 40, "rows": 9,
                            "kept": 79 + 2 ** 33, "fanned": 3}
    assert counts.counter(torch.device("cpu")) is c
    assert set(sweeps.SWEEP_COUNTS) == {"slots", "rows", "kept", "fanned"}
    assert profiling.counters()["sweep"] == dict(sweeps.SWEEP_COUNTS)


def _reader(metric):
    """``read`` of the benchmark's reader of ``metric``."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "metrics" / f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"{metric}_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _swept_slots_reader():
    """``read`` of the benchmark's ``swept_slots_per_ray`` metric."""
    return _reader("swept_slots_per_ray")


@pytest.mark.parametrize("counters, want", [
    (None, None),                                   # no counters() at all
    ({"march": {"calls": 0, "trips": 0}}, None),
    ({"sweep": {"rows": 9, "slots": 900}}, None),   # a port without kept
    ({"sweep": {"rows": 0, "slots": 0, "kept": 0}}, None),
    ({"sweep": {"rows": 8, "slots": 900, "kept": 570}}, 71.25)])
def test_swept_slots_reader_reads_kept_over_rows(monkeypatch, counters,
                                                 want):
    """The benchmark's ``swept_slots_per_ray`` reads the port's kept slots
    over its rows, and None where the port counts no kept slots (a program
    before the cull) or swept no row."""
    import sys
    import types
    read = _swept_slots_reader()
    mod = types.ModuleType(profiling.__name__)
    if counters is not None:
        mod.counters = lambda: counters
    monkeypatch.setitem(sys.modules, profiling.__name__, mod)
    assert read({"trace": None, "spans": {}}) == want


def test_swept_slots_reader_on_the_port(track, maps):
    """On the port itself after a sector scan on the CPU: the plain
    version's kept slots over its rows."""
    smap, _ = maps
    rs.scan_poses_sectors(smap, _poses(track, 4, 1), BEAMS, FOV, MAX_RANGE)
    counts = dict(sweeps.SWEEP_COUNTS)
    assert counts["rows"] > 0 and 0 < counts["kept"] <= counts["slots"]
    assert _swept_slots_reader()({"trace": None, "spans": {}}) == \
        counts["kept"] / counts["rows"]


def _step_case(track, backend):
    bundle = P.build_sim(track, scan=P.ScanParams(num_beams=BEAMS,
                                                  max_range=MAX_RANGE),
                         backend=backend, tile_size=1.0, device="cpu")
    p = _poses(track, 8, 5)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((8,), 2.0), torch.zeros(8))
    return P.make_step_fn(bundle, with_noise=False), state, act


@pytest.fixture
def tracing():
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()


def test_scan_route_is_a_span_of_the_port():
    assert "scan.route" in profiling.SPANS
    assert profiling.span("scan.route") is profiling.span("scan.route")


@pytest.mark.parametrize("backend", ["sectors", "segments"])
def test_a_step_records_scan_route_inside_step_scan(track, tracing,
                                                    backend):
    """With tracing on, a sector step and a tile-routed step record
    ``scan.route`` once, inside ``step.scan``, and it holds the routing's
    operations (the sector scan's ``atan2``); with tracing off the step
    runs the same aten operations in the same order."""
    from torch.profiler import ProfilerActivity, profile
    step, state, act = _step_case(track, backend)
    if backend == "segments":
        assert step.map_cell["map"].tiles is not None
    seqs = {}
    for on in (True, False):
        profiling.enable() if on else profiling.disable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, act)
        ev = sorted(prof.events(), key=lambda e: e.time_range.start)
        seqs[on] = [e.name for e in ev if e.name.startswith("aten::")]
        spans = [e for e in ev if e.name in profiling.SPANS]
        if not on:
            assert not spans
            continue
        route = [e for e in spans if e.name == "scan.route"]
        scans = [e for e in spans if e.name == "step.scan"]
        assert len(route) == 1 and len(scans) == 1
        r, s = route[0].time_range, scans[0].time_range
        assert s.start <= r.start and r.end <= s.end
        inside = {e.name for e in ev if r.start <= e.time_range.start
                  and e.time_range.end <= r.end}
        assert ("aten::atan2" in inside) == (backend == "sectors")
        assert "aten::repeat_interleave" in inside or backend == "sectors"
    assert seqs[True] == seqs[False]


@pytest.mark.parametrize("meta, k, pairs", [
    ((41, 41, 82), 128, 82),            # mixed layout, levine's counts
    ((84, 128, 212), 256, 168),         # split layout
    ((300, -4, 90), 128, 218),          # bounds clamped as the kernel's
    ((0, 0, 0), 64, 0)])                # nothing to test
def test_dense_sweep_plain_counts_rays_and_pairs(meta, k, pairs):
    """``dense_sweep_plain`` adds its rays, and v_hi + h_end - h_lo pairs
    a ray with the bounds clamped to the table as the kernel clamps them,
    to ``counters()["dense"]``."""
    n = 37
    params = torch.zeros(4, k)
    rays = [torch.rand(n) for _ in range(6)]
    before = profiling.counters()["dense"]
    sweeps.dense_sweep_plain(params, torch.tensor(meta, dtype=torch.int32),
                             *rays)
    after = profiling.counters()["dense"]
    assert {c: after[c] - before[c] for c in after} == {
        "rays": n, "pairs": n * pairs}


def test_a_dense_scan_counts_every_ray_against_every_segment(track):
    """A scan of poses over an untiled map takes the dense route: its rays
    are the poses' beams, each tested against every real segment; a scan
    differentiated in the poses counts its one forward sweep."""
    occ = _occupancy()
    flat = build_segment_map(occ, RES, ORIGIN, max_range=MAX_RANGE,
                             tile_size=0.0, real_hw=occ.shape, device="cpu")
    assert flat.tiles is None
    v_hi, h_lo, h_end = flat.sweep_meta.tolist()
    assert v_hi + h_end - h_lo == flat.n_segments
    p = _poses(track, 6, 2)
    for grad in (False, True):
        q = p.clone().requires_grad_(grad)
        before = profiling.counters()["dense"]
        r = rseg.scan_poses_segments(flat, q, BEAMS, FOV, MAX_RANGE)
        if grad:
            r.sum().backward()
            assert q.grad is not None
        after = profiling.counters()["dense"]
        assert {c: after[c] - before[c] for c in after} == {
            "rays": 6 * BEAMS, "pairs": 6 * BEAMS * flat.n_segments}


def test_dense_counts_add_the_device_counters_lanes():
    """``DENSE_COUNTS`` is the plain version's host counts plus every
    device's (lanes, 2) counter of [rays, pairs], summed over its lanes at
    each lookup; a CPU tensor stands in for a device's counter here."""
    counts = _kernels.DeviceCounts(("rays", "pairs"), sweeps.COUNT_LANES)
    counts.host.update(rays=3, pairs=246)
    c = counts.counter(torch.device("cpu"))
    assert tuple(c.shape) == (sweeps.COUNT_LANES, 2) and not c.any()
    c[0] = torch.tensor([256, 256 * 82])
    c[-1] = torch.tensor([2 ** 36, 82 * 2 ** 36])
    assert dict(counts) == {"rays": 259 + 2 ** 36,
                            "pairs": 82 * (259 + 2 ** 36)}
    assert set(sweeps.DENSE_COUNTS) == {"rays", "pairs"}
    assert sweeps.DENSE_COUNTS.lanes == sweeps.COUNT_LANES
    got = profiling.counters()
    assert got["dense"] == dict(sweeps.DENSE_COUNTS)
    assert got["sweep"] == dict(sweeps.SWEEP_COUNTS)


def test_a_dense_step_records_scan_fan_inside_step_scan(track):
    """With tracing on (set up here, and put back as it was), a step on an
    untiled map records ``scan.fan`` inside ``step.scan``, twice: the fan,
    then the reciprocals and flat rays of the dense sweep, which lie
    outside both; no ``scan.route``. With tracing off the step runs the
    same aten operations in the same order and records no span."""
    from torch.profiler import ProfilerActivity, profile
    assert "scan.fan" in profiling.SPANS
    bundle = P.build_sim(track, scan=P.ScanParams(num_beams=BEAMS,
                                                  max_range=MAX_RANGE),
                         backend="segments", tile_size=0.0, device="cpu")
    assert bundle.segmap.tiles is None
    p = _poses(track, 8, 5)
    state = P.state_from_pose(p[:, 0], p[:, 1], p[:, 2])
    act = (torch.full((8,), 2.0), torch.zeros(8))
    step = P.make_step_fn(bundle, with_noise=False)
    was_on = profiling.enabled()
    seqs = {}
    try:
        profiling.disable()
        step(state, act)        # the scan's cached constants, made once
        for on in (True, False):
            profiling.enable() if on else profiling.disable()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(state, act)
            ev = sorted(prof.events(), key=lambda e: e.time_range.start)
            seqs[on] = [e.name for e in ev if e.name.startswith("aten::")]
            spans = [e for e in ev if e.name in profiling.SPANS]
            if not on:
                assert not spans
                continue
            fans = [e.time_range for e in spans if e.name == "scan.fan"]
            scans = [e.time_range for e in spans if e.name == "step.scan"]
            assert len(fans) == 2 and len(scans) == 1
            assert not [e for e in spans if e.name == "scan.route"]
            s = scans[0]
            assert all(s.start <= f.start and f.end <= s.end for f in fans)
            assert fans[0].end <= fans[1].start
            inside = [{e.name for e in ev if f.start <= e.time_range.start
                       and e.time_range.end <= f.end} for f in fans]
            assert "aten::cos" in inside[0] and "aten::sin" in inside[0]
            assert "aten::reciprocal" in inside[1] or \
                "aten::div" in inside[1]
    finally:
        profiling.enable() if was_on else profiling.disable()
    assert seqs[True] == seqs[False]


@pytest.mark.parametrize("counters, want", [
    (None, None),                                   # no counters() at all
    ({"sweep": {"rows": 9, "slots": 900}}, None),   # a port before it
    ({"dense": {"rays": 0, "pairs": 0}}, None),
    ({"dense": {"rays": 4423680, "pairs": 4423680 * 82}}, 82.0),
    ({"dense": {"rays": 8, "pairs": 657}}, 82.125)])
def test_dense_pairs_reader_reads_pairs_over_rays(monkeypatch, counters,
                                                  want):
    """The benchmark's ``dense_pairs_per_ray`` reads the port's dense
    pairs over its rays, and None where the port has no dense counter (a
    program before it), no port is loaded, or no ray was swept."""
    import sys
    import types
    read = _reader("dense_pairs_per_ray")
    mod = types.ModuleType(profiling.__name__)
    if counters is not None:
        mod.counters = lambda: counters
    monkeypatch.setitem(sys.modules, profiling.__name__, mod)
    assert read({"trace": None, "spans": {}}) == want
    monkeypatch.delitem(sys.modules, profiling.__name__)
    assert read({"trace": None, "spans": {}}) is None


def test_dense_pairs_reader_on_the_port(track):
    """On the port itself after a dense scan on the CPU: the counter's
    pairs over its rays, as ``DENSE_COUNTS`` holds them."""
    occ = _occupancy()
    flat = build_segment_map(occ, RES, ORIGIN, max_range=MAX_RANGE,
                             tile_size=0.0, real_hw=occ.shape, device="cpu")
    rseg.scan_poses_segments(flat, _poses(track, 3, 4), BEAMS, FOV,
                             MAX_RANGE)
    counts = dict(sweeps.DENSE_COUNTS)
    assert counts["rays"] > 0
    got = _reader("dense_pairs_per_ray")({"trace": None, "spans": {}})
    assert got == counts["pairs"] / counts["rays"]
