"""The list kernel's entry from poses (``ops/sweeps.list_scan``), on the CPU.

A scan of poses whose rays take no gradient, on the exact fan, routes its
rows as before and hands the list kernel the agents' origins and headings'
(cos, sin) and the padded fan's per-beam (cos, sin): the kernel builds each
ray, its reciprocals, sweeps the row's list and writes the clamped,
extent-masked range (``csrc/sector_sweep.cu``). Its plain version, which
CPU tensors run, is the composition it replaces, so these tests hold the
new path to the old one bit for bit: the sector scan and the tile scan on a
window of berlin, with an origin outside the map's extent, padding beams,
an odd beam count whose middle offset is exactly 0 (at heading 0 its sine
is 0 and its reciprocal NaN), with and without agent chunks. A scan whose
poses take a gradient, or on the theta table, keeps the old path, values
and gradients; ``SWEEP_COUNTS["fanned"]`` counts the rows built from
poses and no other; the graphed step on the new path captures without
building a tensor from host data. The card's side:
``tests/test_torch_kernels.py -k list_scan``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyracecarsimulator_tpu_torch as P
from pyracecarsimulator_tpu_torch import simulator as psim
from pyracecarsimulator_tpu_torch.maps import load_builtin, sample_free_poses
from pyracecarsimulator_tpu_torch.maps.loader import build_track_map
from pyracecarsimulator_tpu_torch.maps.sectors import build_sector_map
from pyracecarsimulator_tpu_torch.maps.segments import build_segment_map
from pyracecarsimulator_tpu_torch.ops import common, sweeps
from pyracecarsimulator_tpu_torch.ops import raycast_sectors as rs
from pyracecarsimulator_tpu_torch.ops import raycast_segments as rseg

FOV = 4.712388980384690
MAX_RANGE = 4.0
WINDOW = (slice(200, 700), slice(200, 700))     # 25 m of berlin's cells


@pytest.fixture(scope="module")
def berlin_window():
    """A 25 m window of the bundled berlin circuit: its track, its sector
    map (2 m tiles) and its segment map (4 m tiles), and 32 free poses,
    the first moved outside the window's extent, the second turned to
    heading exactly 0."""
    full = load_builtin("berlin", device="cpu")
    occ = np.ascontiguousarray(
        full.occupancy.numpy()[: full.height, : full.width][WINDOW])
    org = (full.origin_x + WINDOW[1].start * full.resolution,
           full.origin_y + WINDOW[0].start * full.resolution)
    track = build_track_map(occ, full.resolution, org, device="cpu")
    kw = dict(max_range=MAX_RANGE, real_hw=occ.shape, device="cpu")
    smap = build_sector_map(occ, full.resolution, org, tile_size=2.0, **kw)
    segmap = build_segment_map(occ, full.resolution, org, tile_size=4.0,
                               **kw)
    assert segmap.tiles is not None
    p = torch.as_tensor(sample_free_poses(track, 32,
                                          np.random.RandomState(4)))
    p[0, 0] = smap.extent[1] + 0.5          # outside: every beam max_range
    p[1, 2] = 0.0                           # heading exactly 0
    return track, smap, segmap, p


def _todays_scan(kind, m, p, beams):
    """The composition the entry replaces, as the scans ran it before:
    the padded exact fan, the routed rows through the rays-given sweep
    (``raycast_grad._list_minima``), the clamp, the slice and the extent
    mask."""
    with torch.no_grad():
        if kind == "sectors":
            bb, p2, ct, st = rs._sector_fan(m, p, beams, FOV, 0, None)
            return rs._scan_chunk(m, p2, ct, st, beams, MAX_RANGE, bb)
        ct, st = common.fan_cos_sin(p[:, 2], common._padded_offsets(
            beams, FOV, 128, "cpu"))
        return rseg._scan_rays(m, p, ct, st, beams, MAX_RANGE)


def _scan(kind, m, p, beams, **kw):
    fn = rs.scan_poses_sectors if kind == "sectors" else \
        rseg.scan_poses_segments
    return fn(m, p, beams, FOV, MAX_RANGE, **kw)


def _map(berlin_window, kind):
    _, smap, segmap, p = berlin_window
    return (smap if kind == "sectors" else segmap), p


@pytest.mark.parametrize("kind, beams, chunk", [
    ("sectors", 1080, None), ("sectors", 1080, 7), ("sectors", 541, None),
    ("sectors", 541, 7), ("tiles", 1080, None), ("tiles", 541, None)])
def test_list_scan_is_todays_composition(berlin_window, kind, beams, chunk):
    """The scan on the entry from poses equals today's composition bit
    for bit (the plain version is that composition), with or without
    agent chunks (the sector scan's); the origin outside the extent reads
    max_range on every beam; an odd fan's middle beam at heading 0 has a
    NaN reciprocal."""
    m, p = _map(berlin_window, kind)
    kw = {"agent_chunk": chunk} if kind == "sectors" else {}
    got = _scan(kind, m, p, beams, **kw)
    ref = _todays_scan(kind, m, p, beams)
    assert got.shape == (p.shape[0], beams)
    assert torch.equal(got, ref)
    assert bool((got[0] == MAX_RANGE).all())
    assert bool((got[1:] < MAX_RANGE).any())
    offs = common.beam_angles(beams, FOV, "cpu")
    if beams % 2:
        mid = beams // 2
        assert float(offs[mid]) == 0.0
        _, st = common.fan_cos_sin(p[1:2, 2], offs)
        assert float(st[0, mid]) == 0.0
        assert bool(common._ray_invs(st, st)[0][0, mid].isnan())


@pytest.mark.parametrize("kind", ["sectors", "tiles"])
def test_list_scan_plain_equals_the_wrapper_on_routed_rows(berlin_window,
                                                           kind):
    """``list_scan`` on CPU tensors is ``list_scan_plain``, which is
    ``rotate_fan``, ``_ray_invs``, ``list_sweep_plain``, ``finish_minima``,
    the slice and ``apply_extent_mask`` on the same rows, and it counts
    every row as fanned."""
    m, p = _map(berlin_window, kind)
    beams = 1080
    bb = rs.sector_block_width(m, beams, FOV) if kind == "sectors" else 128
    cd, sd = common.offset_factors(beams, FOV, bb, "cpu")
    nblk = cd.shape[0] // bb
    cth, sth = torch.cos(p[:, 2]), torch.sin(p[:, 2])
    x0, y0 = p[:, 0].contiguous(), p[:, 1].contiguous()
    if kind == "sectors":
        ids = rs._sector_ids(m.tiles_shape, m.tile_size, m.tile_origin, m.ns,
                             x0, y0, *common.rotate_fan(
                                 cth, sth, *common.mid_offset_factors(
                                     beams, FOV, bb, "cpu")))
        table, meta = m.table, m.meta
    else:
        from pyracecarsimulator_tpu_torch.ops.raycast_grad import tile_rows
        ids = tile_rows(m.tiles_shape, m.tile_size, m.tile_origin, x0, y0,
                        nblk)
        table, meta = m.tiles, m.tile_sweep_meta
    assert ids.shape == (p.shape[0], nblk) and ids.dtype == torch.int32
    args = (table, meta, ids, x0, y0, cth, sth, cd, sd, MAX_RANGE, m.extent,
            beams)
    before = dict(sweeps.SWEEP_COUNTS.host)
    got = sweeps.list_scan(*args)
    grown = {k: sweeps.SWEEP_COUNTS.host[k] - before[k] for k in before}
    assert sweeps.list_scan.launches == 0
    ct, st = common.rotate_fan(cth, sth, cd, sd)
    bv, bh = sweeps.list_sweep_plain(
        table, meta, ids.reshape(-1), x0.repeat_interleave(nblk),
        y0.repeat_interleave(nblk), *(v.reshape(-1, bb) for v in (
            ct, st, *common._ray_invs(ct, st))))
    r = common.finish_minima(bv.reshape(ct.shape), bh.reshape(ct.shape),
                             MAX_RANGE)[0]
    ref = common.apply_extent_mask(r[:, :beams], x0, y0, m.extent,
                                   MAX_RANGE)
    assert torch.equal(got, ref)
    assert grown["fanned"] == grown["rows"] == ids.numel()


def test_mid_offset_factors_are_the_fan_at_the_lookup_beams():
    """The route's block-middle directions rebuilt from the cached
    factors equal the full padded fan's columns at those beams."""
    p = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 2.5], [0.0, 0.0, -3.1]])
    for beams, bb in ((1080, 128), (541, 64), (37, 16)):
        ct, st = common.fan_cos_sin(p[:, 2], common._padded_offsets(
            beams, FOV, bb, "cpu"))
        n_pad = ct.shape[1]
        mids = common.block_mids(n_pad // bb, bb, n_pad, "cpu")
        cm, sm = common.rotate_fan(torch.cos(p[:, 2]), torch.sin(p[:, 2]),
                                   *common.mid_offset_factors(beams, FOV, bb,
                                                              "cpu"))
        assert torch.equal(cm, ct[:, mids]) and torch.equal(sm, st[:, mids])
        cd, sd = common.offset_factors(beams, FOV, bb, "cpu")
        assert cd.data_ptr() == common.offset_factors(beams, FOV, bb,
                                                      "cpu")[0].data_ptr()
        assert cd.shape == (n_pad,) and cd.is_contiguous()
        assert sd.is_contiguous()


@pytest.mark.parametrize("kind", ["sectors", "tiles"])
def test_fanned_counts_the_rows_built_from_poses_only(berlin_window, kind):
    """A scan of poses without a gradient counts every row it sweeps as
    fanned; one whose poses take a gradient, one on the theta table and
    the rays-given sweep itself count none."""
    m, p = _map(berlin_window, kind)
    counts = sweeps.SWEEP_COUNTS

    def grown(fn):
        before = dict(counts)
        fn()
        return {k: counts[k] - before[k] for k in before}

    fused = grown(lambda: _scan(kind, m, p, 1080))
    assert fused["rows"] > 0 and fused["fanned"] == fused["rows"]
    q = p.clone().requires_grad_(True)
    with_grad = grown(lambda: _scan(kind, m, q, 1080).sum().backward())
    assert with_grad["fanned"] == 0
    assert {k: with_grad[k] for k in ("rows", "slots", "kept")} == {
        k: fused[k] for k in ("rows", "slots", "kept")}
    table = grown(lambda: _scan(kind, m, p, 1080, theta_discretization=2000))
    assert table["rows"] > 0 and table["fanned"] == 0
    with torch.no_grad():
        q = p.clone().requires_grad_(True)
        no_grad = grown(lambda: _scan(kind, m, q, 1080))
    assert no_grad == fused


@pytest.mark.parametrize("kind", ["sectors", "tiles"])
def test_poses_that_take_a_gradient_keep_the_old_path(berlin_window, kind,
                                                      monkeypatch):
    """Poses that take a gradient, and the theta table, never reach
    ``list_scan``: the values are the fused scan's, and the pose gradient
    is the analytic VJP's through today's composition, bit for bit."""
    m, p = _map(berlin_window, kind)
    fused = _scan(kind, m, p, 1080)
    module = rs if kind == "sectors" else rseg

    def refused(*a, **kw):
        raise AssertionError("list_scan reached")
    monkeypatch.setattr(module, "list_scan", refused)
    q = p.clone().requires_grad_(True)
    r = _scan(kind, m, q, 1080)
    (r * r).sum().backward()
    assert torch.equal(r.detach(), fused)
    q2 = p.clone().requires_grad_(True)
    if kind == "sectors":
        bb, p2, ct, st = rs._sector_fan(m, q2, 1080, FOV, 0, None)
        r2 = rs._scan_chunk(m, p2, ct, st, 1080, MAX_RANGE, bb)
    else:
        ct, st = common.fan_cos_sin(q2[:, 2], common._padded_offsets(
            1080, FOV, 128, "cpu"))
        r2 = rseg._scan_rays(m, q2, ct, st, 1080, MAX_RANGE)
    (r2 * r2).sum().backward()
    assert torch.equal(q.grad, q2.grad) and bool(q.grad.abs().sum() > 0)
    table = _scan(kind, m, p, 1080, theta_discretization=2000)
    assert table.shape == fused.shape


class _WatchedCapture:
    """A stand-in for ``CudaGraphBackend`` on the CPU that re-runs the
    function where the card would replay, and records what its capture
    pass did: the tensors built from host data (``torch.tensor``,
    ``as_tensor``, ``from_numpy``) and the scan constants made."""

    seen = []

    def check(self, device):
        pass

    def warm_up(self, run, device, n):
        for _ in range(n):
            run()

    def capture(self, run, device, generators):
        built = []
        real = {k: getattr(torch, k) for k in ("tensor", "as_tensor",
                                                "from_numpy")}

        def counted(name):
            def fn(*a, **kw):
                built.append(name)
                return real[name](*a, **kw)
            return fn
        constants = len(common._CONSTANTS)
        try:
            for k in real:
                setattr(torch, k, counted(k))
            outs = run()
        finally:
            for k, v in real.items():
                setattr(torch, k, v)
        _WatchedCapture.seen.append(
            (built, len(common._CONSTANTS) - constants))

        def replay():
            new = run()
            with torch.no_grad():
                for s, n in zip(outs, new):
                    s.copy_(n)
        return outs, replay


@pytest.mark.parametrize("backend", ["segments", "sectors"])
def test_graphed_step_on_the_entry_from_poses_captures(berlin_window,
                                                       backend, monkeypatch):
    """``make_step_fn(..., graph=True)`` on berlin's window, on the entry
    from poses: the capture builds no tensor from host data and makes no
    scan constant, and the replayed steps equal the eager ones."""
    graph_mod = importlib.import_module(
        "pyracecarsimulator_tpu_torch.utils.graph")
    monkeypatch.setattr(graph_mod, "CudaGraphBackend", _WatchedCapture)
    monkeypatch.setattr(psim, "CudaGraphBackend", _WatchedCapture)
    track, _, _, p = berlin_window
    bundle = P.build_sim(track, backend=backend,
                         scan=P.ScanParams(max_range=MAX_RANGE),
                         device="cpu")
    if backend == "segments":
        assert bundle.segmap.tiles is not None
    q = p[2:14]
    state = P.state_from_pose(q[:, 0], q[:, 1], q[:, 2])
    act = (torch.full((12,), 2.0), torch.zeros(12))
    eager = P.make_step_fn(bundle, with_noise=False)
    graphed = P.make_step_fn(bundle, with_noise=False, graph=True)
    _WatchedCapture.seen.clear()
    before = dict(sweeps.SWEEP_COUNTS)
    se = sg = state
    for _ in range(3):
        oe, og = eager(se, act), graphed(sg, act)
        assert torch.equal(oe.ranges, og.ranges)
        se, sg = oe.state, og.state
    assert _WatchedCapture.seen == [([], 0)]
    grown = {k: sweeps.SWEEP_COUNTS[k] - before[k] for k in before}
    assert grown["rows"] > 0 and grown["fanned"] == grown["rows"]


def _fanned_reader():
    """``read`` of the benchmark's ``fanned_row_share`` metric."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "metrics" / "fanned_row_share.py")
    spec = importlib.util.spec_from_file_location("fanned_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counters, want", [
    (None, None),                                   # no counters() at all
    ({"march": {"calls": 0, "trips": 0}}, None),
    ({"sweep": {"rows": 9, "slots": 900, "kept": 70}}, None),  # no fanned
    ({"sweep": {"rows": 0, "slots": 0, "kept": 0, "fanned": 0}}, None),
    ({"sweep": {"rows": 8, "slots": 900, "kept": 70, "fanned": 6}}, 0.75)])
def test_fanned_reader_reads_fanned_over_rows(monkeypatch, counters, want):
    """The benchmark's ``fanned_row_share`` reads the port's fanned rows
    over its rows, and None where the port counts no fanned rows (a
    program before the entry from poses) or swept no row."""
    import sys
    import types
    from pyracecarsimulator_tpu_torch.utils import profiling
    read = _fanned_reader()
    mod = types.ModuleType(profiling.__name__)
    if counters is not None:
        mod.counters = lambda: counters
    monkeypatch.setitem(sys.modules, profiling.__name__, mod)
    assert read({"trace": None, "spans": {}}) == want


def test_fanned_reader_on_the_port(berlin_window):
    """On the port itself, after scans on both routes on the CPU: the
    fanned rows over the rows, 1 after scans of poses alone."""
    from pyracecarsimulator_tpu_torch.utils import profiling  # noqa: F401
    _, smap, segmap, p = berlin_window
    _scan("sectors", smap, p, 1080)
    _scan("tiles", segmap, p, 1080)
    counts = dict(sweeps.SWEEP_COUNTS)
    assert 0 < counts["fanned"] <= counts["rows"]
    assert _fanned_reader()({"trace": None, "spans": {}}) == \
        counts["fanned"] / counts["rows"]
